"""utils/ parity: lie, camera, robust, linalg of the PyTorch port against
the JAX package on the same numpy inputs (float32 on the CPU), the
helpers no path calls included (se3_log / apply / compose, distort,
backproject).

Tolerances: 1e-5 absolute on unit-scale outputs (rotations, tangent
vectors, null vectors; points up to ~6 units after se3_apply), 1e-6 on
distorted normalized coordinates, 1e-4 on backprojected points (depths up
to 9 times pixel errors of 1e-5) and 1e-3 px on pixel coordinates: both sides run
the same float32 formulas, so only transcendental-function ulps and
summation order differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.config import CameraConfig as JCam
from structure_slam_pointline_tpu.utils import camera as jcam
from structure_slam_pointline_tpu.utils import lie as jlie
from structure_slam_pointline_tpu.utils import linalg as jlin
from structure_slam_pointline_tpu.utils import robust as jrob
from structure_slam_pointline_tpu_torch.config import CameraConfig as TCam
from structure_slam_pointline_tpu_torch.utils import camera as tcam
from structure_slam_pointline_tpu_torch.utils import lie as tlie
from structure_slam_pointline_tpu_torch.utils import linalg as tlin
from structure_slam_pointline_tpu_torch.utils import robust as trob

G = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tangents(n=64):
    xi = G.normal(0, 0.8, (n, 6)).astype(np.float32)
    xi[:8, :3] *= 1e-4          # small-angle branch
    return xi


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp"])
def test_exp_maps(fn):
    xi = _tangents()
    arg = xi if fn == "se3_exp" else xi[:, :3]
    a = np.asarray(getattr(jlie, fn)(jnp.asarray(arg)))
    b = getattr(tlie, fn)(_t(arg)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("fn", ["so3_log", "se3_inverse", "se3_normalize"])
def test_log_inverse_normalize(fn):
    """Also se3_log with so3_log, se3_apply and se3_compose with
    se3_inverse (helpers no path calls, ported for parity)."""
    T = np.asarray(jlie.se3_exp(jnp.asarray(_tangents())))
    if fn == "so3_log":
        np.testing.assert_allclose(tlie.se3_log(_t(T)).numpy(),
                                   np.asarray(jlie.se3_log(jnp.asarray(T))), atol=1e-5)
        T = T[:, :3, :3]
    if fn == "se3_inverse":
        p = G.normal(0, 2, (T.shape[0], 3)).astype(np.float32)
        np.testing.assert_allclose(tlie.se3_apply(_t(T), _t(p)).numpy(),
                                   np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(p))),
                                   atol=1e-5)
        np.testing.assert_allclose(tlie.se3_compose(_t(T), _t(T[::-1])).numpy(),
                                   np.asarray(jlie.se3_compose(jnp.asarray(T),
                                                               jnp.asarray(T[::-1]))),
                                   atol=1e-5)
    a = np.asarray(getattr(jlie, fn)(jnp.asarray(T)))
    b = getattr(tlie, fn)(_t(T)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_camera_project_undistort_in_image():
    kw = dict(fy=480.0, k1=-0.1, k2=0.02, p1=1e-3, p2=-1e-3)
    ji, ti = jcam.Intrinsics.from_config(JCam(**kw)), tcam.Intrinsics.from_config(TCam(**kw))
    p = np.stack([G.uniform(-3, 3, 200), G.uniform(-2, 2, 200), G.uniform(0.5, 9, 200)], 1)
    uv_a, z_a = jcam.project(ji, jnp.asarray(p, jnp.float32))
    uv_b, z_b = tcam.project(ti, _t(p))
    np.testing.assert_allclose(uv_b.numpy(), np.asarray(uv_a), atol=1e-3)
    np.testing.assert_allclose(z_b.numpy(), np.asarray(z_a), atol=1e-6)
    a = jcam.undistort_pixels(ji, uv_a)
    b = tcam.undistort_pixels(ti, uv_b)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    np.testing.assert_array_equal(
        tcam.in_image(TCam(**kw), b, 4.0).numpy(),
        np.asarray(jcam.in_image(JCam(**kw), jnp.asarray(b.numpy()), 4.0)))
    np.testing.assert_allclose(ti.K().numpy(), np.asarray(ji.K), atol=0)
    xn = np.stack([G.uniform(-0.6, 0.6, 200), G.uniform(-0.5, 0.5, 200)], 1).astype(np.float32)
    np.testing.assert_allclose(tcam.distort(ti, _t(xn)).numpy(),
                               np.asarray(jcam.distort(ji, jnp.asarray(xn))), atol=1e-6)
    np.testing.assert_allclose(tcam.backproject(ti, uv_b, z_b).numpy(),
                               np.asarray(jcam.backproject(ji, uv_a, z_a)), atol=1e-4)


def test_robust():
    chi2 = G.uniform(0, 40, 300).astype(np.float32)
    for d in (2.4477, 2.7955):
        np.testing.assert_allclose(trob.huber_weight(_t(chi2), d).numpy(),
                                   np.asarray(jrob.huber_weight(jnp.asarray(chi2), d)),
                                   atol=1e-6)
        np.testing.assert_allclose(trob.huber_cost(_t(chi2), d).numpy(),
                                   np.asarray(jrob.huber_cost(jnp.asarray(chi2), d)),
                                   atol=1e-4)
    mask = G.uniform(size=300) < 0.6
    np.testing.assert_allclose(float(trob.mad_sigma(_t(chi2), torch.from_numpy(mask))),
                               float(jrob.mad_sigma(jnp.asarray(chi2), jnp.asarray(mask))),
                               rtol=1e-5)


def test_jacobi_and_null_vector():
    """Same 5-sweep Jacobi: eigenpairs and triangulation null vectors agree
    (vectors compared as returned, signs included)."""
    A = G.normal(size=(256, 4, 4)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1)
    va, Va = jlin.jacobi_eigh_4x4(jnp.asarray(M))
    vb, Vb = tlin.jacobi_eigh_4x4(_t(M))
    np.testing.assert_allclose(vb.numpy(), np.asarray(va), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(Vb.numpy(), np.asarray(Va), atol=1e-4)
    na = jlin.null_vector_4(jnp.asarray(A))
    nb = tlin.null_vector_4(_t(A))
    np.testing.assert_allclose(nb.numpy(), np.asarray(na), atol=1e-4)
    _check_dense_solve()


def _dense_systems(g, n):
    """Seeded [n, n] float32 systems and right sides: a damped J^T J, a
    global-BA-like system with one eigenvalue near 1e-6 (the monocular
    scale direction), and an integer system whose columns have exact
    pivot ties."""
    J = g.normal(size=(2 * n, n))
    spd = J.T @ J + 1e-3 * np.eye(n)
    Q, _ = np.linalg.qr(g.normal(size=(n, n)))
    lam = np.geomspace(1.0, 1e3, n)
    lam[0] = 1e-6
    weak = (Q * lam) @ Q.T
    tie = g.integers(-3, 4, size=(n, n)).astype(np.float64)
    return {k: (a.astype(np.float32), g.normal(size=n).astype(np.float32))
            for k, a in (("spd", spd), ("weak", weak), ("tie", tie))}


def _unblocked_lu_pivots(A):
    """The pivot rows of an unblocked partial-pivot LU in float32 (the
    largest |a|, the first row on ties)."""
    A = A.astype(np.float32).copy()
    n = A.shape[0]
    piv = []
    for j in range(n):
        p = j + int(np.argmax(np.abs(A[j:, j])))
        piv.append(p)
        A[[j, p], j:] = A[[p, j], j:]
        f = A[j + 1:, j] * (np.float32(1.0) / A[j, j])
        A[j + 1:, j + 1:] = A[j + 1:, j + 1:] - f[:, None] * A[j, j + 1:][None, :]
    return np.asarray(piv)


def _check_dense_solve():
    """The dense solver's plain version (csrc/dense_lu.cuh's blocked order)
    against jnp.linalg.solve: a backward error |Ax - b| / (|A||x| + |b|)
    (infinity norms, float64) within 10x of the reference's own, at n = 48
    (the 8-keyframe window), 306 (global BA) and 357 (the pose graph); on
    the tie system the pivot rows of an unblocked LU."""
    g = np.random.default_rng(31)

    def backward_error(A, b, x):
        A, b, x = A.astype(np.float64), b.astype(np.float64), x.astype(np.float64)
        return np.abs(A @ x - b).max() / (np.abs(A).sum(1).max() * np.abs(x).max()
                                          + np.abs(b).max())

    for n in (48, 306, 357):
        for kind, (A, b) in _dense_systems(g, n).items():
            Ab = torch.from_numpy(np.concatenate([A, b[:, None]], 1))
            x, piv = tlin.dense_solve(Ab)
            xr = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)))
            assert np.isfinite(x.numpy()).all(), f"dense_solve {kind} n={n}"
            be, be_ref = backward_error(A, b, x.numpy()), backward_error(A, b, xr)
            assert be <= 10 * be_ref, f"dense_solve {kind} n={n}: {be:.2e} vs {be_ref:.2e}"
            if kind == "tie":
                np.testing.assert_array_equal(piv.numpy(), _unblocked_lu_pivots(A))
