"""Pose-LM parity (kernel 4's plain version) and the residual helpers
against the JAX package: a synthetic pose problem with 10% gross point
outliers, run once with `line_pose_weight = 0` (line masks all false, as
on the main path) and once with line edges weighted in, so the line rows
(e = l . (u, v, 1), both endpoints gated) are exercised.

Tolerance: pose entries within 1e-4 (float32 reductions in another
order over 24 damped GN iterations); inlier masks exactly equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.config import CameraConfig as JCam
from structure_slam_pointline_tpu.config import OptimConfig as JOpt
from structure_slam_pointline_tpu.optim import pose_opt as jpo
from structure_slam_pointline_tpu.optim import residuals as jres
from structure_slam_pointline_tpu.utils.camera import Intrinsics as JI
from structure_slam_pointline_tpu_torch.config import CameraConfig as TCam
from structure_slam_pointline_tpu_torch.config import OptimConfig as TOpt
from structure_slam_pointline_tpu_torch.optim import pose_opt as tpo
from structure_slam_pointline_tpu_torch.optim import residuals as tres
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics as TI

JINTR, TINTR = JI.from_config(JCam(fy=480.0)), TI.from_config(TCam(fy=480.0))


def _problem(seed, line_weight, N=300, M=40):
    g = np.random.default_rng(seed)
    pts = np.stack([g.uniform(-3, 3, N), g.uniform(-2, 2, N), g.uniform(4, 9, N)], 1)
    sw = np.stack([g.uniform(-3, 3, M), g.uniform(-2, 2, M), g.uniform(4, 9, M)], 1)
    ew = sw + g.normal(0, 0.6, (M, 3))

    def proj(X):
        return np.stack([JINTR.fx * X[:, 0] / X[:, 2] + JINTR.cx,
                         float(JINTR.fy) * X[:, 1] / X[:, 2] + JINTR.cy], 1)

    obs = proj(pts) + g.normal(0, 0.7, (N, 2))
    obs[: N // 10] += g.uniform(-30, 30, (N // 10, 2))
    us, ue = proj(sw) + g.normal(0, 0.5, (M, 2)), proj(ew) + g.normal(0, 0.5, (M, 2))
    l = np.cross(np.c_[us, np.ones(M)], np.c_[ue, np.ones(M)])
    l /= np.hypot(l[:, 0], l[:, 1])[:, None]
    T0 = np.eye(4)
    T0[:3, 3] = [0.04, -0.03, 0.06]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    ln_mask = g.uniform(size=M) < (0.8 if line_weight > 0 else 0.0)
    return [f32(T0), f32(pts), f32(obs), g.uniform(size=N) < 0.85,
            f32(1.2 ** (2 * g.integers(0, 8, N))), f32(sw), f32(ew), f32(l), ln_mask,
            f32(np.full(M, 1.44) / max(line_weight, 1e-9))]


@pytest.mark.parametrize("line_weight", [0.0, 1.0])
def test_pose_optimize(line_weight):
    args = _problem(3 + int(line_weight), line_weight)
    jcfg = dataclasses.replace(JOpt(), line_pose_weight=line_weight)
    tcfg = dataclasses.replace(TOpt(), line_pose_weight=line_weight)
    ref = jpo.pose_optimize(*[jnp.asarray(a) for a in args], JINTR, jcfg)
    out = tpo.pose_optimize(*[torch.from_numpy(np.array(a)) for a in args], TINTR, tcfg)
    np.testing.assert_allclose(out.T_cw.numpy(), np.asarray(ref.T_cw), atol=1e-4)
    np.testing.assert_array_equal(out.point_inliers.numpy(), np.asarray(ref.point_inliers))
    np.testing.assert_array_equal(out.line_inliers.numpy(), np.asarray(ref.line_inliers))
    assert int(out.n_inliers) == int(ref.n_inliers)
    if line_weight > 0:
        assert out.line_inliers.sum() > 10


def test_residuals():
    args = _problem(9, 1.0)
    T = args[0]
    p = jres.point_residuals(jnp.asarray(T), args[1], args[2], JINTR)
    q = tres.point_residuals(torch.from_numpy(T), torch.from_numpy(args[1]),
                             torch.from_numpy(args[2]), TINTR)
    for a, b in zip(p, q):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-3)
    lp = jres.line_residuals(jnp.asarray(T), args[5], args[6], args[7], JINTR)
    lq = tres.line_residuals(*[torch.from_numpy(np.array(a)) for a in
                               (T, args[5], args[6], args[7])], TINTR)
    for a, b in zip(lp, lq):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-3)
