"""Two-view bootstrap parity: the init matching of the system facade,
`initialize_two_view` (with the SAME RANSAC sets drawn from the host
numpy RNG, as the system draws them), `triangulate` and
`triangulate_lines`, port against JAX.

What is compared: match indices and the rotation-gated valid mask
exactly; success, model choice and the good mask exactly; R and t within
1e-4 (batched SVDs whose null vectors may differ in sign, which neither
the scores nor the chosen (R, t) depend on); triangulated points within
1e-3 relative; line triangulation: the good mask exactly, endpoints within
1e-4 relative (a 3x3 inverse and ray / plane products in float32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.models import pipeline as jpipe
from structure_slam_pointline_tpu.models import system as jsys
from structure_slam_pointline_tpu.ops import twoview as jtv
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import system as tsys
from structure_slam_pointline_tpu_torch.ops import twoview as ttv
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

from torch_port_helpers import configs, sequence, to_numpy_dict


@functools.lru_cache(maxsize=None)
def _frames():
    jc, tc = configs()
    jc2 = jc.replace(frontend=dataclasses.replace(jc.frontend, n_keypoints=1024))
    imgs, _ = sequence()
    intr = jsys.Intrinsics.from_config(jc.camera)
    fr = [jpipe.build_frame_jit(jnp.asarray(imgs[k]), intr, jc2) for k in (0, 4)]
    return jc, tc, intr, fr, [convert.frame_from_numpy(to_numpy_dict(f), "cpu") for f in fr]


def test_init_match():
    jc, tc, _, fr, tf = _frames()
    m, mv, _ = jax.device_get(jsys._init_match_device(fr[0], fr[1], jc))
    tm, tmv, tml = tsys._init_match_device(tf[0], tf[1], tc)
    assert tml is None
    np.testing.assert_array_equal(tm.idx.numpy(), m.idx)
    np.testing.assert_array_equal(tm.valid.numpy(), m.valid)
    np.testing.assert_array_equal(tmv.numpy(), mv)
    assert mv.sum() >= jc.init.min_matches


@pytest.mark.parametrize("seed", [0, 1])
def test_initialize_two_view(seed):
    jc, tc, intr, fr, tf = _frames()
    m, mv, _ = jax.device_get(jsys._init_match_device(fr[0], fr[1], jc))
    rng = np.random.default_rng(seed)
    sets = np.stack([rng.choice(np.nonzero(mv)[0], 8, replace=False) for _ in range(200)])
    kw = dict(sigma=1.0, min_triangulated=50, rh_threshold=0.4, min_parallax_deg=2.0)
    ref = jax.device_get(jtv.initialize_two_view(
        fr[0].xy, fr[1].xy[m.idx], jnp.asarray(mv), jnp.asarray(sets), intr, **kw))
    out = ttv.initialize_two_view(
        tf[0].xy, tf[1].xy[torch.from_numpy(np.array(m.idx)).long()], torch.from_numpy(np.array(mv)),
        torch.from_numpy(sets), Intrinsics.from_config(tc.camera), **kw)
    assert bool(out.success) == bool(ref.success)
    assert bool(out.used_homography) == bool(ref.used_homography)
    np.testing.assert_array_equal(out.good_mask.numpy(), ref.good_mask)
    np.testing.assert_allclose(out.R.numpy(), ref.R, atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), ref.t, atol=1e-4)
    g = ref.good_mask
    np.testing.assert_allclose(out.points3d.numpy()[g], ref.points3d[g], rtol=1e-3, atol=1e-4)


def test_triangulate():
    g = np.random.default_rng(4)
    X = np.stack([g.uniform(-2, 2, 200), g.uniform(-2, 2, 200), g.uniform(3, 8, 200)], 1)
    K = np.array([[480.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    P1 = (K @ np.eye(3, 4)).astype(np.float32)
    Rt = np.eye(3, 4)
    Rt[:, 3] = [0.3, 0.05, 0.02]
    P2 = (K @ Rt).astype(np.float32)

    def proj(P):
        h = np.c_[X, np.ones(200)] @ P.T
        return (h[:, :2] / h[:, 2:]).astype(np.float32) + g.normal(0, 0.3, (200, 2)).astype(np.float32)

    uv1, uv2 = proj(P1), proj(P2)
    ref = np.asarray(jtv.triangulate(P1, P2, uv1, uv2))
    out = ttv.triangulate(*[torch.from_numpy(a) for a in (P1, P2, uv1, uv2)]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


def test_triangulate_lines():
    g = np.random.default_rng(5)
    M = 64
    S = np.stack([g.uniform(-2, 2, M), g.uniform(-2, 2, M), g.uniform(3, 8, M)], 1)
    E = S + g.normal(0, 0.8, (M, 3))
    K = np.array([[480.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    c, s_ = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    t = np.array([0.3, 0.05, 0.02], np.float32)

    def proj(X, R_, t_):
        h = (X @ R_.T + t_) @ K.T
        return h[:, :2] / h[:, 2:] + g.normal(0, 0.3, (len(X), 2))

    def coeffs(a, b):
        l = np.cross(np.c_[a, np.ones(M)], np.c_[b, np.ones(M)])
        return (l / np.hypot(l[:, 0], l[:, 1])[:, None]).astype(np.float32)

    s1, e1 = proj(S, np.eye(3), np.zeros(3)), proj(E, np.eye(3), np.zeros(3))
    s2, e2 = proj(S, R, t), proj(E, R, t)
    ep1 = np.c_[s1, e1].astype(np.float32)
    ok = g.uniform(size=M) < 0.9
    args = [coeffs(s1, e1), ep1, coeffs(s2, e2), ok, R, t, K]
    ref = jax.device_get(jtv.triangulate_lines(*[jnp.asarray(a) for a in args]))
    out = ttv.triangulate_lines(*[torch.from_numpy(np.asarray(a)) for a in args])
    np.testing.assert_array_equal(out.good.numpy(), ref.good)
    assert ref.good.sum() > M // 2
    gm = ref.good
    np.testing.assert_allclose(out.start.numpy()[gm], ref.start[gm], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.end.numpy()[gm], ref.end[gm], rtol=1e-4, atol=1e-4)
