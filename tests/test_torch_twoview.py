"""Two-view bootstrap parity: the init matching of the system facade,
`initialize_two_view` (with the SAME RANSAC sets drawn from the host
numpy RNG, as the system draws them) and `triangulate`, port against JAX.

What is compared: match indices and the rotation-gated valid mask
exactly; success, model choice and the good mask exactly; R and t within
1e-4 (batched SVDs whose null vectors may differ in sign, which neither
the scores nor the chosen (R, t) depend on); triangulated points within
1e-3 relative.
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
    tm, tmv = tsys._init_match_device(tf[0], tf[1], tc)
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
