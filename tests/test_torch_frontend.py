"""Frontend parity: pyramid, FAST + NMS, keypoint selection, ORB and the
whole `extract_orb` of the PyTorch port (plain versions, CPU) against the
JAX package on the same rendered 320x240 frame.

What was checked against the JAX package on the CPU, and held here:
- pyramid levels are bit-equal once the resize weights are built like
  jax.image.resize builds them (scale n/m inverted in double precision,
  rows contracted first, bf16 after each contraction);
- the blur is bit-equal with bf16 tap weights and bf16 rounding after
  every multiply and add (XLA:CPU keeps no excess precision here);
- FAST raw and NMS maps are bit-equal; the NMS jitter is a bf16 product
  and vanishes against scores above ~0.01, as in the reference;
- selection, descriptors and octaves are exactly equal; angles agree to
  1e-4 rad (float32 moment sums in another order); keypoint positions
  are compared on `valid` slots only (invalid slots carry cell-origin xy).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.config import FrontendConfig as JFront
from structure_slam_pointline_tpu.ops import extract as jext
from structure_slam_pointline_tpu.ops import fast as jfast
from structure_slam_pointline_tpu.ops import orb as jorb
from structure_slam_pointline_tpu.ops import pyramid as jpyr
from structure_slam_pointline_tpu_torch.config import FrontendConfig as TFront
from structure_slam_pointline_tpu_torch.ops import extract as text
from structure_slam_pointline_tpu_torch.ops import fast as tfast
from structure_slam_pointline_tpu_torch.ops import orb as torb
from structure_slam_pointline_tpu_torch.ops import pyramid as tpyr

from torch_port_helpers import sequence


@functools.lru_cache(maxsize=None)
def _img():
    imgs, _ = sequence(8)
    return imgs[5]


@functools.lru_cache(maxsize=None)
def _levels():
    img = _img()
    j = jpyr.build_blurred_pyramid(jnp.asarray(img).astype(jnp.bfloat16), 8, 1.2, 2.0)
    t = tpyr.build_blurred_pyramid(torch.from_numpy(img).to(torch.bfloat16), 8, 1.2, 2.0)
    return j, t


@jax.jit
def _jax_fast(levels):
    raws = [jfast.fast_score(a) for a in levels]
    return raws, [jfast.nms3(r) for r in raws]


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") and not \
        isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("which", [0, 1])   # 0: levels, 1: blurred levels
def test_pyramid_and_blur_bit_exact(which):
    j, t = _levels()
    for a, b in zip(j[which], t[which]):
        np.testing.assert_array_equal(_np(b), _np(a))


def test_fast_and_nms_bit_exact():
    """Each level alone and the frame's levels entry (all 8 in one call)."""
    j, t = _levels()
    raws, nmss = _jax_fast(j[0])
    for raw_j, nms_j, b in zip(raws, nmss, t[0]):
        raw_t, nms_t = tfast.fast_score_nms(b)
        np.testing.assert_array_equal(raw_t.numpy(), _np(raw_j))
        np.testing.assert_array_equal(nms_t.numpy(), _np(nms_j))
    maps = tfast.fast_score_nms_levels(list(t[0]))
    assert len(maps) == len(raws)
    for (raw_t, nms_t), raw_j, nms_j in zip(maps, raws, nmss):
        np.testing.assert_array_equal(raw_t.numpy(), _np(raw_j))
        np.testing.assert_array_equal(nms_t.numpy(), _np(nms_j))


def test_select_keypoints_levels_exact():
    j, t = _levels()
    ks = [60, 50, 40, 30, 30, 20, 20, 10]
    raws, nmss = _jax_fast(j[0])
    sj = jax.jit(lambda sr: jfast.select_keypoints_levels(sr, ks, border=16))(
        list(zip(nmss, raws)))
    st = tfast.select_keypoints_levels(
        [tfast.fast_score_nms(b)[::-1] for b in t[0]], ks, border=16)
    for (xa, ra, va), (xb, rb, vb) in zip(sj, st):
        va = np.asarray(va)
        np.testing.assert_array_equal(vb.numpy(), va)
        np.testing.assert_array_equal(xb.numpy()[va], np.asarray(xa)[va])
        np.testing.assert_array_equal(rb.numpy(), np.asarray(ra))


def test_orb_tables_are_the_references():
    np.testing.assert_array_equal(torb._make_pattern(), jorb._make_pattern())
    np.testing.assert_array_equal(torb._rotated_tables(), jorb._rotated_tables())


def test_orient_and_describe():
    """Each level alone, then the frame's levels entry on the same
    keypoints (100 a level, one after another as kernel 11 writes them):
    angles, descriptors, level-0 coordinates and octaves per level."""
    j, t = _levels()
    g = np.random.default_rng(1)
    per_level = []
    for a, b in zip(j[1], t[1]):
        h, w = b.shape
        xy = np.stack([g.uniform(16, w - 17, 100), g.uniform(16, h - 17, 100)], 1)
        xy = xy.astype(np.float32)
        ang_j, desc_j = jorb.orient_and_describe(a, jnp.asarray(xy))
        ang_t, desc_t = torb.orient_and_describe(b, torch.from_numpy(xy))
        np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-4)
        np.testing.assert_array_equal(desc_t.numpy().view(np.uint32), np.asarray(desc_j))
        per_level.append((xy, np.asarray(ang_j), np.asarray(desc_j)))
    scales = jpyr.level_scales(8, 1.2)
    xy_all = torch.from_numpy(np.concatenate([p[0] for p in per_level]))
    ang_t, desc_t, xy0_t, oct_t = torb.orient_and_describe_levels(
        list(t[1]), xy_all, [100] * 8, [float(s) for s in scales], list(range(8)))
    for lv, (xy, ang_j, desc_j) in enumerate(per_level):
        sl = slice(100 * lv, 100 * (lv + 1))
        np.testing.assert_allclose(ang_t[sl].numpy(), ang_j, atol=1e-4)
        np.testing.assert_array_equal(desc_t[sl].numpy().view(np.uint32), desc_j)
        np.testing.assert_array_equal(xy0_t[sl].numpy(), xy * np.float32(scales[lv]))
        np.testing.assert_array_equal(oct_t[sl].numpy(), np.full(100, lv, np.int32))


def test_extract_orb_320x240_256_keypoints():
    img = _img()
    kj = jext.extract_orb(jnp.asarray(img), JFront(n_keypoints=256))
    kt = text.extract_orb(torch.from_numpy(img), TFront(n_keypoints=256))
    valid = np.asarray(kj.valid)
    np.testing.assert_array_equal(kt.valid.numpy(), valid)
    assert valid.sum() > 200
    np.testing.assert_array_equal(kt.octave.numpy(), np.asarray(kj.octave))
    np.testing.assert_array_equal(kt.xy.numpy()[valid], np.asarray(kj.xy)[valid])
    np.testing.assert_array_equal(kt.response.numpy(), np.asarray(kj.response))
    np.testing.assert_array_equal(kt.desc.numpy().view(np.uint32)[valid],
                                  np.asarray(kj.desc)[valid])
    np.testing.assert_allclose(kt.angle.numpy()[valid], np.asarray(kj.angle)[valid],
                               atol=1e-4)
