"""Line frontend parity: LSD (`gradients`, the dense support pass, the
single-level anchor selector, `detect_lines_pyramid`) and LBD
(`describe_lines`) of the port's plain versions against the JAX package on
two rendered 320x240 frames at the default line configuration.

The reference exposes no intermediate of `detect_lines`, so `_jax_dense`
below runs lsd.py:207-283 and :308-352 with the module's own helpers to
give its best-score map and packed ridge plane.

What was measured against XLA:CPU, and is held here:
- gradients and the half octave (2x2 sum added in row-major window order,
  times 0.25) are bit-exact;
- the dense pass (best score and packed ridge plane) is bit-exact on every
  pixel of both octaves of both frames, once the port rounds as XLA:CPU
  does: jnp.arctan2 is glibc's atan2f (torch's atan2 differs in the last
  bit on ~16% of pixels, which moved ~11% of the scores), and the
  magnitude's square root stays unrounded where the reference converts it
  to float32 (the score, the ridge centre) but is bf16 in the comparisons
  and the rolled neighbour copies;
- segments: valid masks and octaves equal, endpoints within 1e-3 px
  (measured <= 9.2e-5 px: the refinement's float32 row sums are taken in
  another order and XLA contracts multiply-adds into FMAs), line
  coefficients within 1e-5 relative;
- LBD: float descriptors within 1e-6 (measured <= 2.4e-7); every bit but
  bit 176 equal on every segment. Bit 176 is the pair (68, 69) of the
  w_mean block: the middle band's |m_2 - m_3| and |m_3 - m_2| are equal in
  exact arithmetic, the port keeps them equal (bit 0, asserted on every
  flipped segment), and XLA's fused arithmetic breaks the tie by a
  rounding. That tie falls in 5 and 7 of the 16 valid segments of the two
  frames, so only 94.5-96.1% of the packed words are equal.

`line_support_downsample = 2` (lsd.py:219-233) is held to the same
bounds, on the same frames: the half-resolution support score bit-exact
(and the ridge plane, which stays at full resolution), the 8 px cell
anchors exact, the pyramid's segments under ds = 1's tolerances although
every anchor now sits on a half pixel (the bilinear weights are 0.5 and
round-half-to-even meets exact .5 walk samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.config import FrontendConfig as JFront
from structure_slam_pointline_tpu.ops import fast as jfast
from structure_slam_pointline_tpu.ops import lbd as jlbd
from structure_slam_pointline_tpu.ops import lsd as jlsd
from structure_slam_pointline_tpu_torch.config import FrontendConfig as TFront
from structure_slam_pointline_tpu_torch.ops import fast as tfast
from structure_slam_pointline_tpu_torch.ops import lbd as tlbd
from structure_slam_pointline_tpu_torch.ops import lsd as tlsd
from structure_slam_pointline_tpu_torch.utils import fmath

from torch_port_helpers import FRONT, disk_cached, sequence, to_numpy_dict

FRAMES = (5, 20)


def _jax_dense(img, cfg):
    """lsd.py:207-283 (best score) and :308-352 (packed ridge plane); at
    cfg.line_support_downsample = 2 the score of :219-233's half image."""
    ds = cfg.line_support_downsample
    gx, gy, mag = jlsd.gradients(img)
    gang = jnp.arctan2(gy.astype(jnp.float32), gx.astype(jnp.float32))
    magf = mag.astype(jnp.float32)
    nbr_dirs = [(1, 0), (1, 1), (0, 1), (-1, 1)]

    def nms(gang, mag):
        grad_bin = jnp.mod(jnp.round(jnp.mod(gang, jnp.pi) / (jnp.pi / 4.0)).astype(jnp.int32),
                           4)
        m_plus = jnp.zeros_like(mag)
        m_minus = jnp.zeros_like(mag)
        for b, (bdx, bdy) in enumerate(nbr_dirs):
            sel = grad_bin == b
            m_plus = jnp.where(sel, jnp.roll(mag, (-bdy, -bdx), axis=(0, 1)), m_plus)
            m_minus = jnp.where(sel, jnp.roll(mag, (bdy, bdx), axis=(0, 1)), m_minus)
        return grad_bin, m_plus, m_minus

    grad_bin, m_plus, m_minus = nms(gang, mag)
    if ds == 2:
        h, w = img.shape
        img_s = 0.25 * jax.lax.reduce_window(img[:h // 2 * 2, :w // 2 * 2], 0.0, jax.lax.add,
                                             (2, 2), (2, 2), "VALID")
        sgx, sgy, smag = jlsd.gradients(img_s)
        sgang = jnp.arctan2(sgy.astype(jnp.float32), sgx.astype(jnp.float32))
        smagf = smag.astype(jnp.float32)
        grad_thresh = 0.75 * cfg.line_grad_threshold
        _, sm_plus, sm_minus = nms(sgang, smag)
    else:
        smag, sgang, smagf, sm_plus, sm_minus = mag, gang, magf, m_plus, m_minus
        grad_thresh = cfg.line_grad_threshold
    is_peak = (smag >= sm_plus) & (smag >= sm_minus) & (smag > grad_thresh)
    line_ang = jnp.mod(sgang + jnp.pi / 2.0, jnp.pi)
    weak = smag > 0.5 * grad_thresh

    def body(best, xs):
        di, df = xs
        aligned = jlsd._angle_diff(line_ang, df[0]) < cfg.line_angle_tol
        cont = (weak & aligned).astype(jnp.bfloat16)
        contd = jnp.maximum(cont, jnp.maximum(jlsd._dyn_shift(cont, di[2], di[3]),
                                              jlsd._dyn_shift(cont, -di[2], -di[3])))
        pair = contd * jlsd._dyn_shift(contd, di[0], di[1])
        sup = (jlsd._dyn_support_sum(pair, di[0], di[1])
               + jlsd._dyn_support_sum(pair, -di[0], -di[1]))
        support_px = sup.astype(jnp.float32) * (df[1] * ds)
        score = jnp.where(is_peak & aligned & (support_px >= 0.75 * cfg.line_min_length),
                          support_px * smagf, 0.0)
        return jnp.maximum(best, score), None

    best, _ = jax.lax.scan(body, jnp.zeros(smag.shape, jnp.float32),
                           (jnp.asarray(jlsd._DIR_I), jnp.asarray(jlsd._DIR_F)), unroll=4)
    fp32, fm32 = m_plus.astype(jnp.float32), m_minus.astype(jnp.float32)
    den = fm32 - 2.0 * magf + fp32
    binlen = jnp.where((grad_bin == 1) | (grad_bin == 3), jnp.sqrt(2.0), 1.0)
    delta = jnp.where(jnp.abs(den) > 1e-6, 0.5 * (fm32 - fp32) / den, 0.0)
    delta = jnp.clip(delta * binlen, -1.5, 1.5)
    mag_ridge = jnp.maximum(jnp.maximum(fp32, fm32), magf)
    shift_i = jnp.round(delta / binlen).astype(jnp.int32)
    gang_ridge = gang
    for b, (bdx, bdy) in enumerate(nbr_dirs):
        sel = grad_bin == b
        gang_ridge = jnp.where(sel & (shift_i == 1), jnp.roll(gang, (-bdy, -bdx), axis=(0, 1)),
                               gang_ridge)
        gang_ridge = jnp.where(sel & (shift_i == -1), jnp.roll(gang, (bdy, bdx), axis=(0, 1)),
                               gang_ridge)
    q_delta = jnp.round((delta + 1.5) * 85.0).astype(jnp.uint32)
    q_ang = jnp.clip(jnp.round((gang_ridge + jnp.pi) / (2.0 * jnp.pi) * 1023.0),
                     0.0, 1023.0).astype(jnp.uint32)
    q_mag = jnp.clip(jnp.round(mag_ridge * 40.0), 0.0, 4095.0).astype(jnp.uint32)
    packed = (grad_bin.astype(jnp.uint32) << 30) | (q_delta << 22) | (q_ang << 12) | q_mag
    return best, packed


@disk_cached
def _reference():
    """The JAX side of every test here, as numpy, per frame."""
    cfg = JFront(**FRONT)
    cfg2 = JFront(**FRONT, line_support_downsample=2)
    imgs, _ = sequence()
    dense = jax.jit(_jax_dense, static_argnames=("cfg",))
    grads = jax.jit(jlsd.gradients)
    pyr = jax.jit(jlsd.detect_lines_pyramid, static_argnames=("cfg",))
    desc = jax.jit(jlbd.describe_lines)
    out = {}
    for f in FRAMES:
        img = jnp.asarray(imgs[f])
        half = 0.25 * jax.lax.reduce_window(img, 0.0, jax.lax.add, (2, 2), (2, 2), "VALID")
        r = {"grad": [np.asarray(a.astype(jnp.float32)) for a in grads(img)],
             "half": np.asarray(half)}
        # per ds, per octave: (best score, packed ridge plane)
        r["dense"] = {ds: [[np.asarray(a) for a in dense(im, c)] for im in (img, half)]
                      for ds, c in ((1, cfg), (2, cfg2))}
        # per ds: the octave-0 anchors (16 px cells, or 8 px on the half score)
        r["anchors"] = {ds: [np.asarray(a) for a in jfast.select_keypoints(
            jnp.asarray(r["dense"][ds][0][0]), k=cfg.line_anchor_count, cell=16 // ds,
            cell_cap=1, threshold=1.0, min_threshold=1.0, border=4 // ds)] for ds in (1, 2)}
        lines = pyr(img, cfg)
        r["lines"] = to_numpy_dict(lines)
        r["lines_ds2"] = to_numpy_dict(pyr(img, cfg2))
        r["desc"] = [np.asarray(a) for a in desc(img, lines.endpoints, lines.valid)]
        out[f] = r
    return out


def _img(f):
    return torch.from_numpy(np.array(sequence()[0][f]))


@pytest.mark.parametrize("frame", FRAMES)
def test_gradients_and_half_octave_bit_exact(frame):
    ref = _reference()[frame]
    img = _img(frame)
    for a, b in zip(tlsd.gradients(img), ref["grad"]):
        np.testing.assert_array_equal(a.float().numpy(), b)
    np.testing.assert_array_equal(tlsd.half_octave(img).numpy(), ref["half"])


@pytest.mark.parametrize("frame", FRAMES)
def test_dense_support_bit_exact(frame):
    ref = _reference()[frame]
    fe = TFront(**FRONT)
    for ds in (1, 2):
        for octave, im in enumerate((_img(frame), torch.from_numpy(np.array(ref["half"])))):
            best, packed = tlsd.lsd_support(im, fe.line_grad_threshold, fe.line_angle_tol,
                                            fe.line_min_length, ds)
            jb, jp = ref["dense"][ds][octave]
            msg = f"ds {ds}, octave {octave}"
            assert jb.shape == (im.shape[0] // ds, im.shape[1] // ds), msg
            assert (jb > 0).sum() > 100 // ds ** 2, msg
            np.testing.assert_array_equal(best.numpy(), jb, err_msg=msg)
            np.testing.assert_array_equal(packed.numpy().view(np.uint32), jp, err_msg=msg)
        # the ridge plane stays at full resolution: ds = 2's equals ds = 1's
        np.testing.assert_array_equal(ref["dense"][2][0][1], ref["dense"][1][0][1])


def test_select_keypoints_single_level():
    ref = _reference()[FRAMES[0]]
    for ds in (1, 2):
        best = torch.from_numpy(np.array(ref["dense"][ds][0][0]))
        xy, resp, valid = tfast.select_keypoints(best, k=TFront(**FRONT).line_anchor_count,
                                                 cell=16 // ds, cell_cap=1, threshold=1.0,
                                                 min_threshold=1.0, border=4 // ds)
        jxy, jresp, jvalid = ref["anchors"][ds]
        assert jvalid.sum() >= 20, ds
        np.testing.assert_array_equal(valid.numpy(), jvalid, err_msg=f"ds {ds}")
        np.testing.assert_array_equal(xy.numpy(), jxy, err_msg=f"ds {ds}")
        np.testing.assert_array_equal(resp.numpy(), jresp, err_msg=f"ds {ds}")


def test_atan2_is_xla_cpu_bit_for_bit():
    g = np.random.default_rng(9)
    y = (g.normal(size=20000) * np.exp(g.normal(size=20000) * 3)).astype(np.float32)
    x = (g.normal(size=20000) * np.exp(g.normal(size=20000) * 3)).astype(np.float32)
    y[:40], x[40:80], x[80:120], y[120:130] = 0.0, 0.0, 1.0, -0.0
    ref = np.asarray(jax.jit(jnp.arctan2)(y, x))
    out = fmath.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("frame", FRAMES)
def test_detect_lines_pyramid(frame):
    for ds, key in ((1, "lines"), (2, "lines_ds2")):
        ref = _reference()[frame][key]
        out = tlsd.detect_lines_pyramid(_img(frame),
                                        TFront(**FRONT, line_support_downsample=ds))
        msg = f"ds {ds}"
        assert ref["valid"].sum() >= 8, msg
        np.testing.assert_array_equal(out.valid.numpy(), ref["valid"], err_msg=msg)
        np.testing.assert_array_equal(out.octave.numpy(), ref["octave"], err_msg=msg)
        np.testing.assert_allclose(out.endpoints.numpy(), ref["endpoints"], atol=1e-3, rtol=0,
                                   err_msg=msg)
        np.testing.assert_allclose(out.line2d.numpy(), ref["line2d"], atol=1e-5, rtol=1e-5,
                                   err_msg=msg)
        np.testing.assert_allclose(out.response.numpy(), ref["response"], rtol=1e-4,
                                   err_msg=msg)


@pytest.mark.parametrize("frame", FRAMES)
def test_describe_lines(frame):
    r = _reference()[frame]
    words, desc = tlbd.describe_lines(_img(frame),
                                      torch.from_numpy(np.array(r["lines"]["endpoints"])),
                                      torch.from_numpy(np.array(r["lines"]["valid"])))
    jw, jd = r["desc"]
    w = words.numpy().view(np.uint32)
    np.testing.assert_allclose(desc.numpy(), jd, atol=1e-6, rtol=0)
    # bit k of the descriptor is bit k % 32 of word k // 32
    flips = np.unpackbits((w ^ jw).view(np.uint8), bitorder="little").reshape(len(w), 256)
    tie = 176
    assert not flips[:, np.arange(256) != tie].any(), "a bit other than the known tie differs"
    a, b = tlbd._PAIRS[tie]
    flipped = flips[:, tie].astype(bool)
    assert (a, b) == (68, 69)
    # where bit 176 differs, the port holds the pair exactly tied (bit 0)
    np.testing.assert_array_equal(desc.numpy()[flipped, a], desc.numpy()[flipped, b])
    assert not (w[flipped, tie // 32] >> (tie % 32) & 1).any()
