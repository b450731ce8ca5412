"""Line segment detection: dense directional support, sparse refinement.

Counterpart of structure_slam_pointline_tpu/ops/lsd.py (`detect_lines`,
`detect_lines_pyramid`). Per octave:

1. Dense pass (kernel 5, `lsd_support`, csrc/lsd_support.cu): bf16 Scharr
   gradients, the float32 gradient angle, the 4-bin directional NMS, and
   for each of the 16 integer directions the laterally dilated alignment
   mask, the pair gate and the +-8-step support count; the per-pixel best
   score = support px x magnitude. The same pass packs the ridge plane
   (snap bin, snap offset, ridge angle, ridge magnitude) into one uint32
   per pixel. Replaces lsd.py:207-283 and :308-352.
2. Anchors: the reference's single-level keypoint selector on the score
   (16 px cells, one anchor per cell), torch ops.
3. Refinement (kernel 6, `lsd_refine`, csrc/lsd_refine.cu): per anchor,
   nearest samples of the packed plane along the current line, the
   3-sample bridge, the outward contiguous runs, the weighted PCA refit;
   `line_refine_iters` coarse passes and the fine evaluation pass give the
   endpoints, the length and the response. Replaces lsd.py:357-440.
4. Merges (kernel 26, `lsd_merge`, csrc/lsd_merge.cu): collinear
   fragments linked, the links closed by four squarings (bit rows in
   shared memory), each component's representative and extents, the
   pairwise suppression of duplicates, the stable top L and the line
   coefficients, in one cluster of 8 blocks (the link and suppression
   pairs split over them) that writes no [K, K] plane. Replaces
   lsd.py:442-536. `detect_lines_pyramid`'s cross-octave dedup and top L
   is kernel 26's `lsd_octave_merge` (lsd.py:551-641).

`lsd_support_plain` / `lsd_refine_plain` / `lsd_merge_plain` /
`lsd_octave_merge_plain` are the plain versions, with the
reference's arithmetic op for op: every gradient op rounds to bf16,
`jnp.roll` wraps at the image border (gradient taps, NMS and ridge
neighbours) while the support pass zero-fills, `jnp.round` rounds half to
even and `jnp.mod` is a floor modulo (`matching.jnp_mod`). A CPU tensor
takes the plain versions; a CUDA tensor launches the kernels or raises.

`line_support_downsample = 2` (lsd.py:219-233) runs step 1's support scan
on the 2x2 box half image (0.75 x the gradient threshold, support in
full-resolution pixels) and step 2 with 8 px cells, the anchors mapped
back to full resolution at half-pixel centres; the ridge plane and the
refinement stay at full resolution.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import FrontendConfig
from structure_slam_pointline_tpu_torch.ops import fast
from structure_slam_pointline_tpu_torch.ops.matching import jnp_mod
from structure_slam_pointline_tpu_torch.utils import fmath
from structure_slam_pointline_tpu_torch.utils.indexing import stable_topk


class Lines(NamedTuple):
    endpoints: torch.Tensor  # [L, 4] (sx, sy, ex, ey)
    line2d: torch.Tensor     # [L, 3] normalized infinite-line coeffs
    response: torch.Tensor   # [L]
    angle: torch.Tensor      # [L] direction angle in [-pi/2, pi/2)
    valid: torch.Tensor      # [L] bool
    octave: torch.Tensor     # [L] int32 pyramid octave


# the reference's 16 exact integer direction vectors over [0, pi), with
# (vx, vy, rounded unit normal nx, ny) and (theta, |v|) in float32
_DIR_VECS = (
    (2, 0), (4, 1), (2, 1), (4, 3), (2, 2), (3, 4), (2, 4), (1, 4),
    (0, 2), (-1, 4), (-2, 4), (-3, 4), (-2, 2), (-4, 3), (-2, 1), (-4, 1),
)
_DIR_I = np.asarray([(vx, vy, int(np.round(-vy / np.hypot(vx, vy))),
                      int(np.round(vx / np.hypot(vx, vy)))) for vx, vy in _DIR_VECS],
                    np.int32)
_DIR_F = np.asarray([(float(np.mod(np.arctan2(vy, vx), np.pi)), float(np.hypot(vx, vy)))
                     for vx, vy in _DIR_VECS], np.float32)
_N_DOUBLINGS = 3          # support window 2^3 steps each way
_NBR_DIRS = ((1, 0), (1, 1), (0, 1), (-1, 1))   # NMS neighbour per 4-bin
REFINE_OUT = 7            # sx, sy, ex, ey, total_len, mean_mag, response
MERGE_MAX_K = 512         # kernel 26's candidates per block

_F32 = np.float32


def _c(x) -> float:
    """A Python float constant as the float32 the reference's weakly typed
    constants become."""
    return float(_F32(x))


PI = _c(math.pi)
HALF_PI = _c(math.pi / 2.0)
QUARTER_PI = _c(math.pi / 4.0)
TWO_PI = _c(2.0 * math.pi)
SQRT2 = float(np.sqrt(_F32(2.0)))


def _scharr(img: torch.Tensor):
    """bf16 Scharr taps with wrapped borders: (gx, gy, gx^2 + gy^2), every
    op rounded to bf16 as in the reference (lsd.py:54-75)."""
    img = img.to(torch.bfloat16)

    def sh(dy, dx):
        return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))

    d_m = sh(-1, 1) - sh(-1, -1)
    d_0 = sh(0, 1) - sh(0, -1)
    d_p = sh(1, 1) - sh(1, -1)
    gx = (3.0 * (d_m + d_p) + 10.0 * d_0) / 32.0
    r_m = sh(1, -1) - sh(-1, -1)
    r_0 = sh(1, 0) - sh(-1, 0)
    r_p = sh(1, 1) - sh(-1, 1)
    gy = (3.0 * (r_m + r_p) + 10.0 * r_0) / 32.0
    return gx, gy, gx * gx + gy * gy


def gradients(img: torch.Tensor):
    """bf16 Scharr gradients (gx, gy, mag) of a float32 image."""
    gx, gy, sq = _scharr(img)
    return gx, gy, torch.sqrt(sq)


def angle_diff(a: torch.Tensor, b) -> torch.Tensor:
    """Smallest difference between undirected orientations (period pi)."""
    return torch.abs(jnp_mod(a - b + HALF_PI, PI) - HALF_PI)


def _shift(m: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Value at (y + dy, x + dx), zero outside the image (no wrap)."""
    h, w = m.shape
    out = torch.zeros_like(m)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = m[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _support_sum(m: torch.Tensor, vx: int, vy: int) -> torch.Tensor:
    s = m
    step = 1
    for _ in range(_N_DOUBLINGS):
        s = s + _shift(s, vx * step, vy * step)
        step *= 2
    return s


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bit pattern."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _nms_planes(img: torch.Tensor):
    """(gang, magf, mag, grad_bin, m_plus, m_minus) of one image: the
    gradient angle, the magnitude unrounded (float32) and bf16-rounded, the
    4-bin gradient direction and the wrapped NMS neighbours' bf16
    magnitudes (lsd.py:207-211, :236-246)."""
    gx, gy, sq = _scharr(img)
    gang = fmath.atan2_plain(gy.float(), gx.float())
    # XLA:CPU keeps the magnitude's square root unrounded where the
    # reference converts it to float32 (the score and the ridge centre);
    # the bf16 comparisons and the rolled neighbour copies see it rounded
    magf = torch.sqrt(sq.float())
    mag = magf.to(torch.bfloat16).float()
    grad_bin = torch.round(jnp_mod(gang, PI) / QUARTER_PI).to(torch.int32) % 4
    m_plus = torch.zeros_like(magf)
    m_minus = torch.zeros_like(magf)
    for b, (bdx, bdy) in enumerate(_NBR_DIRS):
        sel = grad_bin == b
        m_plus = torch.where(sel, torch.roll(mag, (-bdy, -bdx), (0, 1)), m_plus)
        m_minus = torch.where(sel, torch.roll(mag, (bdy, bdx), (0, 1)), m_minus)
    return gang, magf, mag, grad_bin, m_plus, m_minus


def support_threshold(grad_thresh: float, ds: int) -> float:
    """The NMS peak threshold of the support pass: 0.75 x at the half
    resolution (box filtering softens the ridge contrast, lsd.py:228)."""
    return 0.75 * grad_thresh if ds == 2 else grad_thresh


def lsd_support_plain(img: torch.Tensor, grad_thresh: float, angle_tol: float,
                      min_length: float, ds: int = 1):
    """(best_score float32 [H/ds', W/ds'], packed ridge plane int32 [H, W])
    of one octave, the reference's arithmetic (lsd.py:207-283, :308-352).
    At ds = 2 the support scan runs on the 2x2 box half image (ds' = 2)
    with 0.75 x the gradient threshold and the support counted in
    full-resolution pixels; the ridge plane stays at full resolution, from
    the full image's planes. Any other ds scans at full resolution with
    the support scaled by ds, as the reference does."""
    gang, magf, mag, grad_bin, m_plus, m_minus = _nms_planes(img)
    if ds == 2:
        sgang, smagf, smag, _, sm_plus, sm_minus = _nms_planes(half_octave(img))
    else:
        sgang, smagf, smag, sm_plus, sm_minus = gang, magf, mag, m_plus, m_minus
    thresh = support_threshold(grad_thresh, ds)
    is_peak = (smag >= sm_plus) & (smag >= sm_minus) & (smag > thresh)
    line_ang = jnp_mod(sgang + HALF_PI, PI)
    weak = smag > 0.5 * thresh
    tol = _c(angle_tol)
    min_sup = _c(0.75 * min_length)

    best = torch.zeros_like(smagf)
    for (vx, vy, nx, ny), (th, vlen) in zip(_DIR_I.tolist(), _DIR_F.tolist()):
        aligned = angle_diff(line_ang, th) < tol
        cont = (weak & aligned).to(torch.int32)
        contd = torch.maximum(cont, torch.maximum(_shift(cont, nx, ny),
                                                  _shift(cont, -nx, -ny)))
        pair = contd * _shift(contd, vx, vy)
        sup = _support_sum(pair, vx, vy) + _support_sum(pair, -vx, -vy)
        support_px = sup.float() * _c(vlen * ds)   # full-resolution px
        score = torch.where(is_peak & aligned & (support_px >= min_sup),
                            support_px * smagf, torch.zeros_like(smagf))
        best = torch.maximum(best, score)

    fp32, fm32, f032 = m_plus, m_minus, magf
    den = fm32 - 2.0 * f032 + fp32
    odd = (grad_bin == 1) | (grad_bin == 3)
    binlen = torch.where(odd, torch.full_like(den, SQRT2), torch.ones_like(den))
    delta = torch.where(torch.abs(den) > 1e-6, 0.5 * (fm32 - fp32) / den,
                        torch.zeros_like(den))
    delta = torch.clamp(delta * binlen, -1.5, 1.5)
    mag_ridge = torch.maximum(torch.maximum(fp32, fm32), f032)
    shift_i = torch.round(delta / binlen).to(torch.int32)
    gang_ridge = gang
    for b, (bdx, bdy) in enumerate(_NBR_DIRS):
        sel = grad_bin == b
        gang_ridge = torch.where(sel & (shift_i == 1),
                                 torch.roll(gang, (-bdy, -bdx), (0, 1)), gang_ridge)
        gang_ridge = torch.where(sel & (shift_i == -1),
                                 torch.roll(gang, (bdy, bdx), (0, 1)), gang_ridge)
    q_delta = torch.round((delta + 1.5) * 85.0).long()
    q_ang = torch.clamp(torch.round((gang_ridge + PI) / TWO_PI * 1023.0), 0.0, 1023.0).long()
    q_mag = torch.clamp(torch.round(mag_ridge * 40.0), 0.0, 4095.0).long()
    packed = (grad_bin.long() << 30) | (q_delta << 22) | (q_ang << 12) | q_mag
    return best, _to_int32_bits(packed)


def lsd_support(img: torch.Tensor, grad_thresh: float, angle_tol: float,
                min_length: float, ds: int = 1):
    """Dense support pass of one octave: float32 [H, W] image ->
    (best_score float32, packed ridge plane int32 [H, W]); the score is
    [H // 2, W // 2] at ds = 2 and [H, W] otherwise (`lsd_support_plain`).

    CPU tensor -> plain version; CUDA tensor -> kernel 5 (or raise)."""
    if img.dim() != 2:
        raise ValueError(f"lsd_support: expects [H, W], got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return lsd_support_plain(img, grad_thresh, angle_tol, min_length, ds)
    kernels.check_dtype("lsd_support", img, torch.float32)
    kernels.check_cuda("lsd_support", img)
    img = img.contiguous()
    h, w = img.shape
    hs, ws = (h // 2, w // 2) if ds == 2 else (h, w)
    dev = img.device
    best = torch.empty((hs, ws), dtype=torch.float32, device=dev)
    packed = torch.empty((h, w), dtype=torch.int32, device=dev)
    # the peak count, the peak list (12 B a pixel) and the mask (2 B a pixel)
    scratch = torch.empty(16 + hs * ws * 14, dtype=torch.uint8, device=dev)
    kernels.launch("lsd_support", kernels.ptr(img), h, w, ds,
                   _c(support_threshold(grad_thresh, ds)), _c(angle_tol),
                   _c(0.75 * min_length), kernels.ptr(scratch), kernels.ptr(best),
                   kernels.ptr(packed))
    return best, packed


def _bilinear(planes, x, y):
    """Bilinear samples of [H, W] planes at float coords (lsd.py:84-106);
    bf16 planes promote to float32 in the products, as in the reference."""
    h, w = planes[0].shape
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    base = (y0 * w + x0).long()
    outs = []
    for im in planes:
        flat = im.reshape(-1)
        v00, v01 = flat[base].float(), flat[base + 1].float()
        v10, v11 = flat[base + w].float(), flat[base + w + 1].float()
        outs.append(v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
                    + v10 * (1 - fx) * fy + v11 * fx * fy)
    return outs


def _make_ts(n: int, step: float, device) -> torch.Tensor:
    return torch.cat([-torch.arange(n, 0, -1, dtype=torch.float32, device=device),
                      torch.arange(1, n + 1, dtype=torch.float32, device=device)]) * step


def lsd_refine_plain(img: torch.Tensor, packed: torch.Tensor, ax: torch.Tensor,
                     ay: torch.Tensor, walk_steps: int, refine_iters: int,
                     angle_tol: float, grad_thresh: float) -> torch.Tensor:
    """[K, 7] float32 (sx, sy, ex, ey, total_len, mean_mag, response) per
    anchor: the reference's refinement op for op (lsd.py:296-440)."""
    h, w = packed.shape
    dev = packed.device
    gx, gy, _ = gradients(img)
    a_gx, a_gy = _bilinear([gx, gy], ax, ay)
    a_ang = fmath.atan2_plain(a_gy, a_gx)
    d_ang = fmath.atan2_plain(torch.cos(a_ang), -torch.sin(a_ang))
    cx, cy = ax, ay
    pk = packed.reshape(-1).long() & 0xFFFFFFFF
    tol = _c(angle_tol)
    r2 = _c(0.7071067811865476)

    def refine(cx, cy, d_ang, ts):
        half = ts.shape[0] // 2
        px = cx[:, None] + torch.cos(d_ang)[:, None] * ts[None, :]
        py = cy[:, None] + torch.sin(d_ang)[:, None] * ts[None, :]
        xi = torch.clamp(torch.round(px).to(torch.int32), 0, w - 1)
        yi = torch.clamp(torch.round(py).to(torch.int32), 0, h - 1)
        s = pk[(yi * w + xi).long()]
        s_mag = (s & 4095).float() * _c(1.0 / 40.0)
        s_ang = ((s >> 12) & 1023).float() * _c(2.0 * math.pi / 1023.0) - PI
        s_bin = ((s >> 30) & 3).float()
        delta = ((s >> 22) & 255).float() * _c(1.0 / 85.0) - 1.5
        one, zero = torch.ones_like(delta), torch.zeros_like(delta)
        bdx = torch.where(s_bin == 0.0, one, torch.where(
            s_bin == 1.0, r2 * one, torch.where(s_bin == 2.0, zero, -r2 * one)))
        bdy = torch.where(s_bin == 0.0, zero, torch.where(s_bin == 2.0, one, r2 * one))
        qx = px + delta * bdx
        qy = py + delta * bdy
        expect = d_ang + HALF_PI
        aligned = ((angle_diff(s_ang, expect[:, None]) < tol) & (s_mag > 0.5 * grad_thresh)
                   & (qx >= 1) & (qx < w - 2) & (qy >= 1) & (qy < h - 2))
        aligned = aligned | (torch.roll(aligned, 1, 1) & torch.roll(aligned, -1, 1))
        pos = torch.cumprod(aligned[:, half:].float(), dim=1)
        neg = torch.cumprod(aligned[:, :half].flip(1).float(), dim=1).flip(1)
        run = torch.cat([neg, pos], dim=1)
        wgt = run * s_mag
        # row sums in sample order, kernel 6's: a centre an ulp off moves
        # the next pass's samples, and a sample can cross a pixel boundary
        msum, sx_, sy_ = fmath.seq_sum(torch.stack([wgt, wgt * qx, wgt * qy]), 2)
        wsum = torch.clamp(msum, min=1e-6)
        mx = sx_ / wsum
        my = sy_ / wsum
        ux = qx - mx[:, None]
        uy = qy - my[:, None]
        sxx, syy, sxy = fmath.seq_sum(
            torch.stack([wgt * ux * ux, wgt * uy * uy, wgt * ux * uy]), 2)
        new_ang = 0.5 * fmath.atan2_plain(2.0 * sxy, sxx - syy)
        return mx, my, new_ang, run, msum, torch.sum(run, dim=1)

    S = walk_steps
    ts_coarse = _make_ts(S // 2, 2.0 * 1.5, dev)
    ts_fine = _make_ts(S, 1.5, dev)
    for _ in range(refine_iters):
        cx, cy, d_ang, *_ = refine(cx, cy, d_ang, ts_coarse)
    _, _, _, run, msum, nsamp = refine(cx, cy, d_ang, ts_fine)
    dxf, dyf = torch.cos(d_ang), torch.sin(d_ang)
    t_run = torch.where(run > 0, ts_fine[None, :], torch.zeros_like(run))
    t_hi = torch.max(t_run, dim=1).values
    t_lo = torch.min(t_run, dim=1).values
    total_len = t_hi - t_lo
    mean_mag = msum / torch.clamp(nsamp, min=1.0)
    return torch.stack([cx + dxf * t_lo, cy + dyf * t_lo, cx + dxf * t_hi,
                        cy + dyf * t_hi, total_len, mean_mag, total_len * mean_mag], dim=1)


def lsd_refine(img: torch.Tensor, packed: torch.Tensor, ax: torch.Tensor,
               ay: torch.Tensor, walk_steps: int, refine_iters: int,
               angle_tol: float, grad_thresh: float) -> torch.Tensor:
    """Refinement of K anchors: float32 image [H, W], packed ridge plane
    int32 [H, W], anchor coordinates [K] -> [K, 7] float32 (sx, sy, ex,
    ey, total_len, mean_mag, response).

    CPU tensors -> plain version; CUDA tensors -> kernel 6 (or raise)."""
    if packed.device.type == "cpu":
        return lsd_refine_plain(img, packed, ax, ay, walk_steps, refine_iters,
                                angle_tol, grad_thresh)
    name = "lsd_refine"
    kernels.check_dtype(name, img, torch.float32)
    kernels.check_dtype(name, packed, torch.int32)
    if img.shape != packed.shape or ax.shape != ay.shape or walk_steps % 2:
        raise ValueError(f"{name}: shapes {tuple(img.shape)}, {tuple(packed.shape)}, "
                         f"{tuple(ax.shape)}, {tuple(ay.shape)}, steps {walk_steps}")
    ax, ay = ax.float().contiguous(), ay.float().contiguous()
    kernels.check_cuda(name, img, packed, ax, ay)
    h, w = img.shape
    K = ax.shape[0]
    out = torch.empty((K, REFINE_OUT), dtype=torch.float32, device=img.device)
    if K:
        kernels.launch(name, kernels.ptr(img), kernels.ptr(packed), h, w,
                       kernels.ptr(ax), kernels.ptr(ay), K, walk_steps, refine_iters,
                       _c(angle_tol), _c(0.5 * grad_thresh), kernels.ptr(out))
    return out


def _line_coeffs(eps: torch.Tensor) -> torch.Tensor:
    """Normalized infinite-line coefficients of [L, 4] segments."""
    one = torch.ones_like(eps[:, :1])
    l = torch.linalg.cross(torch.cat([eps[:, 0:2], one], 1), torch.cat([eps[:, 2:4], one], 1))
    nrm = torch.sqrt(l[:, 0] ** 2 + l[:, 1] ** 2)
    return l / torch.clamp(nrm, min=1e-9)[:, None]


def detect_lines(img: torch.Tensor, cfg: FrontendConfig) -> Lines:
    """One octave: dense support (kernel 5), anchors, refinement (kernel
    6), then the fragment merges, suppression and the top `n_lines`
    (kernel 26's `lsd_merge`)."""
    K = cfg.line_anchor_count
    ds = cfg.line_support_downsample
    best, packed = lsd_support(img, cfg.line_grad_threshold, cfg.line_angle_tol,
                               cfg.line_min_length, ds)
    # cell and border shrink with ds (one anchor per 16 full-res px); the
    # anchors go back to full resolution at the half pixels' centres
    axy, _, avalid = fast.select_keypoints(best, k=K, cell=max(16 // ds, 4), cell_cap=1,
                                           threshold=1.0, min_threshold=1.0,
                                           border=max(4 // ds, 2))
    axy = axy * ds + 0.5 * (ds - 1)
    ref = lsd_refine(img, packed, axy[:, 0].contiguous(), axy[:, 1].contiguous(),
                     cfg.line_walk_steps, cfg.line_refine_iters, cfg.line_angle_tol,
                     cfg.line_grad_threshold)
    return lsd_merge(ref, avalid, cfg.n_lines, cfg.line_min_length, cfg.line_angle_tol)


def lsd_merge_plain(ref: torch.Tensor, avalid: torch.Tensor, n_lines: int,
                    min_length: float, angle_tol: float) -> Lines:
    """The refined segments [K, 7] of one octave and their anchors' valid
    flags -> the top `n_lines` Lines: collinear fragments merged (the
    transitive closure of the [K, K] links by four squarings of 0/1
    float32 matrices, exact), duplicates suppressed pairwise, the stable
    top L by response (lsd.py:442-536), the directions by kernel 8."""
    K, L = ref.shape[0], n_lines
    dev = ref.device
    sx, sy, ex, ey, total_len, mean_mag, response = ref.unbind(1)
    ok = avalid & (total_len >= min_length)
    ar = torch.arange(K, device=dev)

    # merge collinear fragments: transitive closure of the [K, K] links
    mxm, mym = 0.5 * (sx + ex), 0.5 * (sy + ey)
    seg_dir = fmath.atan2(ey - sy, ex - sx)
    dxm, dym = torch.cos(seg_dir), torch.sin(seg_dir)
    nxm, nym = -dym, dxm

    def dperp(px_, py_):
        return torch.abs(nxm[:, None] * (px_[None, :] - mxm[:, None])
                         + nym[:, None] * (py_[None, :] - mym[:, None]))

    def proj_m(px_, py_):
        return (dxm[:, None] * (px_[None, :] - mxm[:, None])
                + dym[:, None] * (py_[None, :] - mym[:, None]))

    dp = torch.maximum(dperp(sx, sy), dperp(ex, ey))
    angclose_m = angle_diff(seg_dir[:, None], seg_dir[None, :]) < _c(0.1)
    tj_s, tj_e = proj_m(sx, sy), proj_m(ex, ey)
    tj_lo, tj_hi = torch.minimum(tj_s, tj_e), torch.maximum(tj_s, tj_e)
    half_len = 0.5 * total_len[:, None]
    gap = torch.maximum(tj_lo - half_len, -half_len - tj_hi)
    link = angclose_m & (dp < 2.5) & (gap < 5.0) & ok[:, None] & ok[None, :]
    link = link | link.T | torch.eye(K, dtype=torch.bool, device=dev)
    for _ in range(4):
        lf = link.float()
        link = (lf @ lf) > 0.0
    comp_resp = torch.where(link & ok[None, :], response[None, :],
                            torch.full_like(tj_lo, -1.0))
    rep = torch.argmax(comp_resp, dim=1)
    is_rep = (rep == ar) & ok
    memb = link & ok[None, :]
    inf = torch.full_like(tj_lo, float("inf"))
    t_lo_m = torch.min(torch.where(memb, tj_lo, inf), dim=1).values
    t_hi_m = torch.max(torch.where(memb, tj_hi, -inf), dim=1).values
    sx = torch.where(is_rep, mxm + dxm * t_lo_m, sx)
    sy = torch.where(is_rep, mym + dym * t_lo_m, sy)
    ex = torch.where(is_rep, mxm + dxm * t_hi_m, ex)
    ey = torch.where(is_rep, mym + dym * t_hi_m, ey)
    total_len = torch.where(is_rep, t_hi_m - t_lo_m, total_len)
    response = torch.where(is_rep, total_len * mean_mag, response)
    ok = is_rep
    seg_ang = jnp_mod(fmath.atan2(ey - sy, ex - sx) + HALF_PI, PI) - HALF_PI

    # pairwise suppression of collinear duplicates
    mx, my = 0.5 * (sx + ex), 0.5 * (sy + ey)
    nxl, nyl = -torch.sin(seg_ang), torch.cos(seg_ang)
    dmid = torch.abs(nxl[:, None] * (mx[None, :] - mx[:, None])
                     + nyl[:, None] * (my[None, :] - my[:, None]))
    angclose = angle_diff(seg_ang[:, None], seg_ang[None, :]) < _c(angle_tol)
    dxl, dyl = torch.cos(seg_ang), torch.sin(seg_ang)

    def proj(px_, py_):
        return (dxl[:, None] * (px_[None, :] - mx[:, None])
                + dyl[:, None] * (py_[None, :] - my[:, None]))

    t_s, t_e = proj(sx, sy), proj(ex, ey)
    lo, hi = torch.minimum(t_s, t_e), torch.maximum(t_s, t_e)
    half_i = 0.5 * total_len[:, None]
    overlap = torch.minimum(hi, half_i) - torch.maximum(lo, -half_i)
    stronger = (response[:, None] > response[None, :]) | (
        (response[:, None] == response[None, :]) & (ar[:, None] < ar[None, :]))
    suppress = (angclose & (dmid < 3.0) & (overlap > -4.0) & stronger
                & ok[:, None] & ok[None, :])
    keep = ok & ~torch.any(suppress, dim=0)

    sel_resp = torch.where(keep, response, torch.full_like(response, float("-inf")))
    top_r, top_i = stable_topk(sel_resp, L)
    valid = torch.isfinite(top_r)
    eps = torch.stack([sx[top_i], sy[top_i], ex[top_i], ey[top_i]], dim=-1)
    return Lines(endpoints=eps, line2d=_line_coeffs(eps),
                 response=torch.where(valid, top_r, torch.zeros_like(top_r)),
                 angle=seg_ang[top_i], valid=valid,
                 octave=torch.zeros((L,), dtype=torch.int32, device=dev))


class _LsdWork(ctypes.Structure):
    """Kernel 26's description of one call (`struct Work` in
    csrc/lsd_merge.cu)."""
    _fields_ = ([("K", ctypes.c_int), ("L", ctypes.c_int), ("min_length", ctypes.c_float),
                 ("angle_tol", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "ref", "avalid", "ep0", "ep1", "resp0", "resp1", "ang0", "ang1", "valid0",
                    "valid1", "endpoints", "line2d", "response", "angle", "valid", "octave",
                    "trace")])


def _merge_launch(entry: str, L: int, inputs: dict, **scalars) -> Lines:
    """Launch kernel 26's `entry` on CUDA tensors `inputs` (the Work's
    pointer fields, float32 but for the bool valid flags): new Lines of L."""
    for name, t in inputs.items():
        kernels.check_dtype(f"{entry} ({name})", t,
                            torch.bool if "valid" in name else torch.float32)
    ins = {name: t.contiguous() for name, t in inputs.items()}
    dev = kernels.check_cuda(entry, *ins.values())
    out = Lines(endpoints=torch.empty((L, 4), dtype=torch.float32, device=dev),
                line2d=torch.empty((L, 3), dtype=torch.float32, device=dev),
                response=torch.empty((L,), dtype=torch.float32, device=dev),
                angle=torch.empty((L,), dtype=torch.float32, device=dev),
                valid=torch.empty((L,), dtype=torch.bool, device=dev),
                octave=torch.empty((L,), dtype=torch.int32, device=dev))
    work = _LsdWork(L=L, **scalars, **{k: t.data_ptr() for k, t in ins.items()},
                    **{k: getattr(out, k).data_ptr() for k in Lines._fields})
    kernels.launch(entry, ctypes.addressof(work))
    return out


def lsd_merge(ref: torch.Tensor, avalid: torch.Tensor, n_lines: int, min_length: float,
              angle_tol: float) -> Lines:
    """The merges of one octave (`lsd_merge_plain`). CPU tensors -> plain
    version; CUDA tensors -> kernel 26's `lsd_merge` (or raise), one
    cluster launch that writes no [K, K] plane."""
    if ref.device.type == "cpu":
        return lsd_merge_plain(ref, avalid, n_lines, min_length, angle_tol)
    K = ref.shape[0]
    if ref.shape != (K, REFINE_OUT) or avalid.shape != (K,) or not 1 <= n_lines <= K \
            or K > MERGE_MAX_K:
        raise ValueError(f"lsd_merge: shapes {tuple(ref.shape)}, {tuple(avalid.shape)}, "
                         f"{n_lines} lines (1 <= L <= K <= {MERGE_MAX_K})")
    return _merge_launch("lsd_merge", n_lines, {"ref": ref, "avalid": avalid}, K=K,
                         min_length=_c(min_length), angle_tol=_c(angle_tol))


def half_octave(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample: the reference's reduce_window sum times 0.25,
    the four values added in row-major window order."""
    h, w = img.shape
    hs, ws = h // 2, w // 2
    v = img[:2 * hs, :2 * ws].reshape(hs, 2, ws, 2)
    return 0.25 * (((v[:, 0, :, 0] + v[:, 0, :, 1]) + v[:, 1, :, 0]) + v[:, 1, :, 1])


def detect_lines_pyramid(img: torch.Tensor, cfg: FrontendConfig) -> Lines:
    """Two octaves (full resolution and the 2x2 half octave with half the
    anchors and walk steps), octave-1 duplicates of octave-0 segments
    suppressed, then the top `n_lines` by response (lsd.py:551-638;
    kernel 26's `lsd_octave_merge`)."""
    l0 = detect_lines(img, cfg)
    cfg_h = dataclasses.replace(cfg, line_anchor_count=max(cfg.line_anchor_count // 2, 32),
                                line_walk_steps=max(cfg.line_walk_steps // 2, 8))
    l1 = detect_lines(half_octave(img).contiguous(), cfg_h)
    return lsd_octave_merge(l0, l1, cfg.line_angle_tol)


def lsd_octave_merge_plain(l0: Lines, l1: Lines, angle_tol: float) -> Lines:
    """Octave 0's and octave 1's Lines (L each; octave 1 at half
    resolution) -> the top L of both: octave-1 lines that duplicate an
    octave-0 line dropped, the rest ranked by response (stable)."""
    L = l0.valid.shape[0]
    dev = l0.valid.device
    ep1 = l1.endpoints * 2.0 + 0.5
    resp1 = torch.where(l1.valid, l1.response * 2.0, torch.zeros_like(l1.response))
    eps = torch.cat([l0.endpoints, ep1])
    resp = torch.cat([l0.response, resp1])
    ang = torch.cat([l0.angle, l1.angle])
    valid = torch.cat([l0.valid, l1.valid])
    octv = torch.cat([torch.zeros((L,), dtype=torch.int32, device=dev),
                      torch.ones((L,), dtype=torch.int32, device=dev)])

    sx, sy, ex, ey = eps.unbind(1)
    mx, my = 0.5 * (sx + ex), 0.5 * (sy + ey)
    seg_len = fmath.hypot(ex - sx, ey - sy)
    nxl, nyl = -torch.sin(ang), torch.cos(ang)
    dmid = torch.abs(nxl[:, None] * (mx[None, :] - mx[:, None])
                     + nyl[:, None] * (my[None, :] - my[:, None]))
    angclose = angle_diff(ang[:, None], ang[None, :]) < _c(angle_tol)
    dxl, dyl = torch.cos(ang), torch.sin(ang)

    def proj(px_, py_):
        return (dxl[:, None] * (px_[None, :] - mx[:, None])
                + dyl[:, None] * (py_[None, :] - my[:, None]))

    t_s, t_e = proj(sx, sy), proj(ex, ey)
    lo_t, hi_t = torch.minimum(t_s, t_e), torch.maximum(t_s, t_e)
    half_i = 0.5 * seg_len[:, None]
    overlap = torch.minimum(hi_t, half_i) - torch.maximum(lo_t, -half_i)
    dup = angclose & (dmid < 4.0) & (overlap > 0.0) & valid[:, None] & valid[None, :]
    is0 = octv == 0
    keep = valid & ~torch.any(dup & is0[:, None] & (~is0)[None, :], dim=0)
    sel_resp = torch.where(keep, resp, torch.full_like(resp, float("-inf")))
    top_r, top_i = stable_topk(sel_resp, L)
    out_valid = torch.isfinite(top_r)
    out_eps = eps[top_i]
    return Lines(endpoints=out_eps, line2d=_line_coeffs(out_eps),
                 response=torch.where(out_valid, top_r, torch.zeros_like(top_r)),
                 angle=ang[top_i], valid=out_valid, octave=octv[top_i])


def lsd_octave_merge(l0: Lines, l1: Lines, angle_tol: float) -> Lines:
    """The cross-octave merge (`lsd_octave_merge_plain`). CPU tensors ->
    plain version; CUDA tensors -> kernel 26's `lsd_octave_merge` (or
    raise)."""
    if l0.valid.device.type == "cpu":
        return lsd_octave_merge_plain(l0, l1, angle_tol)
    L = l0.valid.shape[0]
    if l1.valid.shape[0] != L or 2 * L > MERGE_MAX_K:
        raise ValueError(f"lsd_octave_merge: {L} and {l1.valid.shape[0]} lines "
                         f"(equal, 2L <= {MERGE_MAX_K})")
    return _merge_launch("lsd_octave_merge", L, {
        "ep0": l0.endpoints, "ep1": l1.endpoints, "resp0": l0.response,
        "resp1": l1.response, "ang0": l0.angle, "ang1": l1.angle, "valid0": l0.valid,
        "valid1": l1.valid}, K=2 * L, min_length=0.0, angle_tol=_c(angle_tol))


__all__ = ["Lines", "gradients", "angle_diff", "lsd_support", "lsd_support_plain",
           "lsd_refine", "lsd_refine_plain", "lsd_merge", "lsd_merge_plain",
           "lsd_octave_merge", "lsd_octave_merge_plain", "detect_lines",
           "detect_lines_pyramid", "half_octave", "REFINE_OUT"]
