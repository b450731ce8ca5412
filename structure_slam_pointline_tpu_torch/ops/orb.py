"""Oriented BRIEF: bilinear patch, IC angle, rotated 256-tap test (kernel 2).

Counterpart of structure_slam_pointline_tpu/ops/orb.py.

`orient_and_describe_levels` is the wrapper of CUDA kernel 2 (csrc/orb.cu)
for a frame: one launch over every level's keypoints, xy as kernel 11
writes it (the levels' budgets one after another), writing the frame's
Keypoints columns: angle, descriptor, the level-0 coordinates xy * scale
and the octave. A keypoint finds its level from the prefix of the
budgets; the wrapper keeps one ctypes level table per (shapes, budgets,
scales, octaves, stream) and fills in only the pointers on each call.
`orient_and_describe_levels_plain` is its plain version: the per-level
loop, the products, fills and concatenations. `orient_and_describe` is a
one-level call of the same kernel (the reference's `orient_and_describe`,
orb.py:227). The kernel replaces that function and its pieces
`gather_patches` (:119), `ic_angle` (:177) and `describe` (:191): the
reference gathers [K, 31, 31] patches with two one-hot matmuls and
evaluates all 64 rotation banks as one matmul; the kernel reads the
blurred bf16 level directly, one keypoint per warp.
`orient_and_describe_plain` is the plain version of one level; all of
them reproduce the reference's numerics:

- bilinear rows rounded to bf16, then columns rounded to bf16, with
  weights (1 - f) and f themselves bf16 (f = frac(xy) rounded to bf16);
- IC moments over the r = 15 disc accumulated in float32, angle by atan2;
- bank = round(angle / 2pi * 64) mod 64 (round half to even);
- bit = I(p0) < I(p1) on the bank's rotated integer taps, all inside the
  central 27 x 27 window; 256 bits packed little-endian into 8 words,
  stored as int32 bit patterns.

`_make_pattern(seed=7)` and `_rotated_tables()` are copies of the
reference's tables (a test holds them equal).

Both entries also take [B, H, W] stacks and [B, K, 2] keypoints (the
data-parallel frontend): kernel 2's batch entry, one launch for every
level of all B frames, each frame bit-equal to its single-frame call; the
plain versions run a stack frame by frame.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels

PATCH_RADIUS = 15
PATCH = 2 * PATCH_RADIUS + 1  # 31
N_PAIRS = 256
N_ROT = 64
_MAX_OFF = 13
_TAP = 2 * _MAX_OFF + 1  # 27
MAX_LEVELS = 16          # kernel 2's level table


def _make_pattern(seed: int = 7) -> np.ndarray:
    """[N_PAIRS, 2, 2] float32 (pair, point, (dx, dy)): isotropic Gaussian
    taps (sigma = patch/5) inside the |offset| <= 13 disc."""
    g = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = []
    while len(pts) < N_PAIRS * 2:
        p = g.normal(0.0, sigma, size=2)
        if np.hypot(*p) <= _MAX_OFF:
            pts.append(p)
    return np.asarray(pts[: N_PAIRS * 2], np.float32).reshape(N_PAIRS, 2, 2)


@functools.lru_cache(maxsize=None)
def _rotated_tables() -> np.ndarray:
    """[N_ROT, N_PAIRS, 2, 2] int32 rotated integer offsets (dx, dy)."""
    pat = _make_pattern()
    tables = []
    for r in range(N_ROT):
        a = 2.0 * np.pi * r / N_ROT
        ca, sa = np.cos(a), np.sin(a)
        R = np.asarray([[ca, -sa], [sa, ca]], np.float32)
        tables.append(np.round(pat @ R.T).astype(np.int32))
    t = np.stack(tables)
    assert np.abs(t).max() <= _MAX_OFF
    return t


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> torch.Tensor:
    """Rotated taps as int8 [N_ROT, N_PAIRS, 4] = (dx0, dy0, dx1, dy1)."""
    t = _rotated_tables().reshape(N_ROT, N_PAIRS, 4).astype(np.int8)
    return torch.from_numpy(t).to(device)


_yy, _xx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
_DISC = (_yy ** 2 + _xx ** 2 <= PATCH_RADIUS ** 2)


def gather_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[K, 31, 31] bilinear patches (image dtype) at sub-pixel xy [K, 2]."""
    h, w = img.shape
    dt = img.dtype
    dev = img.device
    x = torch.clamp(xy[:, 0].float(), PATCH_RADIUS, w - PATCH_RADIUS - 2)
    y = torch.clamp(xy[:, 1].float(), PATCH_RADIUS, h - PATCH_RADIUS - 2)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).to(dt)
    fy = (y - y0).to(dt)
    one = torch.ones((), dtype=dt, device=dev)
    x0 = x0.long()
    y0 = y0.long()
    offs = torch.arange(-PATCH_RADIUS, PATCH_RADIUS + 1, device=dev)
    ridx = y0[:, None] + offs[None, :]                        # [K, 31]
    # columns x0-15 .. x0+16 of rows y and y+1: [K, 31, 32]
    cidx = x0[:, None] + torch.arange(-PATCH_RADIUS, PATCH_RADIUS + 2, device=dev)
    imf = img.float()
    top = imf[ridx[:, :, None], cidx[:, None, :]]
    bot = imf[ridx[:, :, None] + 1, cidx[:, None, :]]
    wy0 = (one - fy).float()[:, None, None]
    wy1 = fy.float()[:, None, None]
    rows = (wy0 * top + wy1 * bot).to(dt).float()             # [K, 31, 32]
    wx0 = (one - fx).float()[:, None, None]
    wx1 = fx.float()[:, None, None]
    return (wx0 * rows[:, :, :-1] + wx1 * rows[:, :, 1:]).to(dt)


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle [K] (float32 moment sums over the disc)."""
    dev = patches.device
    p = patches.float().reshape(patches.shape[0], -1)
    mx = torch.from_numpy((_xx * _DISC).reshape(-1).astype(np.float32)).to(dev)
    my = torch.from_numpy((_yy * _DISC).reshape(-1).astype(np.float32)).to(dev)
    m0 = (p * mx).sum(1)
    m1 = (p * my).sum(1)
    return torch.atan2(m1, m0)


def rotation_bank(angles: torch.Tensor) -> torch.Tensor:
    return torch.remainder(
        torch.round(angles / (2.0 * math.pi) * N_ROT).long(), N_ROT)


def describe(patches: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[K, 31, 31] patches + [K] angles -> packed int32 [K, 8]."""
    k = patches.shape[0]
    dev = patches.device
    bank = rotation_bank(angles)                                  # [K]
    tab = torch.from_numpy(_rotated_tables()).to(dev).long()      # [64, 256, 2, 2]
    t = tab[bank]                                                 # [K, 256, 2, 2]
    c = PATCH_RADIUS
    kk = torch.arange(k, device=dev)[:, None]
    p = patches.float()
    i0 = p[kk, c + t[..., 0, 1], c + t[..., 0, 0]]
    i1 = p[kk, c + t[..., 1, 1], c + t[..., 1, 0]]
    bits = (i0 < i1).long().reshape(k, 8, 32)
    words = (bits << torch.arange(32, device=dev)).sum(-1)        # [K, 8] < 2^32
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """int32 [..., 8] -> {0, 1} int8 [..., 256]."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 256).to(torch.int8)


def orient_and_describe_plain(img_blur: torch.Tensor, xy: torch.Tensor):
    """(angle [K] float32, desc [K, 8] int32) for one blurred bf16 level (a
    stack frame by frame: [B, K], [B, K, 8])."""
    if img_blur.dim() == 3:
        outs = [orient_and_describe_plain(im, p) for im, p in zip(img_blur, xy)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    patches = gather_patches(img_blur, xy)
    ang = ic_angle(patches)
    return ang, describe(patches, ang)


def orient_and_describe_levels_plain(blurred: list, xy: torch.Tensor, ks: list,
                                     scales: list, octaves: list):
    """The per-level plain loop and the concatenation: blurred bf16 levels
    ([H, W] each, or [B, H, W] stacks), xy [K, 2] (or [B, K, 2]) in level
    coordinates with the levels' keypoints one after another (ks of them
    for each level, K their sum) -> (angle [K], desc [K, 8], xy0 [K, 2]
    = xy * the level's scale, octave [K] int32), each with the leading B
    axis of a stack."""
    lead = tuple(xy.shape[:-2])
    parts, o = [], 0
    for bl, k, s, lv in zip(blurred, ks, scales, octaves):
        p = xy[..., o:o + k, :]
        ang, desc = orient_and_describe_plain(bl, p.contiguous())
        octv = torch.full(lead + (k,), int(lv), dtype=torch.int32, device=xy.device)
        parts.append((ang, desc, p * float(s), octv))
        o += k
    return tuple(torch.cat([q[i] for q in parts], dim=len(lead)) for i in range(4))


class _OrbWork(ctypes.Structure):
    """Kernel 2's description of one call (`struct Work` in csrc/orb.cu)."""
    _fields_ = ([("img", ctypes.c_void_p * MAX_LEVELS)]
                + [(n, ctypes.c_int * MAX_LEVELS) for n in ("h", "w", "first", "octave")]
                + [("scale", ctypes.c_float * MAX_LEVELS)]
                + [(n, ctypes.c_int) for n in ("L", "B", "K")]
                + [(n, ctypes.c_void_p) for n in ("xy", "tables", "angle", "desc", "xy0",
                                                  "oct")])


# (level shapes, keypoint shape, budgets, scales, octaves, device, stream) ->
# the work with its table filled
_ORB_PLANS: dict = {}


def _orb_plan(key):
    what = "orient_and_describe"
    shapes, xy_shape, ks, scales, octaves = key[:5]
    lead = xy_shape[:-2]
    L = len(shapes)
    if not 1 <= L <= MAX_LEVELS or len(ks) != L or len(scales) != L or len(octaves) != L:
        raise ValueError(f"{what}: {L} levels (1 to {MAX_LEVELS}), {len(ks)} budgets, "
                         f"{len(scales)} scales, {len(octaves)} octaves")
    if len(xy_shape) != len(shapes[0]) or xy_shape[-1] != 2 or sum(ks) != xy_shape[-2] \
            or min(ks) < 0 or any(len(sh) != len(xy_shape) or sh[:-2] != lead
                                  for sh in shapes):
        raise ValueError(f"{what}: expects [H, W] levels and [K, 2] keypoints, or [B, H, W] "
                         f"and [B, K, 2], K the sum of the budgets; got {list(shapes)}, "
                         f"{xy_shape}, {list(ks)}")
    if any(min(sh[-2:]) < PATCH + 2 for sh in shapes):
        raise ValueError(f"{what}: level smaller than a patch")
    B = lead[0] if lead else 1
    if not 1 <= B <= 65535:
        raise ValueError(f"{what}: {B} frames, the kernel takes 1 to 65535")
    work = _OrbWork(L=L, B=B, K=xy_shape[-2])
    first = np.cumsum([0] + list(ks))
    for li, sh in enumerate(shapes):
        work.h[li], work.w[li] = sh[-2], sh[-1]
        work.first[li], work.octave[li], work.scale[li] = int(first[li]), octaves[li], scales[li]
    _ORB_PLANS[key] = work
    return work


def _launch(blurred: list, xy: torch.Tensor, ks, scales, octaves, levels_out: bool):
    """Kernel 2 over the levels' keypoints, one launch: (angle, desc) and,
    with `levels_out`, (xy0, octave)."""
    what = "orient_and_describe"
    for bl in blurred:
        kernels.check_dtype(what, bl, torch.bfloat16)
    kernels.check_dtype(what, xy, torch.float32)
    dev = kernels.check_cuda(what, *blurred, xy)
    lead, k = tuple(xy.shape[:-2]), xy.shape[-2]
    angle = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    desc = torch.empty(lead + (k, 8), dtype=torch.int32, device=dev)
    xy0 = torch.empty_like(xy) if levels_out else None
    octave = torch.empty(lead + (k,), dtype=torch.int32, device=dev) if levels_out else None
    key = (tuple(tuple(bl.shape) for bl in blurred), tuple(xy.shape), tuple(int(v) for v in ks),
           tuple(float(v) for v in scales), tuple(int(v) for v in octaves), dev,
           torch.cuda.current_stream(dev).cuda_stream)
    work = _ORB_PLANS.get(key) or _orb_plan(key)
    if k == 0:
        return angle, desc, xy0, octave
    for li, bl in enumerate(blurred):
        work.img[li] = bl.data_ptr()
    work.xy, work.tables = xy.data_ptr(), _tables_on(dev).data_ptr()
    work.angle, work.desc = angle.data_ptr(), desc.data_ptr()
    work.xy0 = xy0.data_ptr() if levels_out else None
    work.oct = octave.data_ptr() if levels_out else None
    kernels.launch("orb_describe_batch" if lead else "orb_describe", ctypes.addressof(work),
                   entry="orb_describe")
    return angle, desc, xy0, octave


def orient_and_describe_levels(blurred: list, xy: torch.Tensor, ks: list, scales: list,
                               octaves: list):
    """`orient_and_describe_levels_plain`'s result: every level's keypoints
    of a frame (or of a [B, H, W] stack) in one call, xy as kernel 11
    writes it (the levels one after another). CPU tensors -> plain
    version; CUDA tensors -> kernel 2, one launch (its batch entry for
    stacks), or raise."""
    if xy.device.type == "cpu":
        return orient_and_describe_levels_plain(blurred, xy, ks, scales, octaves)
    return _launch(blurred, xy, ks, scales, octaves, True)


def orient_and_describe(img_blur: torch.Tensor, xy: torch.Tensor):
    """[H, W] bf16 level and [K, 2] keypoints, or a [B, H, W] stack and [B,
    K, 2] -> (angle, desc). CPU tensor -> plain version; CUDA tensor ->
    kernel 2, one launch of one level (its batch entry for a stack), or
    raise."""
    nd = img_blur.dim()
    if nd not in (2, 3) or xy.dim() != nd or xy.shape[-1] != 2 \
            or xy.shape[:-2] != img_blur.shape[:-2] or img_blur.shape[0] < 1:
        raise ValueError("orient_and_describe: expects [H, W] and [K, 2], or [B, H, W] and "
                         "[B, K, 2]")
    if img_blur.device.type == "cpu":
        return orient_and_describe_plain(img_blur, xy)
    return _launch([img_blur], xy, [xy.shape[-2]], [1.0], [0], False)[:2]


__all__ = [
    "PATCH_RADIUS", "N_PAIRS", "N_ROT", "gather_patches", "ic_angle",
    "rotation_bank", "describe", "unpack_bits", "orient_and_describe",
    "orient_and_describe_plain", "orient_and_describe_levels",
    "orient_and_describe_levels_plain",
]
