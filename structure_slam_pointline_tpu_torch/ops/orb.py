"""Oriented BRIEF: bilinear patch, IC angle, rotated 256-tap test (kernel 2).

Counterpart of structure_slam_pointline_tpu/ops/orb.py.

`orient_and_describe` is the wrapper of CUDA kernel 2 (csrc/orb.cu),
which replaces the reference's `orient_and_describe` (orb.py:227) and
its pieces `gather_patches` (:119), `ic_angle` (:177) and `describe`
(:191). The reference gathers [K, 31, 31] patches with two one-hot
matmuls and evaluates all 64 rotation banks as one matmul; the kernel
reads the blurred bf16 level directly, one keypoint per warp.
`orient_and_describe_plain` is the plain version; both reproduce the
reference's numerics:

- bilinear rows rounded to bf16, then columns rounded to bf16, with
  weights (1 - f) and f themselves bf16 (f = frac(xy) rounded to bf16);
- IC moments over the r = 15 disc accumulated in float32, angle by atan2;
- bank = round(angle / 2pi * 64) mod 64 (round half to even);
- bit = I(p0) < I(p1) on the bank's rotated integer taps, all inside the
  central 27 x 27 window; 256 bits packed little-endian into 8 words,
  stored as int32 bit patterns.

`_make_pattern(seed=7)` and `_rotated_tables()` are copies of the
reference's tables (a test holds them equal).
"""

from __future__ import annotations

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
    """(angle [K] float32, desc [K, 8] int32) for one blurred bf16 level."""
    patches = gather_patches(img_blur, xy)
    ang = ic_angle(patches)
    return ang, describe(patches, ang)


def orient_and_describe(img_blur: torch.Tensor, xy: torch.Tensor):
    """CPU tensor -> plain version; CUDA tensor -> kernel 2 (or raise)."""
    if img_blur.dim() != 2 or xy.dim() != 2 or xy.shape[1] != 2:
        raise ValueError("orient_and_describe: expects [H, W] and [K, 2]")
    if img_blur.device.type == "cpu":
        return orient_and_describe_plain(img_blur, xy)
    kernels.check_dtype("orient_and_describe", img_blur, torch.bfloat16)
    kernels.check_dtype("orient_and_describe", xy, torch.float32)
    dev = kernels.check_cuda("orient_and_describe", img_blur, xy)
    h, w = img_blur.shape
    if h < PATCH + 2 or w < PATCH + 2:
        raise ValueError("orient_and_describe: level smaller than a patch")
    k = xy.shape[0]
    angle = torch.empty((k,), dtype=torch.float32, device=dev)
    desc = torch.empty((k, 8), dtype=torch.int32, device=dev)
    if k == 0:
        return angle, desc
    tables = _tables_on(dev)
    kernels.launch("orb_describe", kernels.ptr(img_blur), h, w, kernels.ptr(xy), k,
                   kernels.ptr(tables), kernels.ptr(angle), kernels.ptr(desc))
    return angle, desc


__all__ = [
    "PATCH_RADIUS", "N_PAIRS", "N_ROT", "gather_patches", "ic_angle",
    "rotation_bank", "describe", "unpack_bits", "orient_and_describe",
    "orient_and_describe_plain",
]
