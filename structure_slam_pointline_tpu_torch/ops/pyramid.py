"""Image pyramid + Gaussian blur in bfloat16.

Counterpart of structure_slam_pointline_tpu/ops/pyramid.py. Two parity
points, both checked against the JAX package on the CPU:

- Levels come from `jax.image.resize(..., "bilinear")`, which ANTIALIASES
  when it downscales (triangle kernel stretched by 1/scale) and resizes
  each level from the previous one. `_resize_weights` rebuilds the same
  per-axis weight matrices (float32, then cast to bf16 like the
  reference), and `resize_bilinear` contracts rows first, rounding to
  bf16 after each contraction, which is the order XLA takes.
- `blur` sums 7 rolled taps one after another in bf16, with the tap
  weights themselves rounded to bf16 (a Python-float weight times a bf16
  array is a bf16 product in JAX). Rolls wrap at the borders.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(height: int, width: int, n_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    """Static (H, W) per level (level 0 = full resolution)."""
    shapes = []
    for lv in range(n_levels):
        s = scale_factor ** lv
        shapes.append((max(int(round(height / s)), 32),
                       max(int(round(width / s)), 32)))
    return shapes


def level_scales(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor ** lv for lv in range(n_levels)], np.float32)


def gaussian_kernel1d(sigma: float, radius: int = 3) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """[m, n] float32 antialiased triangle weights of jax.image.resize
    (scale = n/m, translation 0)."""
    f32 = np.float32
    # jax.image.resize takes scale = n / m as a Python float and inverts it
    # in double precision before the float32 ops see it
    inv = f32(1.0 / (n / m))
    kernel_scale = max(inv, f32(1.0))
    sample = ((np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)).astype(f32)
    x = (np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _bf16_weights(m: int, n: int, device) -> torch.Tensor:
    w = torch.from_numpy(_resize_weights(m, n)).to(torch.bfloat16)
    return w.to(device=device, dtype=torch.float32)


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """bf16 [H, W] -> bf16 `shape`, rows contracted first."""
    h, w = img.shape
    wr = _bf16_weights(h, shape[0], img.device)      # [H, h']
    wc = _bf16_weights(w, shape[1], img.device)      # [W, w']
    rows = (wr.T @ img.float()).to(torch.bfloat16)   # [h', W]
    return (rows.float() @ wc).to(torch.bfloat16)


def blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable 7-tap Gaussian via rolled adds, every op rounded to the
    image dtype (bf16 on the main path)."""
    k = gaussian_kernel1d(sigma, radius)
    wts = [torch.tensor(float(w), dtype=img.dtype, device=img.device) for w in k]
    x = torch.zeros_like(img)
    for i, w in enumerate(wts):
        x = x + w * torch.roll(img, i - radius, dims=0)
    y = torch.zeros_like(img)
    for i, w in enumerate(wts):
        y = y + w * torch.roll(x, i - radius, dims=1)
    return y


def build_pyramid(img: torch.Tensor, n_levels: int = 8,
                  scale_factor: float = 1.2) -> List[torch.Tensor]:
    """Grayscale [H, W] -> list of per-level images, each resized from
    the previous one."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[lv]))
    return levels


def build_blurred_pyramid(img: torch.Tensor, n_levels: int = 8,
                          scale_factor: float = 1.2, sigma: float = 2.0):
    levels = build_pyramid(img, n_levels, scale_factor)
    return levels, [blur(lv, sigma) for lv in levels]


__all__ = ["level_shapes", "level_scales", "blur", "resize_bilinear",
           "build_pyramid", "build_blurred_pyramid"]
