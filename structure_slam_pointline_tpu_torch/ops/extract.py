"""Full ORB front-end: pyramid -> FAST -> select -> orient -> describe.

Counterpart of structure_slam_pointline_tpu/ops/extract.py. Maps a
grayscale [H, W] image to a fixed-capacity keypoint set:

    xy [K, 2]      level-0 pixel coords (x, y), float32
    response [K]
    octave [K]     pyramid level, int32
    angle [K]      radians
    desc [K, 8]    packed 256-bit descriptors (int32 bit patterns)
    valid [K]      bool mask (padding slots are False)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import FrontendConfig
from structure_slam_pointline_tpu_torch.ops import fast, orb, pyramid


class Keypoints(NamedTuple):
    xy: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def level_budgets(n_total: int, n_levels: int, scale_factor: float) -> list[int]:
    q = 1.0 / scale_factor
    base = n_total * (1.0 - q) / (1.0 - q ** n_levels)
    budgets = [int(round(base * q ** lv)) for lv in range(n_levels)]
    budgets[-1] = max(n_total - sum(budgets[:-1]), 0)
    return budgets


def extract_orb(img: torch.Tensor, cfg: FrontendConfig,
                n_keypoints: int | None = None) -> Keypoints:
    """Grayscale [H, W] float32 in [0, 255] -> fixed-capacity Keypoints."""
    k_total = n_keypoints or cfg.n_keypoints
    budgets = level_budgets(k_total, cfg.n_levels, cfg.scale_factor)
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale_factor)
    levels, blurred = pyramid.build_blurred_pyramid(
        img.to(torch.bfloat16), cfg.n_levels, cfg.scale_factor, cfg.blur_sigma)

    lvs = [lv for lv in range(cfg.n_levels) if budgets[lv] > 0]
    score_raw = []
    for lv in lvs:
        raw, nms = fast.fast_score_nms(levels[lv])
        score_raw.append((nms, raw))
    sels = fast.select_keypoints_levels(
        score_raw, ks=[budgets[lv] for lv in lvs], cell=cfg.cell_size,
        cell_cap=8, threshold=cfg.fast_threshold,
        min_threshold=cfg.fast_min_threshold, border=orb.PATCH_RADIUS + 1)
    parts = []
    for lv, (xy, resp, valid) in zip(lvs, sels):
        ang, desc = orb.orient_and_describe(blurred[lv], xy.contiguous())
        xy0 = xy * float(scales[lv])
        octv = torch.full((budgets[lv],), lv, dtype=torch.int32, device=img.device)
        parts.append((xy0, resp, octv, ang, desc, valid))
    cat = lambda i: torch.cat([p[i] for p in parts])  # noqa: E731
    return Keypoints(xy=cat(0), response=cat(1), octave=cat(2), angle=cat(3),
                     desc=cat(4), valid=cat(5))


__all__ = ["Keypoints", "level_budgets", "extract_orb"]
