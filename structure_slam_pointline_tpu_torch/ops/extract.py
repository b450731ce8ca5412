"""Full ORB front-end: pyramid -> FAST -> select -> orient -> describe.

Counterpart of structure_slam_pointline_tpu/ops/extract.py. Maps a
grayscale [H, W] image to a fixed-capacity keypoint set:

    xy [K, 2]      level-0 pixel coords (x, y), float32
    response [K]
    octave [K]     pyramid level, int32
    angle [K]      radians
    desc [K, 8]    packed 256-bit descriptors (int32 bit patterns)
    valid [K]      bool mask (padding slots are False)

The levels with a keypoint budget go through the kernels once a frame
each, all levels in one call: kernel 25 (the bf16 pyramid and blur), kernel
1 (FAST + NMS, the maps as views of one buffer), kernel 11 (the selection,
its concatenated buffers: the levels' budgets one after another) and
kernel 2 (ORB), which reads kernel 11's xy and writes the Keypoints
columns itself (xy * the level's scale, the octave, angle and
descriptor); response and valid are kernel 11's own buffers. On the card
a frame is four C calls and no torch op between them. On the CPU each
step is its plain version (per-level loops and concatenations).

`extract_orb` also maps a [B, H, W] stack to Keypoints with a leading B
axis, each frame's equal to its own call's: the same four calls, each
covering all B frames (the batch entries).
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
    """Grayscale [H, W] float32 in [0, 255] -> fixed-capacity Keypoints (a
    [B, H, W] stack -> Keypoints with a leading B axis)."""
    k_total = n_keypoints or cfg.n_keypoints
    budgets = level_budgets(k_total, cfg.n_levels, cfg.scale_factor)
    scales = pyramid.level_scales(cfg.n_levels, cfg.scale_factor)
    levels, blurred = pyramid.build_blurred_pyramid(
        img.to(torch.bfloat16), cfg.n_levels, cfg.scale_factor, cfg.blur_sigma)

    lvs = [lv for lv in range(cfg.n_levels) if budgets[lv] > 0]
    ks = [budgets[lv] for lv in lvs]
    maps = fast.fast_score_nms_levels([levels[lv] for lv in lvs])
    xy, resp, valid = fast.select_keypoints_levels(
        [(nms, raw) for raw, nms in maps], ks=ks, cell=cfg.cell_size, cell_cap=8,
        threshold=cfg.fast_threshold, min_threshold=cfg.fast_min_threshold,
        border=orb.PATCH_RADIUS + 1, concat=True)
    angle, desc, xy0, octave = orb.orient_and_describe_levels(
        [blurred[lv] for lv in lvs], xy, ks, [float(scales[lv]) for lv in lvs], lvs)
    return Keypoints(xy=xy0, response=resp, octave=octave, angle=angle, desc=desc,
                     valid=valid)


__all__ = ["Keypoints", "level_budgets", "extract_orb"]
