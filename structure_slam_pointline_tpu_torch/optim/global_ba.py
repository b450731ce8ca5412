"""Global bundle adjustment over the whole keyframe set.

Counterpart of structure_slam_pointline_tpu/optim/global_ba.py (the
reference's GlobalBundleAdjustemnt, run after a loop correction): local
BA's solver (kernel 12, optim/local_ba.py) at a wider shape, 64
keyframes, 16384 points and 1024 lines per window, every valid keyframe
free but keyframe 0. A map of more than one window is swept in
overlapping tiles, each anchored by a fixed frontier of already
optimized keyframes, GBA_SWEEPS times. With a `mesh` of more than one
shard (parallel/mesh.py) each window runs the landmark-sharded engine
(parallel/dist_ba.py `shard_bundle_adjust`, the reference's `_shard_ba`,
global_ba.py:56), as the reference does for a mesh of more than one
device (:75-76).
"""

from __future__ import annotations

import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.world.map_store import MapState

GBA_MAX_KF = 64
GBA_MAX_MP = 16384
GBA_MAX_LN = 1024
GBA_FRONTIER = 8   # fixed anchor keyframes at the head of each later tile
GBA_SWEEPS = 2     # full passes over the tiling


def _gather_window(state: MapState, lo: int, n_kf: int, cfg: SLAMConfig,
                   frontier: int = 0, kl: int = GBA_MAX_KF):
    """One tile: keyframes [lo, lo + kl) that exist; the first `frontier`
    are fixed anchors, keyframe 0 is always pinned."""
    from structure_slam_pointline_tpu_torch.models import local_mapping as lm

    dev = state.kf_valid.device
    ids = torch.arange(kl, dtype=torch.int32, device=dev) + lo
    valid = ids < n_kf
    local_kf = torch.where(valid, ids, torch.full_like(ids, -1))
    free = valid & (ids != 0) & (torch.arange(kl, device=dev) >= frontier)
    return lm._gather_ba_device(state, local_kf, free, cfg, n_mp_cap=GBA_MAX_MP,
                                n_ln_cap=GBA_MAX_LN)


def _run_window(state, lo, n_kf, intr, cfg, frontier, mesh, metrics, kl=GBA_MAX_KF):
    from structure_slam_pointline_tpu_torch.models import local_mapping as lm

    prob, lines, local_kf, local_mp, local_ln, n_drop = _gather_window(
        state, lo, n_kf, cfg, frontier=frontier, kl=kl)
    if mesh is not None and mesh.size > 1:
        from structure_slam_pointline_tpu_torch.parallel import dist_ba

        result = dist_ba.shard_bundle_adjust(mesh, prob, intr, cfg.optim, lines=lines)
    else:
        result = local_ba.bundle_adjust(prob, intr, cfg.optim, lines=lines)
    if metrics is not None:
        metrics.count("gba_windows")
        metrics.count("landmarks_clipped", int(n_drop))
    return lm.apply_ba_result(state, local_kf, local_mp, result, local_ln=local_ln)


def global_bundle_adjust(state: MapState, n_kf: int, intr: Intrinsics, cfg: SLAMConfig,
                         mesh=None, metrics=None, max_kf: int = GBA_MAX_KF,
                         frontier: int = GBA_FRONTIER) -> MapState:
    """Points and line endpoints over every keyframe, written back into the
    map. Past `max_kf` keyframes, overlapping tiles (stride max_kf -
    frontier) are swept GBA_SWEEPS times."""
    n_kf = int(n_kf)
    if n_kf <= max_kf:
        return _run_window(state, 0, n_kf, intr, cfg, 0, mesh, metrics, kl=max_kf)
    frontier = min(frontier, max_kf - 1)
    stride = max_kf - frontier
    for _sweep in range(GBA_SWEEPS):
        lo = 0
        while lo < n_kf:
            f = 0 if lo == 0 else frontier
            state = _run_window(state, lo, n_kf, intr, cfg, f, mesh, metrics, kl=max_kf)
            if lo + max_kf >= n_kf:
                break
            lo = min(lo + stride, n_kf - max_kf)
    return state


__all__ = ["global_bundle_adjust", "GBA_MAX_KF", "GBA_MAX_MP", "GBA_MAX_LN", "GBA_FRONTIER",
           "GBA_SWEEPS"]
