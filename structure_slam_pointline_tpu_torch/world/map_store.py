"""Struct-of-arrays SLAM map with fixed capacities and validity masks.

Counterpart of structure_slam_pointline_tpu/world/map_store.py: the same
fields, shapes and capacities, as a NamedTuple of torch tensors on one
device. Descriptors and observer bitmasks are int32 bit patterns of the
reference's uint32 words (convert.py translates with a numpy view).

Observations live only in the keyframe-major edge grid `kf_kp_mp[K, F]`
(edge (k, f) exists iff kf_kp_mp[k, f] >= 0); everything derived
(observation counts, covisibility, observer bits) is a segment op over it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.utils.indexing import add_drop

DESC_RING = 4


class MapState(NamedTuple):
    # keyframes (capacity K)
    kf_T_cw: torch.Tensor       # [K, 4, 4]
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32
    kf_xy: torch.Tensor         # [K, F, 2]
    kf_desc: torch.Tensor       # [K, F, 8] int32
    kf_octave: torch.Tensor     # [K, F] int32
    kf_angle: torch.Tensor      # [K, F]
    kf_kp_valid: torch.Tensor   # [K, F] bool
    kf_kp_mp: torch.Tensor      # [K, F] int32 map-point id or -1
    kf_line2d: torch.Tensor     # [K, LF, 3]
    kf_line_ep: torch.Tensor    # [K, LF, 4]
    kf_ldesc: torch.Tensor      # [K, LF, 8] int32
    kf_loctave: torch.Tensor    # [K, LF] int32
    kf_line_valid: torch.Tensor  # [K, LF] bool
    kf_line_ml: torch.Tensor    # [K, LF] int32 map-line id or -1
    # map points (capacity P)
    mp_xyz: torch.Tensor        # [P, 3]
    mp_valid: torch.Tensor      # [P] bool
    mp_desc: torch.Tensor       # [P, 8] int32
    mp_normal: torch.Tensor     # [P, 3]
    mp_angle: torch.Tensor      # [P]
    mp_dist_min: torch.Tensor   # [P]
    mp_dist_max: torch.Tensor   # [P]
    mp_first_kf: torch.Tensor   # [P] int32
    mp_last_kf: torch.Tensor    # [P] int32
    mp_visible: torch.Tensor    # [P] int32
    mp_found: torch.Tensor      # [P] int32
    mp_desc_ring: torch.Tensor  # [P, R, 8] int32
    mp_ring_n: torch.Tensor     # [P] int32
    mp_obs_bits: torch.Tensor   # [P, K/32] int32 observer bitmask
    # map lines (capacity L)
    ml_endpoints: torch.Tensor  # [L, 6]
    ml_valid: torch.Tensor      # [L] bool
    ml_desc: torch.Tensor       # [L, 8] int32
    ml_first_kf: torch.Tensor   # [L] int32
    ml_last_kf: torch.Tensor    # [L] int32
    ml_visible: torch.Tensor    # [L] int32
    ml_found: torch.Tensor      # [L] int32
    ml_desc_ring: torch.Tensor  # [L, R, 8] int32
    ml_ring_n: torch.Tensor     # [L] int32

    @property
    def capacity(self):
        return dict(K=self.kf_valid.shape[0], F=self.kf_xy.shape[1],
                    LF=self.kf_line2d.shape[1], P=self.mp_valid.shape[0],
                    L=self.ml_valid.shape[0])


@dataclasses.dataclass
class MapCursors:
    """Host-side scalar allocation cursors (monotone bump allocators)."""

    n_kf: int = 0
    n_mp: int = 0
    n_ml: int = 0


def init_map(cfg: SLAMConfig, device, n_features: int | None = None) -> MapState:
    K = cfg.map.max_keyframes
    F = n_features or cfg.frontend.n_keypoints
    LF = cfg.frontend.n_lines
    P = cfg.map.max_points
    L = cfg.map.max_lines
    f32, i32 = torch.float32, torch.int32
    z = lambda *s, dt=f32: torch.zeros(s, dtype=dt, device=device)  # noqa: E731
    full = lambda s, v, dt=i32: torch.full(s, v, dtype=dt, device=device)  # noqa: E731
    return MapState(
        kf_T_cw=torch.eye(4, device=device).repeat(K, 1, 1),
        kf_valid=z(K, dt=torch.bool),
        kf_frame_id=full((K,), -1),
        kf_xy=z(K, F, 2),
        kf_desc=z(K, F, 8, dt=i32),
        kf_octave=z(K, F, dt=i32),
        kf_angle=z(K, F),
        kf_kp_valid=z(K, F, dt=torch.bool),
        kf_kp_mp=full((K, F), -1),
        kf_line2d=z(K, LF, 3),
        kf_line_ep=z(K, LF, 4),
        kf_ldesc=z(K, LF, 8, dt=i32),
        kf_loctave=z(K, LF, dt=i32),
        kf_line_valid=z(K, LF, dt=torch.bool),
        kf_line_ml=full((K, LF), -1),
        mp_xyz=z(P, 3),
        mp_valid=z(P, dt=torch.bool),
        mp_desc=z(P, 8, dt=i32),
        mp_normal=z(P, 3),
        mp_angle=z(P),
        mp_dist_min=z(P),
        mp_dist_max=full((P,), 1e9, f32),
        mp_first_kf=full((P,), -1),
        mp_last_kf=full((P,), -1),
        mp_visible=z(P, dt=i32),
        mp_found=z(P, dt=i32),
        mp_desc_ring=z(P, DESC_RING, 8, dt=i32),
        mp_ring_n=z(P, dt=i32),
        mp_obs_bits=z(P, (K + 31) // 32, dt=i32),
        ml_endpoints=z(L, 6),
        ml_valid=z(L, dt=torch.bool),
        ml_desc=z(L, 8, dt=i32),
        ml_first_kf=full((L,), -1),
        ml_last_kf=full((L,), -1),
        ml_visible=z(L, dt=i32),
        ml_found=z(L, dt=i32),
        ml_desc_ring=z(L, DESC_RING, 8, dt=i32),
        ml_ring_n=z(L, dt=i32),
    )


def _counts(edges: torch.Tensor, cap: int) -> torch.Tensor:
    ids = torch.where(edges >= 0, edges, cap).reshape(-1)
    return add_drop(torch.zeros(cap, dtype=torch.int32, device=edges.device), ids, 1)


def point_obs_counts(state: MapState) -> torch.Tensor:
    """[P] keyframe observations per map point."""
    return _counts(state.kf_kp_mp, state.mp_valid.shape[0])


def line_obs_counts(state: MapState) -> torch.Tensor:
    return _counts(state.kf_line_ml, state.ml_valid.shape[0])


def _seen(row: torch.Tensor, cap: int) -> torch.Tensor:
    seen = torch.zeros(cap + 1, dtype=torch.bool, device=row.device)
    seen[torch.where(row >= 0, row, cap).long()] = True
    return seen[:cap]


def covisibility_weights(state: MapState, kf_id) -> torch.Tensor:
    """[K] landmarks (points + lines) shared between kf_id and every KF."""
    K = state.kf_valid.shape[0]
    P = state.mp_valid.shape[0]
    L = state.ml_valid.shape[0]
    seen_pt = _seen(state.kf_kp_mp[kf_id], P)
    seen_ln = _seen(state.kf_line_ml[kf_id], L)
    shares_pt = (state.kf_kp_mp >= 0) & seen_pt[torch.clamp(state.kf_kp_mp, 0, P - 1).long()]
    shares_ln = (state.kf_line_ml >= 0) & seen_ln[torch.clamp(state.kf_line_ml, 0, L - 1).long()]
    w = shares_pt.sum(1).to(torch.int32) + shares_ln.sum(1).to(torch.int32)
    w = torch.where(torch.arange(K, device=w.device) == kf_id, torch.zeros_like(w), w)
    return torch.where(state.kf_valid, w, torch.zeros_like(w))


def compute_obs_bits(state: MapState) -> torch.Tensor:
    """[P, K/32] int32 observer bitmasks from the [K, F] edge grid: each
    (keyframe, landmark) pair appears at most once, so an integer add of
    2^(k mod 32) into word k // 32 is an exact bitwise OR."""
    K, F = state.kf_kp_mp.shape
    P = state.mp_valid.shape[0]
    KW = (K + 31) // 32
    dev = state.kf_kp_mp.device
    k_ids = torch.arange(K, device=dev)[:, None].expand(K, F)
    word = (k_ids >> 5).reshape(-1)
    bit = (torch.ones((), dtype=torch.long, device=dev) << (k_ids & 31)).reshape(-1)
    e = state.kf_kp_mp.reshape(-1).long()
    ok = e >= 0
    acc = torch.zeros(P * KW, dtype=torch.long, device=dev)
    acc.index_put_(((e * KW + word)[ok],), bit[ok], accumulate=True)
    acc = torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
    return acc.to(torch.int32).reshape(P, KW)


def votes_from_bits(obs_rows: torch.Tensor, matched: torch.Tensor,
                    kf_valid: torch.Tensor) -> torch.Tensor:
    """[K] keyframe votes: matched local-map rows' observer bits, summed."""
    M, KW = obs_rows.shape
    K = kf_valid.shape[0]
    shifts = torch.arange(32, device=obs_rows.device, dtype=torch.int32)
    bits = ((obs_rows[:, :, None] >> shifts) & 1).reshape(M, KW * 32)[:, :K]
    v = (bits * matched[:, None].to(torch.int32)).sum(0).to(torch.int32)
    return torch.where(kf_valid, v, torch.zeros_like(v))


def kf_match_votes(state: MapState, matched_pt: torch.Tensor) -> torch.Tensor:
    """[K] per-keyframe count of matched map points it observes."""
    P = state.mp_valid.shape[0]
    e = state.kf_kp_mp
    has = (e >= 0) & matched_pt[torch.clamp(e, 0, P - 1).long()]
    v = has.sum(1).to(torch.int32)
    return torch.where(state.kf_valid, v, torch.zeros_like(v))


__all__ = ["MapState", "MapCursors", "DESC_RING", "init_map", "point_obs_counts",
           "line_obs_counts", "covisibility_weights", "compute_obs_bits",
           "votes_from_bits", "kf_match_votes"]
