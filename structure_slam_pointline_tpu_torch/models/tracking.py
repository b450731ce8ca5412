"""Tracking: project local map -> match -> pose LM, two passes.

Counterpart of structure_slam_pointline_tpu/models/tracking.py
(`track_step` mirrors TrackWithMotionModel -> TrackLocalMapWithLines):

  pass 1: recency-window landmarks, wide radius, motion-model pose
  pass 2: covisibility local map (keyframes voted by pass-1 matches),
          tight radius, refined pose

Each pass's matches run through kernel 22's tracking entries
(ops/matching.track_match_points / track_match_lines: projection, gates,
window, best-2, ratio, unique columns and the rotation histogram or the
MAD margin gate, no [M, N] mask) and its pose solve through kernel 4
(optim/pose_opt.pose_optimize). With `use_lines=False` the line arrays
are all invalid, exactly as in the reference, and the line edges carry no
weight (`line_pose_weight` = 0). The sf^k tables (the window radii, the
sigma^2 of each octave) are gathered from `matching.sf_powers`' cache.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.ops import matching
from structure_slam_pointline_tpu_torch.optim import pose_opt
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import add_drop, set_drop, stable_topk
from structure_slam_pointline_tpu_torch.world import map_store
from structure_slam_pointline_tpu_torch.world.map_store import MapState

LOCAL_POINTS = 2048
LOCAL_LINES = 256
N_LOCAL_KF = 16


class Frame(NamedTuple):
    """Per-frame feature bundle (undistorted), fixed capacity."""

    xy: torch.Tensor        # [F, 2]
    desc: torch.Tensor      # [F, 8] int32
    octave: torch.Tensor    # [F] int32
    angle: torch.Tensor     # [F]
    kp_valid: torch.Tensor  # [F] bool
    line2d: torch.Tensor    # [LF, 3]
    line_ep: torch.Tensor   # [LF, 4]
    ldesc: torch.Tensor     # [LF, 8] int32
    loctave: torch.Tensor   # [LF] int32
    line_valid: torch.Tensor  # [LF] bool


class TrackResult(NamedTuple):
    T_cw: torch.Tensor
    feat_mp: torch.Tensor       # [F] int32
    feat_inlier: torch.Tensor   # [F] bool
    line_ml: torch.Tensor       # [LF] int32
    line_inlier: torch.Tensor   # [LF] bool
    n_inliers: torch.Tensor     # int32 scalar
    n_matches: torch.Tensor     # int32 scalar
    local_pt_ids: torch.Tensor  # [p_cap] int32
    visible_pt: torch.Tensor    # [p_cap] bool
    local_ln_ids: torch.Tensor  # [l_cap] int32
    visible_ln: torch.Tensor    # [l_cap] bool


class LocalSets(NamedTuple):
    """Pass-1 local-map slot lists (ids, -1 padded), refreshed at keyframe
    events; `wide_*` are the whole-map sets used while LOST."""

    pt: torch.Tensor
    ln: torch.Tensor
    wide_pt: torch.Tensor
    wide_ln: torch.Tensor


def _scale_sigma2(octave: torch.Tensor, scale_factor: float, n_levels: int) -> torch.Tensor:
    """sf^(2 octave) from the device's cached table (matching.sf_powers)."""
    return matching.sf_powers(scale_factor, n_levels, octave.device, 2.0)[octave.long()]


def _recency_top(valid, last_kf, kf_lo, size: int) -> torch.Tensor:
    """Ids of up to `size` valid landmarks with last_kf >= kf_lo, most
    recent first (float32 key last_kf * N - slot, as the reference)."""
    N = valid.shape[0]
    assert 256 * N <= (1 << 24), "_recency_top key overflow"
    mask = valid & (last_kf >= kf_lo)
    key = torch.where(mask, last_kf.float() * N
                      - torch.arange(N, dtype=torch.float32, device=valid.device),
                      torch.full((), float("-inf"), device=valid.device))
    k = min(size, N)
    top_v, top_i = stable_topk(key, k)
    idx = torch.where(torch.isfinite(top_v), top_i, -1).to(torch.int32)
    if k < size:
        idx = torch.cat([idx, torch.full((size - k,), -1, dtype=torch.int32,
                                         device=idx.device)])
    return idx


def _ids_triple(idx: torch.Tensor, cap: int):
    return idx, idx >= 0, torch.clamp(idx, 0, cap - 1).long()


def compute_local_sets(state: MapState, n_kf: int, window_kf: int,
                       p_cap: int = LOCAL_POINTS, l_cap: int = LOCAL_LINES) -> LocalSets:
    kf_lo = max(n_kf - window_kf, 0)
    return LocalSets(
        pt=_recency_top(state.mp_valid, state.mp_last_kf, kf_lo, p_cap),
        ln=_recency_top(state.ml_valid, state.ml_last_kf, kf_lo, l_cap),
        wide_pt=_recency_top(state.mp_valid, state.mp_last_kf, 0, p_cap),
        wide_ln=_recency_top(state.ml_valid, state.ml_last_kf, 0, l_cap),
    )


def _mark(ids: torch.Tensor, cap: int) -> torch.Tensor:
    m = torch.zeros(cap + 1, dtype=torch.bool, device=ids.device)
    m[torch.where(ids >= 0, ids, cap).reshape(-1).long()] = True
    return m[:cap]


def _covis_local_sets(state: MapState, votes, n_kf: int, p_cap: int, l_cap: int):
    """Top-N_LOCAL_KF voted keyframes (the two newest always in) -> the
    landmarks they observe, ranked by recency."""
    K = state.kf_valid.shape[0]
    P = state.mp_valid.shape[0]
    L = state.ml_valid.shape[0]
    kid = torch.arange(K, device=votes.device)
    recent = (kid >= n_kf - 2) & (kid < n_kf) & state.kf_valid
    score = votes + torch.where(recent, 1 << 20, 0).to(votes.dtype)
    top_v, top_i = stable_topk(score, N_LOCAL_KF)
    sel = top_v > 0
    rows = torch.clamp(top_i, 0, K - 1)
    mp_rows = torch.where(sel[:, None], state.kf_kp_mp[rows], -1)
    pmask = _mark(mp_rows, P) & state.mp_valid
    ml_rows = torch.where(sel[:, None], state.kf_line_ml[rows], -1)
    lmask = _mark(ml_rows, L) & state.ml_valid
    neg = -(1 << 20)
    pidx = _recency_top(pmask, state.mp_last_kf, neg, p_cap)
    lidx = _recency_top(lmask, state.ml_last_kf, neg, l_cap)
    return _ids_triple(pidx, P), _ids_triple(lidx, L)


def track_step(state: MapState, frame: Frame, T_pred: torch.Tensor, kf_lo: int,
               intr: Intrinsics, cfg: SLAMConfig, radius_scale: float = 1.0,
               n_kf: int = 1 << 20, local_sets: LocalSets | None = None) -> TrackResult:
    F = frame.xy.shape[0]
    LF = frame.line2d.shape[0]
    P = state.mp_valid.shape[0]
    L = state.ml_valid.shape[0]
    dev = T_pred.device
    n_lv = cfg.frontend.n_levels
    pt_sigma2 = _scale_sigma2(frame.octave, cfg.frontend.scale_factor, n_lv)
    ln_sigma2 = _scale_sigma2(frame.loctave, cfg.frontend.line_scale_factor, n_lv)
    optim_p1 = dataclasses.replace(cfg.optim, pose_rounds=cfg.optim.pose_rounds_pass1,
                                   pose_iters=cfg.optim.pose_iters_pass1)

    def one_round(T, radius_scale, line_radius, pts, lns, check_rotation=False,
                  optim_cfg=None, ratio=1.0):
        pt_ids, _, pt_safe = pts
        ln_ids, _, ln_safe = lns
        m, visible = matching.track_match_points(state, frame, T, pt_ids, intr, cfg,
                                                 radius_scale, check_rotation=check_rotation,
                                                 ratio=ratio)
        lm, lvis = matching.track_match_lines(state, frame, T, ln_ids, intr, cfg, line_radius)
        midx, lidx = m.idx.long(), lm.idx.long()
        w_l = cfg.optim.line_pose_weight
        l_valid = lm.valid if w_l > 0 else torch.zeros_like(lm.valid)
        eps_m = state.ml_endpoints[ln_safe]
        res = pose_opt.pose_optimize(
            T, state.mp_xyz[pt_safe], frame.xy[midx], m.valid, pt_sigma2[midx],
            eps_m[:, :3], eps_m[:, 3:], frame.line2d[lidx], l_valid,
            ln_sigma2[lidx] / max(w_l, 1e-9), intr, optim_cfg or cfg.optim)
        Tn = res.T_cw
        uv_sw, _ = cam_utils.project(intr, eps_m[:, :3] @ Tn[:3, :3].T + Tn[:3, 3])
        uv_ew, _ = cam_utils.project(intr, eps_m[:, 3:] @ Tn[:3, :3].T + Tn[:3, 3])
        l_obs = frame.line2d[lidx]
        e_s = l_obs[:, 0] * uv_sw[:, 0] + l_obs[:, 1] * uv_sw[:, 1] + l_obs[:, 2]
        e_e = l_obs[:, 0] * uv_ew[:, 0] + l_obs[:, 1] * uv_ew[:, 1] + l_obs[:, 2]
        chi = (e_s * e_s + e_e * e_e) / torch.clamp(ln_sigma2[lidx], min=1e-9)
        cfg_o = optim_cfg or cfg.optim
        line_obs_ok = lm.valid & (chi < 2.0 * cfg_o.chi2_line)
        if w_l > 0:
            line_obs_ok = line_obs_ok & res.line_inliers
        res = res._replace(line_inliers=line_obs_ok)
        return res, m, visible, lm, lvis

    p_cap = cfg.map.local_points_cap
    l_cap = cfg.map.local_lines_cap
    if local_sets is None:
        pts1 = _ids_triple(_recency_top(state.mp_valid, state.mp_last_kf, kf_lo, p_cap), P)
        lns1 = _ids_triple(_recency_top(state.ml_valid, state.ml_last_kf, kf_lo, l_cap), L)
    else:
        wide = kf_lo <= 0
        pts1 = _ids_triple(local_sets.wide_pt if wide else local_sets.pt, P)
        lns1 = _ids_triple(local_sets.wide_ln if wide else local_sets.ln, L)
    res1, m1, _, lm1, _ = one_round(
        T_pred, cfg.matching.search_radius_motion * radius_scale, 30.0 * radius_scale,
        pts1, lns1, check_rotation=True, optim_cfg=optim_p1,
        ratio=cfg.matching.nn_ratio_tracking)
    pt_ids1, pt_ok1, pt_safe1 = pts1
    matched1 = m1.valid & res1.point_inliers & pt_ok1
    votes = map_store.votes_from_bits(state.mp_obs_bits[pt_safe1], matched1,
                                      state.kf_valid)
    pts2, lns2 = _covis_local_sets(state, votes, n_kf, p_cap, l_cap)
    res2, m2, vis2, lm2, lvis2 = one_round(res1.T_cw, 4.0, 15.0, pts2, lns2,
                                           ratio=cfg.matching.nn_ratio_localmap)
    pt_ids2, ln_ids1, ln_ids2 = pts2[0], lns1[0], lns2[0]

    inl2 = m2.valid & res2.point_inliers
    bound2 = _mark(torch.where(inl2, pt_ids2, -1), P)
    inl1 = m1.valid & res1.point_inliers & ~bound2[torch.clamp(pt_ids1, 0, P - 1).long()]
    feat_mp = torch.full((F,), -1, dtype=torch.int32, device=dev)
    feat_mp = set_drop(feat_mp, torch.where(inl1, m1.idx, F), pt_ids1)
    feat_mp = set_drop(feat_mp, torch.where(inl2, m2.idx, F), pt_ids2)
    feat_inlier = feat_mp >= 0

    linl2 = lm2.valid & res2.line_inliers
    lbound2 = _mark(torch.where(linl2, ln_ids2, -1), L)
    linl1 = lm1.valid & res1.line_inliers & ~lbound2[torch.clamp(ln_ids1, 0, L - 1).long()]
    line_ml = torch.full((LF,), -1, dtype=torch.int32, device=dev)
    line_ml = set_drop(line_ml, torch.where(linl1, lm1.idx, LF), ln_ids1)
    line_ml = set_drop(line_ml, torch.where(linl2, lm2.idx, LF), ln_ids2)
    line_inlier = line_ml >= 0

    n_inl = feat_inlier.sum().to(torch.int32) + line_inlier.sum().to(torch.int32)
    n_match = (m2.valid.sum() + inl1.sum() + lm2.valid.sum() + linl1.sum()).to(torch.int32)
    return TrackResult(T_cw=res2.T_cw, feat_mp=feat_mp, feat_inlier=feat_inlier,
                       line_ml=line_ml, line_inlier=line_inlier, n_inliers=n_inl,
                       n_matches=n_match, local_pt_ids=pt_ids2, visible_pt=vis2,
                       local_ln_ids=ln_ids2, visible_ln=lvis2)


def update_seen_counters(state: MapState, tr: TrackResult, cfg: SLAMConfig) -> MapState:
    """found/visible statistics feeding map-point culling."""
    P = state.mp_valid.shape[0]
    L = state.ml_valid.shape[0]
    vis_ids = torch.where(tr.visible_pt & (tr.local_pt_ids >= 0), tr.local_pt_ids, P)
    found_ids = torch.where(tr.feat_mp >= 0, tr.feat_mp, P)
    lvis_ids = torch.where(tr.visible_ln & (tr.local_ln_ids >= 0), tr.local_ln_ids, L)
    lfound_ids = torch.where(tr.line_ml >= 0, tr.line_ml, L)
    return state._replace(
        mp_visible=add_drop(state.mp_visible, vis_ids, 1),
        mp_found=add_drop(state.mp_found, found_ids, 1),
        ml_visible=add_drop(state.ml_visible, lvis_ids, 1),
        ml_found=add_drop(state.ml_found, lfound_ids, 1))


__all__ = ["Frame", "TrackResult", "LocalSets", "compute_local_sets", "track_step",
           "update_seen_counters", "LOCAL_POINTS", "LOCAL_LINES"]
