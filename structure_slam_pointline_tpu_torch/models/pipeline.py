"""Per-frame SLAM step: frontend -> tracking -> keyframe decision ->
keyframe pipeline (insert, triangulate, fuse, local BA, cull).

Counterpart of structure_slam_pointline_tpu/models/pipeline.py. The
reference runs a frame as one XLA program with the keyframe
branch under `lax.cond` and the wide re-track under `lax.while_loop`;
here those are Python branches behind one small device -> host read per
frame (the inlier count of the tracking attempt, from which `ok`, the
re-track and the keyframe decision follow on the host). The reference's
`slam_scan` has no counterpart: `SLAMSystem.track_sequence` calls
`slam_step` once per frame.

`SLAMCarry` keeps the map state and poses as tensors on the device and
the cursors / counters as Python ints and bools (the host decides every
branch from them).

With a `mesh` of more than one shard (parallel/mesh.py), the keyframe
pipeline's local BA runs the landmark-sharded engine
(parallel/dist_ba.py), as the reference's does (pipeline.py:229-238).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models import local_mapping as lm
from structure_slam_pointline_tpu_torch.models import tracking
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import extract, lbd, lsd
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils import fmath
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import stable_topk
from structure_slam_pointline_tpu_torch.world import map_store
from structure_slam_pointline_tpu_torch.world.map_store import MapState

NB_TRIANGULATE = 4


class SLAMCarry(NamedTuple):
    state: MapState
    T_last: torch.Tensor       # [4, 4]
    velocity: torch.Tensor     # [4, 4]
    n_kf: int
    n_mp: int
    n_ml: int
    frames_since_kf: int
    inliers_at_kf: int
    ok: bool
    recover_hold: int
    local_sets: tracking.LocalSets


class FrameOut(NamedTuple):
    T_cw: torch.Tensor
    ok: bool
    n_inliers: int
    is_kf: bool
    n_dropped: int = 0
    n_mp: int = 0
    n_ml: int = 0
    n_kf: int = 0
    # live landmark counts after a keyframe event (None on other frames:
    # only the keyframe pipeline creates, fuses or culls landmarks)
    n_live_mp: int | None = None
    n_live_ml: int | None = None


def build_frame_device(img: torch.Tensor, intr: Intrinsics, cfg: SLAMConfig) -> Frame:
    """Image -> Frame: ORB extraction, LSD-style lines (two octaves by
    default) with LBD descriptors, undistortion (the reference's line
    coefficients are recomputed from the undistorted endpoints)."""
    fe = cfg.frontend
    kp = extract.extract_orb(img, fe)
    xy = cam_utils.undistort_pixels(intr, kp.xy) if cfg.camera.has_distortion else kp.xy
    LF = fe.n_lines
    dev = img.device
    if not cfg.use_lines:
        return Frame(xy=xy, desc=kp.desc, octave=kp.octave, angle=kp.angle,
                     kp_valid=kp.valid,
                     line2d=torch.zeros((LF, 3), device=dev),
                     line_ep=torch.zeros((LF, 4), device=dev),
                     ldesc=torch.zeros((LF, 8), dtype=torch.int32, device=dev),
                     loctave=torch.zeros((LF,), dtype=torch.int32, device=dev),
                     line_valid=torch.zeros((LF,), dtype=torch.bool, device=dev))
    ln = (lsd.detect_lines_pyramid(img, fe) if fe.line_octaves > 1
          else lsd.detect_lines(img, fe))
    ldesc, _ = lbd.describe_lines(img, ln.endpoints.contiguous(), ln.valid)
    line_ep, line2d = ln.endpoints, ln.line2d
    if cfg.camera.has_distortion:
        sp = cam_utils.undistort_pixels(intr, line_ep[:, 0:2])
        ep = cam_utils.undistort_pixels(intr, line_ep[:, 2:4])
        line_ep = torch.cat([sp, ep], dim=1)
        one = torch.ones((LF, 1), device=dev)
        l = torch.linalg.cross(torch.cat([sp, one], 1), torch.cat([ep, one], 1))
        line2d = l / torch.clamp(fmath.hypot(l[:, 0], l[:, 1]), min=1e-9)[:, None]
    return Frame(xy=xy, desc=kp.desc, octave=kp.octave, angle=kp.angle, kp_valid=kp.valid,
                 line2d=line2d, line_ep=line_ep, ldesc=ldesc, loctave=ln.octave,
                 line_valid=ln.valid)


def _gather_ba_problem_device(state: MapState, n_kf: int, cfg: SLAMConfig,
                              k_new: int, covis_w: torch.Tensor):
    """Local-BA window by covisibility of the new keyframe: the BA_WINDOW
    strongest (+ k_new) free, the next BA_FIXED fixed, KF 0 pinned."""
    KL = lm.BA_LOCAL_KF
    K = covis_w.shape[0]
    kid = torch.arange(K, device=covis_w.device)
    score = torch.where(kid == k_new, torch.full_like(covis_w, 1 << 20), covis_w)
    score = torch.where(state.kf_valid & (kid < n_kf), score, torch.zeros_like(score))
    top_v, top_i = stable_topk(score, KL)
    sel = top_v > 0
    local_kf = torch.where(sel, top_i, -1).to(torch.int32)
    rank = torch.arange(KL, device=covis_w.device)
    free = sel & (rank < lm.BA_WINDOW) & (top_i != 0)
    has_fixed = torch.any(sel & ~free)
    min_id = torch.min(torch.where(sel, top_i, K))
    free = torch.where(has_fixed, free, free & (top_i != min_id))
    return lm._gather_ba_device(state, local_kf, free, cfg)


def _renorm_se3(T: torch.Tensor) -> torch.Tensor:
    """One Newton polar step R <- R (3I - R^T R) / 2 on the rotation block."""
    R = T[..., :3, :3]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    R = 0.5 * R @ (3.0 * eye - R.transpose(-1, -2) @ R)
    out = T.clone()
    out[..., :3, :3] = R
    return out


def _keyframe_pipeline(state: MapState, frame: Frame, tr: tracking.TrackResult,
                       n_kf: int, n_mp: int, n_ml: int, frame_id: int,
                       intr: Intrinsics, cfg: SLAMConfig, mesh=None):
    """Insert KF + triangulate points and lines vs neighbours + fuse +
    local BA + cull (LocalMapping::Run's per-keyframe sequence)."""
    ab = frozenset(a for a in cfg.ablate.split(",") if a)
    k = n_kf
    dev = tr.T_cw.device
    st = lm.insert_keyframe(state, k, frame_id, tr.T_cw, frame, tr.feat_mp,
                            tr.line_ml, cfg)
    covis_w = map_store.covisibility_weights(st, k)
    NB = 1 if "nb1" in ab else NB_TRIANGULATE
    top_w, top_n = stable_topk(covis_w, NB_TRIANGULATE)
    ar = torch.arange(NB_TRIANGULATE, device=dev)
    nbs = torch.where(top_w > 0, top_n, torch.clamp(k - 1 - ar, min=0))
    tri_nbs = torch.where(ar < NB, nbs, -1)
    out = lm.create_new_points(st, k, tri_nbs, n_mp, intr, cfg)
    st = out.state
    counts = [out.n_new, out.n_clipped]
    lines_tri = cfg.use_lines and "no_line_tri" not in ab
    if lines_tri:
        outl = lm.create_new_lines(st, k, tri_nbs, n_ml, intr, cfg)
        st = outl.state
        counts += [outl.n_new, outl.n_clipped]
    counts = [int(v) for v in torch.stack(counts).tolist()]
    n_mp = n_mp + counts[0]
    n_dropped = counts[1]
    if lines_tri:
        n_ml = n_ml + counts[2]
        n_dropped += counts[3]
    if "no_fuse" not in ab:
        st = lm.fuse_projected_points(st, k, nbs, intr, cfg)
        if cfg.use_lines:
            st = lm.fuse_projected_lines(st, k, nbs, intr, cfg)
    prob, ba_lines, local_kf, local_mp, local_ln, ba_drop = _gather_ba_problem_device(
        st, k + 1, cfg, k, covis_w)
    n_dropped += int(ba_drop)
    if "no_ba" not in ab:
        if mesh is not None and mesh.size > 1:
            from structure_slam_pointline_tpu_torch.parallel import dist_ba

            ba = dist_ba.shard_bundle_adjust(mesh, prob, intr, cfg.optim, lines=ba_lines)
        else:
            ba = local_ba.bundle_adjust(prob, intr, cfg.optim, lines=ba_lines)
        st = lm.apply_ba_result(st, local_kf, local_mp, ba, local_ln=local_ln)
    if "no_cull" not in ab:
        obs = map_store.point_obs_counts(st)
        st = lm.cull_points(st, k + 1, cfg, obs=obs)
        if cfg.use_lines:
            st = lm.cull_lines(st, k + 1, cfg)
        cull_w, cull_i = stable_topk(covis_w, min(lm.KF_CULL_WINDOW, covis_w.shape[0]))
        cand_ids = torch.where(cull_w > 0, cull_i, -1)
        st = lm.cull_keyframes(st, k + 1, cfg, obs=obs, cand_ids=cand_ids)
    if "no_obs_bits" not in ab:
        st = st._replace(mp_obs_bits=map_store.compute_obs_bits(st))
    sets = tracking.compute_local_sets(st, k + 1, cfg.map.local_window_kf,
                                       cfg.map.local_points_cap, cfg.map.local_lines_cap)
    T_new = st.kf_T_cw[k]
    floor = int((cfg.keyframe.min_inliers + 10) / cfg.keyframe.min_tracked_ratio)
    n_ref = max(int(tr.n_inliers), floor)
    return st, n_mp, n_ml, k + 1, T_new, n_dropped, sets, n_ref


def slam_step(carry: SLAMCarry, img: torch.Tensor, frame_id: int, intr: Intrinsics,
              cfg: SLAMConfig, allow_kf: bool = True, mesh=None):
    """One tracked frame. `allow_kf=False` is localization-only mode; a
    `mesh` shards the keyframe pipeline's local BA."""
    frame = build_frame_device(img, intr, cfg)
    T_pred = carry.velocity @ carry.T_last
    kf_lo = max(carry.n_kf - cfg.map.local_window_kf, 0) if carry.ok else 0
    tr = tracking.track_step(carry.state, frame, T_pred, kf_lo, intr, cfg,
                             radius_scale=1.0, n_kf=carry.n_kf,
                             local_sets=carry.local_sets)
    n_inl = int(tr.n_inliers)          # the per-frame device -> host read
    if n_inl < cfg.keyframe.min_inliers_track:
        # wide re-track from the LAST pose (the reference's
        # TrackReferenceKeyFrame role, Tracking.cc:212)
        tr = tracking.track_step(carry.state, frame, carry.T_last, kf_lo, intr, cfg,
                                 radius_scale=2.5, n_kf=carry.n_kf,
                                 local_sets=carry.local_sets)
        n_inl = int(tr.n_inliers)
    state = tracking.update_seen_counters(carry.state, tr, cfg)
    strict = (not carry.ok) or carry.recover_hold > 0
    ok = n_inl >= (cfg.keyframe.min_inliers_recover if strict
                   else cfg.keyframe.min_inliers_healthy)
    recover_hold = max(carry.recover_hold - 1, 0)
    peak = carry.inliers_at_kf
    # the reference truncates the float32 product ratio * peak
    weak = n_inl < int(torch.tensor(cfg.keyframe.min_tracked_ratio,
                                    dtype=torch.float32) * float(peak))
    weak = weak and carry.frames_since_kf + 1 >= cfg.keyframe.min_frames
    stale = carry.frames_since_kf + 1 >= cfg.keyframe.max_frames
    roomy = carry.n_kf < cfg.map.max_keyframes - 1
    need_kf = (ok and roomy and n_inl >= cfg.keyframe.min_inliers and (weak or stale)
               and bool(allow_kf) and "no_kf" not in cfg.ablate)
    n_live = (None, None)
    if need_kf:
        state, n_mp, n_ml, n_kf, T_cw, n_drop, local_sets, n_ref = _keyframe_pipeline(
            state, frame, tr, carry.n_kf, carry.n_mp, carry.n_ml, frame_id, intr, cfg,
            mesh=mesh)
        frames_since, inl_at_kf = 0, n_ref
        n_live = tuple(torch.stack([state.mp_valid.sum(), state.ml_valid.sum()]).tolist())
    else:
        n_mp, n_ml, n_kf, T_cw, n_drop = (carry.n_mp, carry.n_ml, carry.n_kf,
                                          tr.T_cw, 0)
        local_sets = carry.local_sets
        frames_since = carry.frames_since_kf + 1
        inl_at_kf = max(carry.inliers_at_kf, n_inl)
    T_cw = _renorm_se3(T_cw if ok else T_pred)
    velocity = T_cw @ lie.se3_inverse(carry.T_last) if ok else carry.velocity
    new_carry = SLAMCarry(state=state, T_last=T_cw, velocity=velocity, n_kf=n_kf,
                          n_mp=n_mp, n_ml=n_ml, frames_since_kf=frames_since,
                          inliers_at_kf=inl_at_kf, ok=ok, recover_hold=recover_hold,
                          local_sets=local_sets)
    return new_carry, FrameOut(T_cw=T_cw, ok=ok, n_inliers=n_inl, is_kf=need_kf,
                               n_dropped=n_drop, n_mp=n_mp, n_ml=n_ml, n_kf=n_kf,
                               n_live_mp=n_live[0], n_live_ml=n_live[1])


def make_carry(state: MapState, T_last, velocity, n_kf: int, n_mp: int,
               inliers_at_kf: int, n_ml: int = 0, window_kf: int = 20,
               p_cap: int = tracking.LOCAL_POINTS,
               l_cap: int = tracking.LOCAL_LINES) -> SLAMCarry:
    dev = state.kf_valid.device
    return SLAMCarry(
        state=state,
        T_last=torch.as_tensor(T_last, dtype=torch.float32, device=dev),
        velocity=torch.as_tensor(velocity, dtype=torch.float32, device=dev),
        n_kf=int(n_kf), n_mp=int(n_mp), n_ml=int(n_ml), frames_since_kf=0,
        inliers_at_kf=int(inliers_at_kf), ok=True, recover_hold=0,
        local_sets=tracking.compute_local_sets(state, int(n_kf), window_kf,
                                               p_cap, l_cap))


__all__ = ["SLAMCarry", "FrameOut", "slam_step", "make_carry",
           "build_frame_device"]
