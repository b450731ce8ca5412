"""Relocalization: BoW candidate retrieval + PnP + pose refinement, and the
reference-keyframe rung.

Counterpart of structure_slam_pointline_tpu/models/relocalization.py
(the reference's Tracking::Relocalization and TrackReferenceKeyFrame).
The host keeps the reference's control flow and its numpy draws; the
device work runs through the kernels:

- the query frame's words and BoW vector: kernel 13 (ops/bow.transform);
- the database scores: kernel 14 (ops/bow.query_database), the candidate
  policy (argsort, the 0.75 x best cut, MAX_CANDIDATES) on a host copy;
- BoW-node-gated matching against all candidates at once: kernel 3 in its
  batched form (the frame's [F, 8] descriptors shared, [C, Fk, 8]
  keyframe descriptors, a [C, F, Fk] mask);
- RANSAC PnP over all candidates: kernel 15 (ops/pnp.ransac_pnp), one
  call, its sample sets drawn on the host from the caller's generator in
  the reference's order;
- the refinement by `tracking.track_step` (kernels 3, 4, 8, 9), and the
  reference-keyframe rung's pose LM (kernel 4 with one masked line edge).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models import tracking
from structure_slam_pointline_tpu_torch.models.loop_closing import LoopCloser
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import bow, matching, pnp
from structure_slam_pointline_tpu_torch.optim import pose_opt
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.world.map_store import MapState

MAX_CANDIDATES = 16   # the reference's static candidate batch
RANSAC_ITERS = 256


def _coarse(lc: LoopCloser, cfg: SLAMConfig) -> int:
    """Word id -> node id divisor of the matching gate (the DBoW2
    FeatureVector level, depth - feature_level_up)."""
    return lc.voc.branching ** max(lc.voc.depth - cfg.bow.feature_level_up, 1)


def _bow_match_candidates(frame: Frame, desc_k, node_k, has_mp, node_f, valid_f,
                          cfg: SLAMConfig):
    """BoW-node-gated matching of the frame against all C candidates at
    once (the reference's vmapped SearchByBoW): one batched kernel-3
    call. Returns (idx [C, F], valid [C, F])."""
    allow = ((node_f[None, :, None] == node_k[:, None, :]) & (node_k >= 0)[:, None, :]
             & valid_f[None, :, None] & frame.kp_valid[None, :, None]
             & has_mp[:, None, :])
    m = matching.masked_match(frame.desc, desc_k, allow, max_dist=cfg.matching.th_low,
                              ratio=cfg.matching.nn_ratio_bow)
    return m.idx, m.valid


def relocalize(state: MapState, n_kf: int, frame: Frame, lc: LoopCloser, intr: Intrinsics,
               cfg: SLAMConfig, rng: np.random.Generator,
               wide: bool = False) -> Optional[np.ndarray]:
    """Returns a recovered T_cw (4x4 numpy) or None. All database
    candidates >= 0.75 x best (up to MAX_CANDIDATES) are matched and
    solved in one batch each. With `wide` (the reference's escalation for
    a frame lost too long; no caller passes it, in either package) the
    0.75 cut is dropped: the first MAX_CANDIDATES keyframes by score with
    a score > 0 are tried."""
    if not lc.ensure_vocabulary(state, n_kf):
        return None
    dev = frame.xy.device
    words_f, bow_f = bow.transform(lc.voc, frame.desc, frame.kp_valid)
    scores = bow.query_database(bow_f, lc.kf_bows, state.kf_valid).cpu().numpy()
    best = scores.max()
    if best <= 0:
        return None
    keep = scores > 0 if wide else scores >= 0.75 * best
    cands = [int(c) for c in np.argsort(scores)[::-1] if keep[c]][:MAX_CANDIDATES]
    coarse = _coarse(lc, cfg)
    words_f = words_f.cpu().numpy()
    node_f = words_f // coarse
    valid_f = words_f >= 0
    P = state.mp_valid.shape[0]
    lc._index_keyframes(state, [c for c in cands if lc.kf_words.get(c) is None])
    C = MAX_CANDIDATES
    cand_ids = np.zeros(C, np.int32)
    cand_ids[: len(cands)] = cands
    words_k = np.stack([lc.kf_words[int(cand_ids[c])] if c < len(cands)
                        else np.full_like(lc.kf_words[cands[0]], -1) for c in range(C)])
    node_k = np.where(words_k >= 0, words_k // coarse, -1)
    cid = torch.as_tensor(cand_ids, dtype=torch.long, device=dev)
    mp_k = state.kf_kp_mp[cid].cpu().numpy()                  # [C, Fk]
    has_mp = (mp_k >= 0) & (words_k >= 0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    idx, ok = _bow_match_candidates(frame, state.kf_desc[cid], t(node_k), t(has_mp),
                                    t(node_f), t(valid_f), cfg)
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    alive = ok.sum(1) >= cfg.keyframe.min_matches_reloc
    if not alive.any():
        return None
    mp_ids = np.take_along_axis(mp_k, idx.astype(np.int64), axis=1)   # [C, F]
    pts_w = state.mp_xyz[t(np.clip(mp_ids, 0, P - 1).astype(np.int64))]
    sets = np.zeros((C, RANSAC_ITERS, 6), np.int32)
    for c in range(C):
        sel = np.nonzero(ok[c])[0]
        if alive[c] and len(sel) >= 6:
            sets[c] = np.stack([rng.choice(sel, 6, replace=False)
                                for _ in range(RANSAC_ITERS)])
        else:
            alive[c] = False
    if not alive.any():
        return None
    # accept at >= 10 inliers, the reference's PnPsolver RANSAC parameter
    res = pnp.ransac_pnp(pts_w, frame.xy, t(ok & alive[:, None]), t(sets), intr,
                         min_inliers=10)
    success = res.success.cpu().numpy() & alive
    n_inl = np.where(success, res.n_inliers.cpu().numpy(), -1)
    if not success.any():
        return None
    # projection widening + refinement: track_step from the PnP pose over
    # the whole map, best PnP candidate first, early out
    reloc_scale = cfg.matching.search_radius_reloc / cfg.matching.search_radius_motion
    for c in np.argsort(-n_inl)[:3]:
        if n_inl[c] < 10:
            break
        tr = tracking.track_step(state, frame, res.T_cw[c], 0, intr, cfg,
                                 radius_scale=reloc_scale, n_kf=n_kf)
        if int(tr.n_inliers) >= 2 * cfg.keyframe.min_matches_reloc:
            return tr.T_cw.cpu().numpy()
    return None


def track_reference_keyframe(state: MapState, n_kf: int, frame: Frame, lc: LoopCloser,
                             T_last: np.ndarray, intr: Intrinsics,
                             cfg: SLAMConfig) -> Optional[np.ndarray]:
    """BoW-gated recovery against the newest valid keyframe: match its
    landmark-bound features under the node gate (no projection windows),
    pose LM from the last pose, then a local-map re-track. Returns T_cw
    or None."""
    if not lc.ensure_vocabulary(state, n_kf):
        return None
    kf_valid = state.kf_valid[:n_kf].cpu().numpy()
    if not kf_valid.any():
        return None
    dev = frame.xy.device
    k_ref = int(np.nonzero(kf_valid)[0][-1])
    words_f, _ = bow.transform(lc.voc, frame.desc, frame.kp_valid)
    if lc.kf_words.get(k_ref) is None:
        lc._index_keyframes(state, [k_ref])
    words_k = lc.kf_words[k_ref]
    coarse = _coarse(lc, cfg)
    words_f = words_f.cpu().numpy()
    node_f = words_f // coarse
    valid_f = words_f >= 0
    P = state.mp_valid.shape[0]
    mp_k = state.kf_kp_mp[k_ref].cpu().numpy()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    allow = (t((node_f[:, None] == (words_k // coarse)[None, :]) & (words_k >= 0)[None, :])
             & t(valid_f)[:, None] & frame.kp_valid[:, None] & t(mp_k >= 0)[None, :])
    m = matching.masked_match(frame.desc, state.kf_desc[k_ref], allow,
                              max_dist=cfg.matching.th_low, ratio=cfg.matching.nn_ratio_bow)
    ok = m.valid.cpu().numpy()
    if ok.sum() < 15:                      # Tracking.cc:1022
        return None
    mp_ids = mp_k[m.idx.cpu().numpy()]
    pts_w = state.mp_xyz[t(np.clip(mp_ids, 0, P - 1).astype(np.int64))]
    sf = cfg.frontend.scale_factor
    sig2 = sf ** (2.0 * frame.octave.cpu().numpy().astype(np.float32))
    zero3 = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    res = pose_opt.pose_optimize(
        t(np.asarray(T_last, np.float32)), pts_w, frame.xy, t(ok), t(sig2),
        zero3, zero3, zero3, torch.zeros(1, dtype=torch.bool, device=dev),
        torch.ones(1, dtype=torch.float32, device=dev), intr, cfg.optim)
    if int(res.n_inliers) < 10:            # Tracking.cc:1090
        return None
    tr = tracking.track_step(state, frame, res.T_cw, max(n_kf - cfg.map.local_window_kf, 0),
                             intr, cfg, n_kf=n_kf)
    if int(tr.n_inliers) >= cfg.keyframe.min_inliers_recover:
        return tr.T_cw.cpu().numpy()
    return None


__all__ = ["relocalize", "track_reference_keyframe", "MAX_CANDIDATES", "RANSAC_ITERS"]
