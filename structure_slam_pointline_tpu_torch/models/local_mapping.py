"""Local mapping: keyframe insertion, triangulation, fusion, local BA
problem gathering, result write-back and culling (points half).

Counterpart of structure_slam_pointline_tpu/models/local_mapping.py; the
line halves (`create_new_lines`, `fuse_projected_lines`, `cull_lines`)
are the next slice. Descriptor matching runs through kernel 3: the epipolar
neighbour search of `create_new_points` as one [NB, F, F] batched launch
and the fuse directions as one [2W, F, F] batched launch. Scatters follow
the reference's "drop" and last-write-wins semantics
(utils/indexing.py), so the sequential fuse merges are deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import hamming, matching, twoview
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import (
    max_drop, nonzero_fixed, set_drop, set_drop2)
from structure_slam_pointline_tpu_torch.world.map_store import (
    DESC_RING, MapState, point_obs_counts)

MAX_NEW_POINTS = 512
BA_WINDOW = 8
BA_FIXED = 8
BA_LOCAL_KF = BA_WINDOW + BA_FIXED
BA_LOCAL_MP = 2048
BA_LOCAL_LN = 256
KF_CULL_WINDOW = 32


def _pow(base: float, expo: torch.Tensor) -> torch.Tensor:
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=expo.device), expo)


def _distinctive_update(ring, ring_n, lm_ids, new_desc):
    """Push each observation's descriptor into its landmark's ring and
    return (ring, ring_n, min-median-Hamming ring entry per observation)."""
    R = DESC_RING
    cap = ring.shape[0]
    safe = torch.clamp(lm_ids, 0, cap - 1).long()
    pos = ring_n[safe] % R
    ok = (lm_ids >= 0) & (lm_ids < cap)
    flat = ring.reshape(cap * R, 8)
    lin = torch.where(ok, safe * R + pos, torch.full_like(safe, -1))
    ring = set_drop(flat, lin, new_desc).reshape(cap, R, 8)
    ring_n = ring_n.clone()
    ring_n.index_put_((lm_ids[ok].long(),),
                      torch.ones_like(lm_ids[ok], dtype=ring_n.dtype), accumulate=True)
    rings = ring[safe]                                      # [N, R, 8]
    n_f = torch.clamp(ring_n[safe], max=R)
    D = hamming.hamming_pairwise(rings[:, :, None, :], rings[:, None, :, :])
    filled = torch.arange(R, device=D.device)[None, :] < n_f[:, None]
    BIG = 1 << 16
    Dm = torch.where(filled[:, None, :], D, torch.full_like(D, BIG))
    Ds = torch.sort(Dm, dim=-1).values
    med_idx = torch.clamp((n_f - 1) // 2, 0, R - 1).long()
    med = torch.gather(Ds, -1, med_idx[:, None, None].expand(-1, R, 1))[..., 0]
    med = torch.where(filled, med, torch.full_like(med, BIG))
    best_i = torch.argmin(med, dim=-1)
    best = torch.gather(rings, 1, best_i[:, None, None].expand(-1, 1, 8))[:, 0]
    return ring, ring_n, best


def insert_keyframe(state: MapState, kf_slot: int, frame_id: int, T_cw: torch.Tensor,
                    frame: Frame, feat_mp: torch.Tensor, line_ml: torch.Tensor,
                    cfg: SLAMConfig) -> MapState:
    """Write a keyframe snapshot + bind observations + landmark bookkeeping."""
    P = state.mp_valid.shape[0]
    L = state.ml_valid.shape[0]
    k = int(kf_slot)

    def row_set(t, v):
        out = t.clone()
        out[k] = v
        return out

    st = state._replace(
        kf_T_cw=row_set(state.kf_T_cw, T_cw),
        kf_valid=row_set(state.kf_valid, True),
        kf_frame_id=row_set(state.kf_frame_id, int(frame_id)),
        kf_xy=row_set(state.kf_xy, frame.xy),
        kf_desc=row_set(state.kf_desc, frame.desc),
        kf_octave=row_set(state.kf_octave, frame.octave),
        kf_angle=row_set(state.kf_angle, frame.angle),
        kf_kp_valid=row_set(state.kf_kp_valid, frame.kp_valid),
        kf_kp_mp=row_set(state.kf_kp_mp, feat_mp),
        kf_line2d=row_set(state.kf_line2d, frame.line2d),
        kf_line_ep=row_set(state.kf_line_ep, frame.line_ep),
        kf_ldesc=row_set(state.kf_ldesc, frame.ldesc),
        kf_loctave=row_set(state.kf_loctave, frame.loctave),
        kf_line_valid=row_set(state.kf_line_valid, frame.line_valid),
        kf_line_ml=row_set(state.kf_line_ml, line_ml),
    )
    mp_ids = torch.where(feat_mp >= 0, feat_mp, P)
    ring, ring_n, best_desc = _distinctive_update(st.mp_desc_ring, st.mp_ring_n,
                                                  mp_ids, frame.desc)
    st = st._replace(mp_last_kf=max_drop(st.mp_last_kf, mp_ids, k),
                     mp_desc=set_drop(st.mp_desc, mp_ids, best_desc),
                     mp_desc_ring=ring, mp_ring_n=ring_n)
    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    safe_mp = torch.clamp(feat_mp, 0, P - 1).long()
    ray = st.mp_xyz[safe_mp] - cam_center
    dist = torch.clamp(torch.linalg.norm(ray, dim=-1), min=1e-9)
    nrm = ray / dist[:, None]
    sf = cfg.frontend.scale_factor
    dmax = dist * _pow(sf, frame.octave.float())
    dmin = dmax / (sf ** (cfg.frontend.n_levels - 1))
    st = st._replace(mp_normal=set_drop(st.mp_normal, mp_ids, nrm),
                     mp_angle=set_drop(st.mp_angle, mp_ids, frame.angle),
                     mp_dist_max=set_drop(st.mp_dist_max, mp_ids, dmax),
                     mp_dist_min=set_drop(st.mp_dist_min, mp_ids, dmin))
    ml_ids = torch.where(line_ml >= 0, line_ml, L)
    lring, lring_n, lbest = _distinctive_update(st.ml_desc_ring, st.ml_ring_n,
                                                ml_ids, frame.ldesc)
    return st._replace(ml_last_kf=max_drop(st.ml_last_kf, ml_ids, k),
                       ml_desc=set_drop(st.ml_desc, ml_ids, lbest),
                       ml_desc_ring=lring, ml_ring_n=lring_n)


class NewPointsResult(NamedTuple):
    state: MapState
    n_new: torch.Tensor
    n_clipped: torch.Tensor


def _kinv(intr: Intrinsics, device) -> torch.Tensor:
    return torch.tensor([[1.0 / intr.fx, 0.0, -intr.cx / intr.fx],
                         [0.0, 1.0 / intr.fy, -intr.cy / intr.fy],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def create_new_points(state: MapState, k_new: int, nb_ids: torch.Tensor, n_mp: int,
                      intr: Intrinsics, cfg: SLAMConfig) -> NewPointsResult:
    """Triangulate the new keyframe's unbound features against all
    `nb_ids` neighbours in one batched pass; each feature keeps its first
    (strongest-covisibility) accepting neighbour."""
    F = state.kf_xy.shape[1]
    P = state.mp_valid.shape[0]
    K_cap = state.kf_valid.shape[0]
    dev = state.kf_xy.device
    T1 = state.kf_T_cw[k_new]
    K = intr.K(dev)
    sf = cfg.frontend.scale_factor
    NB = nb_ids.shape[0]

    free1 = state.kf_kp_valid[k_new] & (state.kf_kp_mp[k_new] < 0)
    uv1 = state.kf_xy[k_new]
    oct1 = state.kf_octave[k_new]
    sig2_1 = _pow(sf, 2.0 * oct1.float())
    p1 = torch.cat([uv1, torch.ones((F, 1), device=dev)], dim=1)
    P1 = K @ T1[:3, :4]
    c1 = -T1[:3, :3].T @ T1[:3, 3]
    Kinv = _kinv(intr, dev)

    nb_safe = torch.clamp(nb_ids, 0, K_cap - 1).long()
    nb_present = (nb_ids >= 0) & state.kf_valid[nb_safe] & (nb_safe != k_new)
    T2 = state.kf_T_cw[nb_safe]                                     # [NB, 4, 4]
    free2 = state.kf_kp_valid[nb_safe] & (state.kf_kp_mp[nb_safe] < 0) \
        & nb_present[:, None]
    T12 = T1[None] @ lie.se3_inverse(T2)
    R12, t12 = T12[:, :3, :3], T12[:, :3, 3]
    F12 = Kinv.T[None] @ lie.hat(t12) @ R12 @ Kinv[None]            # [NB, 3, 3]
    uv2 = state.kf_xy[nb_safe]                                      # [NB, F, 2]
    p2 = torch.cat([uv2, torch.ones((NB, F, 1), device=dev)], dim=2)
    l2 = p1[None] @ F12                                             # [NB, F, 3]
    num = l2 @ p2.transpose(1, 2)                                   # [NB, F, F]
    d2 = num ** 2 / torch.clamp((l2[..., 0] ** 2 + l2[..., 1] ** 2)[..., None],
                                min=1e-12)
    oct2 = state.kf_octave[nb_safe]
    sig2_2 = _pow(sf, 2.0 * oct2.float())                           # [NB, F]
    allow = (d2 <= 3.84 * sig2_2[:, None, :]) & free1[None, :, None] & free2[:, None, :]
    allow = allow & (torch.abs(oct1[None, :, None] - oct2[:, None, :]) <= 1)
    m = matching.masked_match(state.kf_desc[k_new], state.kf_desc[nb_safe], allow,
                              max_dist=cfg.matching.th_low, ratio=0.8)
    midx = m.idx.long()
    P2 = K[None] @ T2[:, :3, :4]
    uv2m = torch.gather(uv2, 1, midx[..., None].expand(-1, -1, 2))  # [NB, F, 2]
    X = twoview.triangulate(P1.expand(NB, 3, 4), P2, uv1.expand(NB, F, 2), uv2m)

    def cam_pc(T, X):
        return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]

    def reproj_err(pc, uv):
        zz = torch.where(torch.abs(pc[..., 2]) < 1e-9,
                         torch.full_like(pc[..., 2], 1e-9), pc[..., 2])
        u = intr.fx * pc[..., 0] / zz + intr.cx
        v = intr.fy * pc[..., 1] / zz + intr.cy
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2

    pc1 = cam_pc(T1, X)
    pc2 = cam_pc(T2, X)
    e1 = reproj_err(pc1, uv1[None])
    e2 = reproj_err(pc2, uv2m)
    c2 = -(T2[:, :3, :3].transpose(1, 2) @ T2[:, :3, 3, None])[..., 0]
    r1 = X - c1
    r2 = X - c2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    good = (m.valid & (pc1[..., 2] > 0.05) & (pc2[..., 2] > 0.05) & (cosp < 0.9998)
            & (e1 <= 5.991 * sig2_1[None]) & (e2 <= 5.991 * torch.gather(sig2_2, 1, midx))
            & torch.all(torch.isfinite(X), dim=-1))

    nb_rank = torch.arange(NB, dtype=torch.int32, device=dev)[:, None]
    dir_of = torch.argmin(torch.where(good, nb_rank, NB), dim=0)    # [F]
    chosen = good.any(0)
    fidx = torch.arange(F, device=dev)
    Xc = X[dir_of, fidx]
    refc = midx[dir_of, fidx]
    nbc = nb_safe[dir_of]

    order = nonzero_fixed(chosen, MAX_NEW_POINTS)
    taking = order >= 0
    n_good = chosen.sum().to(torch.int32)
    slot = n_mp + torch.cumsum(taking.long(), 0) - 1
    pool_drop = taking & (slot >= P)
    slot = torch.where(taking & (slot < P), slot, torch.full_like(slot, P))
    n_new = (taking & ~pool_drop).sum().to(torch.int32)
    n_clipped = (torch.clamp(n_good - MAX_NEW_POINTS, min=0)
                 + pool_drop.sum()).to(torch.int32)
    feat = torch.clamp(order, 0, F - 1)
    desc_new = state.kf_desc[k_new][feat]
    k32 = int(k_new)
    ring0 = torch.where(slot < P, slot * DESC_RING, torch.full_like(slot, -1))
    st = state._replace(
        mp_xyz=set_drop(state.mp_xyz, slot, Xc[feat]),
        mp_valid=set_drop(state.mp_valid, slot, True),
        mp_desc=set_drop(state.mp_desc, slot, desc_new),
        mp_first_kf=set_drop(state.mp_first_kf, slot, k32),
        mp_last_kf=set_drop(state.mp_last_kf, slot, k32),
        mp_visible=set_drop(state.mp_visible, slot, 1),
        mp_found=set_drop(state.mp_found, slot, 1),
        mp_desc_ring=set_drop(state.mp_desc_ring.reshape(-1, 8), ring0,
                              desc_new).reshape(state.mp_desc_ring.shape),
        mp_ring_n=set_drop(state.mp_ring_n, slot, 1),
    )
    dist = torch.linalg.norm(Xc[feat] - c1, dim=1)
    nrm = (Xc[feat] - c1) / torch.clamp(dist, min=1e-9)[:, None]
    dmax = dist * _pow(sf, oct1[feat].float())
    dmin = dmax / (sf ** (cfg.frontend.n_levels - 1))
    st = st._replace(
        mp_normal=set_drop(st.mp_normal, slot, nrm),
        mp_angle=set_drop(st.mp_angle, slot, state.kf_angle[k_new][feat]),
        mp_dist_max=set_drop(st.mp_dist_max, slot, dmax),
        mp_dist_min=set_drop(st.mp_dist_min, slot, dmin),
    )
    # the reference scatters at the CLIPPED index, so the padding entries
    # (order -1 -> feature 0, value -1) come last and win at feature 0:
    # a new point born from feature 0 keeps no binding in the new
    # keyframe's row whenever fewer than MAX_NEW_POINTS were taken
    new_mp_of_feat = set_drop(torch.full((F,), -1, dtype=torch.int32, device=dev),
                              feat, torch.where(slot < P, slot, -1).to(torch.int32))
    row = state.kf_kp_mp[k_new]
    kp_mp_new = torch.where((row < 0) & (new_mp_of_feat >= 0), new_mp_of_feat, row)
    kf_kp_mp = st.kf_kp_mp.clone()
    kf_kp_mp[k_new] = kp_mp_new
    ok_new = taking & (slot < P)
    rows = torch.where(ok_new, nbc[feat], torch.full_like(feat, K_cap))
    cols = torch.where(ok_new, refc[feat], torch.full_like(feat, F))
    kf_kp_mp = set_drop2(kf_kp_mp, rows, cols, slot.to(torch.int32))
    return NewPointsResult(state=st._replace(kf_kp_mp=kf_kp_mp), n_new=n_new,
                           n_clipped=n_clipped)


def cull_keyframes(state: MapState, n_kf: int, cfg: SLAMConfig,
                   obs: torch.Tensor | None = None,
                   cand_ids: torch.Tensor | None = None) -> MapState:
    """Invalidate a candidate keyframe when > 90% of its (> 20) landmarks
    are seen by at least 3 other keyframes; 0/1 and the newest two stay."""
    K, F = state.kf_kp_mp.shape
    P = state.mp_valid.shape[0]
    W = min(KF_CULL_WINDOW, K)
    dev = state.kf_kp_mp.device
    if obs is None:
        obs = point_obs_counts(state)
    if cand_ids is None:
        lo = min(max(n_kf - W, 0), K - W)
        cand_ids = torch.arange(W, device=dev) + lo
    ids = cand_ids
    rows = torch.clamp(ids, 0, K - 1).long()
    present = (ids >= 0) & (ids < n_kf)
    win_mp = torch.where(present[:, None], state.kf_kp_mp[rows], -1)
    has_edge = win_mp >= 0
    redundant = has_edge & (obs[torch.clamp(win_mp, 0, P - 1).long()] >= 4)
    n_obs_kf = has_edge.sum(1)
    n_red_kf = redundant.sum(1)
    ratio = n_red_kf.float() / torch.clamp(n_obs_kf.float(), min=1.0)
    win_valid = state.kf_valid[rows] & present
    protected = (ids <= 1) | (ids >= n_kf - 2) | ~win_valid
    cull = ~protected & (ratio > cfg.map.kf_cull_redundancy) & (n_obs_kf > 20)
    drop = torch.where(cull, rows, torch.full_like(rows, K))
    return state._replace(kf_valid=set_drop(state.kf_valid, drop, False),
                          kf_kp_mp=set_drop(state.kf_kp_mp, drop, -1),
                          kf_line_ml=set_drop(state.kf_line_ml, drop, -1))


def _compose_redirect(redirect: torch.Tensor) -> torch.Tensor:
    for _ in range(3):
        redirect = redirect[redirect.long()]
    return redirect


def _dedup_row_table(tbl: torch.Tensor, cap: int) -> torch.Tensor:
    """Clear repeated landmark ids within each row, keeping the first."""
    K, F = tbl.shape
    dev = tbl.device
    rows = torch.arange(K, device=dev)[:, None].expand(K, F)
    feats = torch.arange(F, dtype=torch.int32, device=dev)[None, :].expand(K, F)
    ids = torch.where(tbl >= 0, tbl, cap).long()
    first = torch.full((K, cap + 1), F, dtype=torch.int32, device=dev)
    lin = (rows * (cap + 1) + ids).reshape(-1)
    first = first.reshape(-1).scatter_reduce(0, lin, feats.reshape(-1),
                                             reduce="amin").reshape(K, cap + 1)
    keep = (tbl >= 0) & (first[rows, ids] == feats)
    return torch.where(keep, tbl, -1)


def fuse_projected_points(state: MapState, k_new: int, nb_ids: torch.Tensor,
                          intr: Intrinsics, cfg: SLAMConfig) -> MapState:
    """Projection-space landmark fusion (SearchInNeighbors + Fuse): the 2W
    directions (new KF -> neighbours and back) match as ONE batched
    kernel-3 launch against the pre-fuse snapshot; the merge / add scatters
    then apply direction by direction, in the reference's order."""
    K, F = state.kf_kp_mp.shape
    P = state.mp_valid.shape[0]
    W = nb_ids.shape[0]
    dev = state.kf_kp_mp.device
    obs = point_obs_counts(state)
    sf = cfg.frontend.scale_factor
    nb_safe = torch.clamp(nb_ids, 0, K - 1).long()
    nb_present = (nb_ids >= 0) & state.kf_valid[nb_safe] & (nb_safe != k_new)
    k_new_b = torch.full((W,), int(k_new), dtype=torch.long, device=dev)
    a_ids = torch.cat([k_new_b, nb_safe])
    b_ids = torch.cat([nb_safe, k_new_b])
    dir_present = torch.cat([nb_present, nb_present])

    ids = state.kf_kp_mp[a_ids]                                    # [2W, F]
    has = (ids >= 0) & dir_present[:, None]
    safe = torch.clamp(ids, 0, P - 1).long()
    X = state.mp_xyz[safe]
    dmin = state.mp_dist_min[safe]
    dmax = state.mp_dist_max[safe]
    nrm = state.mp_normal[safe]
    desc = state.mp_desc[safe]
    T_b = state.kf_T_cw[b_ids]
    pc = X @ T_b[:, :3, :3].transpose(1, 2) + T_b[:, None, :3, 3]
    uv, z = cam_utils.project(intr, pc)
    dist = torch.linalg.norm(pc, dim=-1)
    no_band = (dmax <= 0.0) | (dmax >= 1e8)
    band_ok = no_band | ((dist >= dmin * 0.8) & (dist <= dmax * 1.2))
    cam_c = -(T_b[:, :3, :3].transpose(1, 2) @ T_b[:, :3, 3, None])[..., 0]
    ray = X - cam_c[:, None, :]
    ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=1e-9)
    has_nrm = torch.linalg.norm(nrm, dim=-1) > 0.5
    view_ok = torch.where(has_nrm, torch.sum(ray * nrm, dim=-1) > 0.5, True)
    pred_oct = matching.predict_octave(dist, torch.where(no_band, dist, dmax), sf,
                                       cfg.frontend.n_levels)
    radius = 3.0 * _pow(sf, pred_oct.float())
    vis = (has & (z > 0.1) & band_ok & view_ok
           & cam_utils.in_image(cfg.camera, uv, margin=2.0))
    kxy_b = state.kf_xy[b_ids]
    koct_b = state.kf_octave[b_ids]
    allow = matching.window_mask(uv, vis, kxy_b, state.kf_kp_valid[b_ids], radius,
                                 kp_octave=koct_b, pred_octave=pred_oct,
                                 octave_slack=1)
    m = matching.masked_match(desc, state.kf_desc[b_ids], allow,
                              max_dist=cfg.matching.th_low)
    midx = torch.clamp(m.idx.long(), 0, F - 1)
    kp_uv = torch.gather(kxy_b, 1, midx[..., None].expand(-1, -1, 2))
    kp_oct = torch.gather(koct_b, 1, midx)
    e2 = torch.sum((uv - kp_uv) ** 2, dim=-1)
    m_valid = m.valid & (e2 <= 5.991 * _pow(sf, 2.0 * kp_oct.float()))

    kf_kp_mp = state.kf_kp_mp
    mp_valid = state.mp_valid
    redirect = torch.arange(P, dtype=torch.int32, device=dev)
    clampP = lambda t: torch.clamp(t, 0, P - 1).long()  # noqa: E731
    for i in range(2 * W):
        b = b_ids[i]
        ids_i = ids[i]
        ids_r = torch.where(ids_i >= 0, redirect[clampP(ids_i)], -1)
        ids_r = torch.where(mp_valid[clampP(ids_r)], ids_r, -1)
        feat = midx[i]
        hit = m_valid[i] & (ids_r >= 0)
        row_b = kf_kp_mp[b]
        cur = row_b[feat]
        cur_r = torch.where(cur >= 0, redirect[clampP(cur)], -1)
        cand = ids_r
        mrg = hit & (cur_r >= 0) & (cand >= 0) & (cur_r != cand)
        keep_cand = obs[clampP(cand)] >= obs[clampP(cur_r)]
        src = torch.where(keep_cand, cur_r, cand)
        dst = torch.where(keep_cand, cand, cur_r)
        redirect = set_drop(redirect, torch.where(mrg, src, P),
                            torch.where(mrg, dst, 0))
        mp_valid = set_drop(mp_valid, torch.where(mrg, src, P), False)
        present_b = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        present_b[torch.where(row_b >= 0, row_b, P).long()] = True
        add = hit & (cur_r < 0) & (cand >= 0) & ~present_b[clampP(cand)]
        new_row = set_drop(row_b, torch.where(add, feat, F), torch.where(add, cand, -1))
        kf_kp_mp = kf_kp_mp.clone()
        kf_kp_mp[b] = new_row
    redirect = _compose_redirect(redirect)
    kf_kp_mp = torch.where(kf_kp_mp >= 0, redirect[clampP(kf_kp_mp)], kf_kp_mp)
    kf_kp_mp = torch.where((kf_kp_mp >= 0) & mp_valid[clampP(kf_kp_mp)], kf_kp_mp, -1)
    kf_kp_mp = _dedup_row_table(kf_kp_mp, P)
    return state._replace(kf_kp_mp=kf_kp_mp, mp_valid=mp_valid)


def apply_ba_result(state: MapState, local_kf: torch.Tensor, local_mp: torch.Tensor,
                    ba: local_ba.BAResult) -> MapState:
    """Scatter optimized poses/points back (non-finite updates dropped)
    and erase outlier observations."""
    K = state.kf_valid.shape[0]
    P = state.mp_valid.shape[0]
    kf_fin = torch.all(torch.isfinite(ba.kf_T_cw).reshape(-1, 16), dim=1)
    mp_fin = torch.all(torch.isfinite(ba.mp_xyz), dim=1)
    kf_ids = torch.where((local_kf >= 0) & kf_fin, local_kf, K)
    mp_ids = torch.where((local_mp >= 0) & mp_fin, local_mp, P)
    st = state._replace(kf_T_cw=set_drop(state.kf_T_cw, kf_ids, ba.kf_T_cw),
                        mp_xyz=set_drop(state.mp_xyz, mp_ids, ba.mp_xyz))
    rows = torch.clamp(local_kf, 0, K - 1).long()
    cur = st.kf_kp_mp[rows]
    keep = (cur < 0) | ba.edge_inlier
    return st._replace(kf_kp_mp=set_drop(st.kf_kp_mp, kf_ids,
                                         torch.where(keep, cur, -1)))


def gather_ba_problem(state: MapState, n_kf: int, cfg: SLAMConfig):
    """Last BA_WINDOW keyframes free, the BA_FIXED before them fixed,
    keyframe 0 gauge-fixed; returns (prob, local_kf, local_mp)."""
    lo_free = max(n_kf - BA_WINDOW, 0)
    lo_fix = max(lo_free - BA_FIXED, 0)
    ids = list(range(lo_fix, n_kf))
    pad = BA_LOCAL_KF - len(ids)
    dev = state.kf_valid.device
    local_kf = torch.tensor(ids + [-1] * pad, dtype=torch.int32, device=dev)
    free = torch.tensor([(i >= lo_free and i != 0) for i in ids] + [False] * pad,
                        device=dev)
    prob, local_kf, local_mp, _ = _gather_ba_device(state, local_kf, free, cfg)
    return prob, local_kf, local_mp


def _gather_ba_device(state: MapState, local_kf: torch.Tensor, free: torch.Tensor,
                      cfg: SLAMConfig, n_mp_cap: int = BA_LOCAL_MP):
    """(prob, local_kf, local_mp, n_dropped): landmarks with edges in the
    window, up to n_mp_cap of them, indexed locally."""
    K = state.kf_valid.shape[0]
    P = state.mp_valid.shape[0]
    dev = state.kf_valid.device
    rows = torch.clamp(local_kf, 0, K - 1).long()
    kf_ok = (local_kf >= 0) & state.kf_valid[rows]
    edge_mp_glob = torch.where(kf_ok[:, None], state.kf_kp_mp[rows], -1)
    in_local = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    in_local[torch.where(edge_mp_glob >= 0, edge_mp_glob, P).reshape(-1).long()] = True
    in_local = in_local[:P] & state.mp_valid
    local_mp = nonzero_fixed(in_local, n_mp_cap).to(torch.int32)
    mp_safe = torch.clamp(local_mp, 0, P - 1).long()
    g2l = torch.full((P + 1,), -1, dtype=torch.int32, device=dev)
    g2l = set_drop(g2l, torch.where(local_mp >= 0, local_mp, P),
                   torch.arange(n_mp_cap, dtype=torch.int32, device=dev))
    edge_mp_local = torch.where(edge_mp_glob >= 0,
                                g2l[torch.clamp(edge_mp_glob, 0, P).long()], -1)
    sigma2 = _pow(cfg.frontend.scale_factor, 2.0 * state.kf_octave[rows].float())
    prob = local_ba.BAProblem(
        kf_T_cw=state.kf_T_cw[rows], kf_free=free & kf_ok, kf_valid=kf_ok,
        obs_uv=state.kf_xy[rows], obs_sigma2=sigma2, edge_mp=edge_mp_local,
        edge_valid=(edge_mp_local >= 0) & state.kf_kp_valid[rows],
        mp_xyz=state.mp_xyz[mp_safe],
        mp_valid=(local_mp >= 0) & state.mp_valid[mp_safe])
    n_drop = torch.clamp(in_local.sum().to(torch.int32) - n_mp_cap, min=0)
    return prob, local_kf, local_mp, n_drop


def cull_points(state: MapState, n_kf: int, cfg: SLAMConfig,
                obs: torch.Tensor | None = None) -> MapState:
    """Drop landmarks with found/visible < 0.25, or with <= 2 observations
    two keyframes after birth; clear dangling references."""
    if obs is None:
        obs = point_obs_counts(state)
    ratio = state.mp_found.float() / torch.clamp(state.mp_visible.float(), min=1.0)
    age = n_kf - state.mp_first_kf
    bad = state.mp_valid & ((ratio < cfg.map.point_cull_found_ratio)
                            | ((age >= 2) & (obs <= 2) & (state.mp_first_kf > 0)))
    bad = bad & (age >= 2)
    mp_valid = state.mp_valid & ~bad
    P = mp_valid.shape[0]
    ref_ok = mp_valid[torch.clamp(state.kf_kp_mp, 0, P - 1).long()] & (state.kf_kp_mp >= 0)
    return state._replace(mp_valid=mp_valid,
                          kf_kp_mp=torch.where(ref_ok, state.kf_kp_mp, -1))


__all__ = ["MAX_NEW_POINTS", "BA_WINDOW", "BA_FIXED", "BA_LOCAL_KF", "BA_LOCAL_MP",
           "insert_keyframe", "create_new_points", "NewPointsResult",
           "fuse_projected_points", "apply_ba_result", "gather_ba_problem",
           "_gather_ba_device", "cull_points", "cull_keyframes"]
