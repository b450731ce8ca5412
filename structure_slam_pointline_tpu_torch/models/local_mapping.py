"""Local mapping: keyframe insertion, triangulation, fusion, local BA
problem gathering, result write-back and culling, points and lines.

Counterpart of structure_slam_pointline_tpu/models/local_mapping.py.
Descriptor matching runs through kernel 3 in the neighbour searches of
`create_new_points` / `create_new_lines` ([NB, M, N] batched launches).
The projection fuses run through kernels 22 and 23: `fuse_match_points` /
`fuse_match_lines` project, gate and window-match the 2W directions in
one launch (csrc/fuse_match.cu; no [2W, M, N] mask), `fuse_merge` walks
the directions' merges in the reference's order and
`ops/matching.fuse_finish` composes the redirects, applies them and
dedups each row (csrc/fuse_merge.cu; no [K, P + 1] table; both launch
from ops/matching.py, as the loop fuse's do). Their `_plain` versions are
the reference's formulation in torch (the window mask, kernel 3, the
host loop of scatters). Scatters follow the reference's "drop" and
last-write-wins semantics (utils/indexing.py), so the sequential fuse
merges are deterministic.

`fuse_duplicate_points_3d` / `fuse_duplicate_lines_3d` are the reference's
landmark-space dedup, a retired heuristic that no path calls in either
package (its own tests still run the points one). The pair search of each,
recent landmarks against the whole pool, is CUDA kernel 20 / 21
(csrc/fuse3d.cu); `fuse3d_points_match_plain` / `fuse3d_lines_match_plain`
are their plain versions, which round every product and sum on its own in
the reference's order, as the kernels do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import SLAMConfig
from structure_slam_pointline_tpu_torch.models.tracking import Frame
from structure_slam_pointline_tpu_torch.ops import hamming, matching, twoview
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils import fmath
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import (
    max_drop, nonzero_fixed, set_drop, set_drop2)
from structure_slam_pointline_tpu_torch.world.map_store import (
    DESC_RING, MapState, line_obs_counts, point_obs_counts)

MAX_NEW_POINTS = 512
MAX_NEW_LINES = 64
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


class NewLinesResult(NamedTuple):
    state: MapState
    n_new: torch.Tensor
    n_clipped: torch.Tensor


def create_new_lines(state: MapState, k_new: int, nb_ids: torch.Tensor, n_ml: int,
                     intr: Intrinsics, cfg: SLAMConfig) -> NewLinesResult:
    """Triangulate the new keyframe's unbound lines against all `nb_ids`
    neighbours in one batched pass: LBD match (th_high + the per-neighbour
    MAD margin gate), the matched neighbour line's plane cut by the new
    keyframe's endpoint rays, depth / length gates; each line keeps its
    first (strongest-covisibility) accepting neighbour."""
    LF = state.kf_line2d.shape[1]
    L = state.ml_valid.shape[0]
    K_cap = state.kf_valid.shape[0]
    dev = state.kf_line2d.device
    T1 = state.kf_T_cw[k_new]
    K = intr.K(dev)
    NB = nb_ids.shape[0]
    free1 = state.kf_line_valid[k_new] & (state.kf_line_ml[k_new] < 0)
    c1 = -T1[:3, :3].T @ T1[:3, 3]
    Rwc1 = T1[:3, :3].T
    ep1 = state.kf_line_ep[k_new]
    desc1 = state.kf_ldesc[k_new]
    nb_safe = torch.clamp(nb_ids, 0, K_cap - 1).long()
    nb_present = (nb_ids >= 0) & state.kf_valid[nb_safe] & (nb_safe != k_new)

    def ray_dir(uv):
        xn = torch.stack([(uv[:, 0] - intr.cx) / intr.fx, (uv[:, 1] - intr.cy) / intr.fy,
                          torch.ones(LF, device=dev)], dim=1)
        return xn @ Rwc1.T

    d_s, d_e = ray_dir(ep1[:, 0:2]), ray_dir(ep1[:, 2:4])
    T2 = state.kf_T_cw[nb_safe]                                      # [NB, 4, 4]
    free2 = state.kf_line_valid[nb_safe] & (state.kf_line_ml[nb_safe] < 0) \
        & nb_present[:, None]
    allow = free1[None, :, None] & free2[:, None, :]                 # [NB, LF, LF]
    m = matching.masked_match(desc1, state.kf_ldesc[nb_safe], allow,
                              max_dist=cfg.matching.th_high)
    valid = matching.mad_margin_gate(m, scale=cfg.matching.line_mad_ratio)
    midx = m.idx.long()
    P2 = K[None] @ T2[:, :3, :4]                                     # [NB, 3, 4]
    l2 = torch.gather(state.kf_line2d[nb_safe], 1, midx[..., None].expand(-1, -1, 3))
    pi2 = l2 @ P2                                                    # [NB, LF, 4]

    def intersect(d):
        num = pi2[..., :3] @ c1 + pi2[..., 3]
        den = torch.sum(pi2[..., :3] * d[None], dim=-1)
        lam = -num / torch.where(torch.abs(den) < 1e-9, torch.full_like(den, 1e-9), den)
        return c1 + d[None] * lam[..., None], lam

    Xs, lam_s = intersect(d_s)
    Xe, lam_e = intersect(d_e)

    def depth_in(T, X):
        return (X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3])[..., 2]

    z1s, z1e = depth_in(T1, Xs), depth_in(T1, Xe)
    z2s, z2e = depth_in(T2, Xs), depth_in(T2, Xe)
    seg_len = torch.linalg.norm(Xe - Xs, dim=-1)
    depth_ratio = torch.minimum(z1s, z1e) / torch.clamp(torch.maximum(z1s, z1e), min=1e-9)
    mid_depth = 0.5 * (z1s + z1e)
    good = (valid & (z1s > 0.05) & (z1e > 0.05) & (z2s > 0.05) & (z2e > 0.05)
            & (lam_s > 0.0) & (lam_e > 0.0) & (depth_ratio > 0.3)
            & (seg_len < 1.3 * mid_depth) & (seg_len > 0.01)
            & torch.all(torch.isfinite(Xs), dim=-1) & torch.all(torch.isfinite(Xe), dim=-1))

    nb_rank = torch.arange(NB, dtype=torch.int32, device=dev)[:, None]
    dir_of = torch.argmin(torch.where(good, nb_rank, NB), dim=0)     # [LF]
    chosen = good.any(0)
    lidx = torch.arange(LF, device=dev)
    eps6 = torch.cat([Xs[dir_of, lidx], Xe[dir_of, lidx]], dim=1)    # [LF, 6]
    refc = midx[dir_of, lidx]
    nbc = nb_safe[dir_of]

    order = nonzero_fixed(chosen, MAX_NEW_LINES)
    taking = order >= 0
    n_good = chosen.sum().to(torch.int32)
    slot = n_ml + torch.cumsum(taking.long(), 0) - 1
    pool_drop = taking & (slot >= L)
    slot = torch.where(taking & (slot < L), slot, torch.full_like(slot, L))
    n_new = (taking & ~pool_drop).sum().to(torch.int32)
    n_clipped = (torch.clamp(n_good - MAX_NEW_LINES, min=0) + pool_drop.sum()).to(torch.int32)
    feat = torch.clamp(order, 0, LF - 1)
    desc_new = desc1[feat]
    k32 = int(k_new)
    ring0 = torch.where(slot < L, slot * DESC_RING, torch.full_like(slot, -1))
    st = state._replace(
        ml_endpoints=set_drop(state.ml_endpoints, slot, eps6[feat]),
        ml_valid=set_drop(state.ml_valid, slot, True),
        ml_desc=set_drop(state.ml_desc, slot, desc_new),
        ml_first_kf=set_drop(state.ml_first_kf, slot, k32),
        ml_last_kf=set_drop(state.ml_last_kf, slot, k32),
        ml_visible=set_drop(state.ml_visible, slot, 1),
        ml_found=set_drop(state.ml_found, slot, 1),
        ml_desc_ring=set_drop(state.ml_desc_ring.reshape(-1, 8), ring0,
                              desc_new).reshape(state.ml_desc_ring.shape),
        ml_ring_n=set_drop(state.ml_ring_n, slot, 1),
    )
    # scattered at the clipped index, as the reference does: padding
    # entries (order -1 -> line 0, value -1) come last and win at line 0
    new_ml_of_line = set_drop(torch.full((LF,), -1, dtype=torch.int32, device=dev),
                              feat, torch.where(slot < L, slot, -1).to(torch.int32))
    row = state.kf_line_ml[k_new]
    ml_new = torch.where((row < 0) & (new_ml_of_line >= 0), new_ml_of_line, row)
    kf_line_ml = st.kf_line_ml.clone()
    kf_line_ml[k_new] = ml_new
    ok_new = taking & (slot < L)
    rows = torch.where(ok_new, nbc[feat], torch.full_like(feat, K_cap))
    cols = torch.where(ok_new, refc[feat], torch.full_like(feat, LF))
    kf_line_ml = set_drop2(kf_line_ml, rows, cols, slot.to(torch.int32))
    return NewLinesResult(state=st._replace(kf_line_ml=kf_line_ml), n_new=n_new,
                          n_clipped=n_clipped)


def cull_lines(state: MapState, n_kf: int, cfg: SLAMConfig) -> MapState:
    """MapLineCulling: found/visible < 0.6, or at most one observation,
    two keyframes after birth; clear dangling references."""
    obs = line_obs_counts(state)
    ratio = state.ml_found.float() / torch.clamp(state.ml_visible.float(), min=1.0)
    age = n_kf - state.ml_first_kf
    bad = state.ml_valid & (age >= 2) & ((ratio < cfg.map.line_cull_found_ratio)
                                         | ((age >= 2) & (obs <= 1)))
    ml_valid = state.ml_valid & ~bad
    L = ml_valid.shape[0]
    ref_ok = ml_valid[torch.clamp(state.kf_line_ml, 0, L - 1).long()] & (state.kf_line_ml >= 0)
    return state._replace(ml_valid=ml_valid,
                          kf_line_ml=torch.where(ref_ok, state.kf_line_ml, -1))


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


FUSE3D_RECENT_MP = 512
FUSE3D_RECENT_ML = 128


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """(x0 * x0 + x1 * x1) + x2 * x2 over the last axis, each op rounded."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _gated_argmin(cand: torch.Tensor, desc_r: torch.Tensor, desc: torch.Tensor, th: int):
    """(best [R] int64, has [R] bool): among the pairs the geometric gates
    passed, the smallest Hamming distance <= th and the first index that
    reaches it (jnp.argmin over a BIG-filled row; an empty row gives 0)."""
    r, o = torch.nonzero(cand, as_tuple=True)
    dd = hamming.hamming_pairwise(desc_r[r], desc[o])
    ok = dd <= th
    full = torch.full(cand.shape, hamming.BIG, dtype=torch.int32, device=cand.device)
    full[r[ok], o[ok]] = dd[ok]
    return torch.argmin(full, dim=1), (full < hamming.BIG).any(dim=1)


def fuse3d_points_match_plain(xyz, desc, valid, first_kf, rows, th_low: int):
    """Kernel 20's plain version: for each pool row in `rows` [R], the
    older valid landmark (smaller first keyframe) within 1% of its
    distance, d2 as |a|^2 + |b|^2 - 2 a.b (local_mapping.py:609-613), with
    the smallest descriptor distance <= th_low. Returns (best, has)."""
    xr = xyz[rows]
    nr = _norm3(xr)
    d2 = (nr[:, None] + _norm3(xyz)[None, :]) - 2.0 * _dot3(xr[:, None, :], xyz[None, :, :])
    thresh = 0.01 * torch.clamp(torch.sqrt(nr), min=1.0)
    older = valid[None, :] & (first_kf[None, :] < first_kf[rows][:, None])
    cand = older & (d2 <= (thresh * thresh)[:, None])
    return _gated_argmin(cand, desc[rows], desc, th_low)


def fuse3d_points_match(xyz, desc, valid, first_kf, rows, th_low: int):
    """Duplicate search of `fuse_duplicate_points_3d`. CPU tensors ->
    plain version; CUDA tensors -> kernel 20 (or raise)."""
    if xyz.device.type == "cpu":
        return fuse3d_points_match_plain(xyz, desc, valid, first_kf, rows, th_low)
    name = "fuse_points_3d"
    for t, dt in ((xyz, torch.float32), (desc, torch.int32), (valid, torch.bool),
                  (first_kf, torch.int32)):
        kernels.check_dtype(name, t, dt)
    rows = rows.to(torch.int32).contiguous()
    ins = [xyz.contiguous(), desc.contiguous(), valid.contiguous(), first_kf.contiguous(),
           rows]
    dev = kernels.check_cuda(name, *ins)
    R, P = rows.shape[0], xyz.shape[0]
    best = torch.empty((R,), dtype=torch.int64, device=dev)
    has = torch.empty((R,), dtype=torch.bool, device=dev)
    if R:
        kernels.launch(name, *[kernels.ptr(t) for t in ins], R, P, int(th_low),
                       kernels.ptr(best), kernels.ptr(has))
    return best, has


def fuse3d_lines_match_plain(endpoints, desc, valid, first_kf, rows, th_high: int):
    """Kernel 21's plain version (local_mapping.py:656-699): for each pool
    row in `rows` [R], the older valid line nearly parallel (|u_r . u_o| >
    0.996) whose infinite line passes within 2% of the distance of both
    endpoints, overlapping more than a quarter of it, with the smallest
    descriptor distance <= th_high. Returns (best, has)."""
    s_o, e_o = endpoints[:, :3], endpoints[:, 3:]
    s_r, e_r = s_o[rows], e_o[rows]
    d_o = e_o - s_o
    len_o = torch.clamp(torch.sqrt(_norm3(d_o)), min=1e-9)
    u_o = d_o / len_o[:, None]
    d_r = e_r - s_r
    len_r = torch.clamp(torch.sqrt(_norm3(d_r)), min=1e-9)
    u_r = d_r / len_r[:, None]
    cos_ru = torch.abs(_dot3(u_r[:, None, :], u_o[None, :, :]))

    def perp(p_r):
        rel = p_r[:, None, :] - s_o[None, :, :]
        t = _dot3(rel, u_o[None, :, :])
        foot = rel - t[..., None] * u_o[None, :, :]
        return torch.sqrt(_norm3(foot)), t

    dist_s, t_s = perp(s_r)
    dist_e, t_e = perp(e_r)
    overlap = (torch.minimum(torch.maximum(t_s, t_e), len_o[None, :])
               - torch.clamp(torch.minimum(t_s, t_e), min=0.0))
    tol = 0.02 * torch.clamp(torch.sqrt(_norm3(0.5 * (s_r + e_r))), min=1.0)
    older = valid[None, :] & (first_kf[None, :] < first_kf[rows][:, None])
    cand = (older & (cos_ru > 0.996) & (dist_s < tol[:, None]) & (dist_e < tol[:, None])
            & (overlap > (0.25 * len_r)[:, None]))
    return _gated_argmin(cand, desc[rows], desc, th_high)


def fuse3d_lines_match(endpoints, desc, valid, first_kf, rows, th_high: int):
    """Duplicate search of `fuse_duplicate_lines_3d`. CPU tensors ->
    plain version; CUDA tensors -> kernel 21 (or raise)."""
    if endpoints.device.type == "cpu":
        return fuse3d_lines_match_plain(endpoints, desc, valid, first_kf, rows, th_high)
    name = "fuse_lines_3d"
    for t, dt in ((endpoints, torch.float32), (desc, torch.int32), (valid, torch.bool),
                  (first_kf, torch.int32)):
        kernels.check_dtype(name, t, dt)
    rows = rows.to(torch.int32).contiguous()
    ins = [endpoints.contiguous(), desc.contiguous(), valid.contiguous(),
           first_kf.contiguous(), rows]
    dev = kernels.check_cuda(name, *ins)
    R, L = rows.shape[0], endpoints.shape[0]
    best = torch.empty((R,), dtype=torch.int64, device=dev)
    has = torch.empty((R,), dtype=torch.bool, device=dev)
    if R:
        kernels.launch(name, *[kernels.ptr(t) for t in ins], R, L, int(th_high),
                       kernels.ptr(best), kernels.ptr(has))
    return best, has


def _merge_recent(valid, table, rows, ok, best, has):
    """The reference's one-step redirect: each merged recent landmark ->
    its older duplicate (no chains composed), the landmark invalidated and
    every keyframe binding remapped. Returns (valid, table)."""
    n = valid.shape[0]
    has = has & ok
    dst = torch.where(has, rows, torch.full_like(rows, n))
    redirect = set_drop(torch.arange(n, dtype=torch.int32, device=valid.device), dst,
                        best.to(torch.int32))
    table = torch.where(table >= 0, redirect[torch.clamp(table, 0, n - 1).long()], table)
    return set_drop(valid, dst, False), table


def fuse_duplicate_points_3d(state: MapState, k_new: int, n_kf: int, intr: Intrinsics,
                             cfg: SLAMConfig) -> MapState:
    """Landmark-space point dedup (reference local_mapping.py:593-635): the
    first FUSE3D_RECENT_MP valid points in slot order first seen at
    keyframe >= n_kf - 2 merge into their duplicate (kernel 20), all
    keyframe bindings redirected. `k_new` and `intr` are unused, as in the
    reference."""
    P = state.mp_valid.shape[0]
    idx = nonzero_fixed(state.mp_valid & (state.mp_first_kf >= max(n_kf - 2, 0)),
                        FUSE3D_RECENT_MP)
    rows = torch.clamp(idx, 0, P - 1)
    best, has = fuse3d_points_match(state.mp_xyz, state.mp_desc, state.mp_valid,
                                    state.mp_first_kf, rows, cfg.matching.th_low)
    mp_valid, kf_kp_mp = _merge_recent(state.mp_valid, state.kf_kp_mp, rows, idx >= 0,
                                       best, has)
    return state._replace(mp_valid=mp_valid, kf_kp_mp=kf_kp_mp)


def fuse_duplicate_lines_3d(state: MapState, k_new: int, n_kf: int, intr: Intrinsics,
                            cfg: SLAMConfig) -> MapState:
    """Landmark-space line dedup (reference local_mapping.py:639-707): the
    first FUSE3D_RECENT_ML recent lines merge into an older collinear,
    overlapping line with a close LBD descriptor (kernel 21)."""
    L = state.ml_valid.shape[0]
    idx = nonzero_fixed(state.ml_valid & (state.ml_first_kf >= max(n_kf - 2, 0)),
                        FUSE3D_RECENT_ML)
    rows = torch.clamp(idx, 0, L - 1)
    best, has = fuse3d_lines_match(state.ml_endpoints, state.ml_desc, state.ml_valid,
                                   state.ml_first_kf, rows, cfg.matching.th_high)
    ml_valid, kf_line_ml = _merge_recent(state.ml_valid, state.kf_line_ml, rows, idx >= 0,
                                         best, has)
    return state._replace(ml_valid=ml_valid, kf_line_ml=kf_line_ml)


def _fuse_directions(state: MapState, k_new: int, nb_ids: torch.Tensor):
    """(a_ids, b_ids, present) [2W] of the fuse directions: the new
    keyframe's landmarks into each neighbour, then each neighbour's into
    the new keyframe; a direction is present when its neighbour is a
    valid keyframe other than k_new."""
    K = state.kf_valid.shape[0]
    W = nb_ids.shape[0]
    nb_safe = torch.clamp(nb_ids, 0, K - 1).long()
    nb_present = (nb_ids >= 0) & state.kf_valid[nb_safe] & (nb_safe != k_new)
    k_new_b = torch.full((W,), int(k_new), dtype=torch.long, device=nb_safe.device)
    return (torch.cat([k_new_b, nb_safe]), torch.cat([nb_safe, k_new_b]),
            torch.cat([nb_present, nb_present]))


def fuse_match_points_plain(state: MapState, a_ids: torch.Tensor, b_ids: torch.Tensor,
                            present: torch.Tensor, intr: Intrinsics,
                            cfg: SLAMConfig) -> matching.MatchResult:
    """The point fuse's direction matches, all directions batched (the
    reference's vmapped `direction_match`, :793-834): project each source
    landmark into the target keyframe, gate (depth, scale band, viewing
    angle, predicted octave, in-image), window-match through kernel 3 at
    TH_LOW with unique columns, then the chi2 gate at the matched
    feature's octave. Returns [2W, F] idx / dist / valid."""
    F = state.kf_kp_mp.shape[1]
    P = state.mp_valid.shape[0]
    sf = cfg.frontend.scale_factor
    ids = state.kf_kp_mp[a_ids]                                    # [2W, F]
    has = (ids >= 0) & present[:, None]
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
    return m._replace(valid=m.valid & (e2 <= 5.991 * _pow(sf, 2.0 * kp_oct.float())))


def fuse_match_points(state: MapState, a_ids: torch.Tensor, b_ids: torch.Tensor,
                      present: torch.Tensor, intr: Intrinsics,
                      cfg: SLAMConfig) -> matching.MatchResult:
    """The point fuse's direction matches. CPU tensors -> plain version;
    CUDA tensors -> kernel 22's points entry (or raise), which writes no
    [2W, F, F] mask. The sf^k tables come from torch.pow on the card, as
    the plain version's powers do."""
    if state.kf_kp_mp.device.type == "cpu":
        return fuse_match_points_plain(state, a_ids, b_ids, present, intr, cfg)
    F = state.kf_kp_mp.shape[1]
    sf = cfg.frontend.scale_factor
    n_levels = cfg.frontend.n_levels
    lv = torch.arange(n_levels, dtype=torch.float32, device=state.kf_kp_mp.device)
    log_sf = np.float32(np.log(np.float32(sf)))
    i32 = torch.int32
    return matching.fused_match(
        "fuse_match_points", a_ids.shape[0], F, F, dict(
            a_ids=a_ids.to(i32), b_ids=b_ids.to(i32), present=present,
            table=state.kf_kp_mp, xyz=state.mp_xyz, dmin=state.mp_dist_min,
            dmax=state.mp_dist_max, normal=state.mp_normal, desc=state.mp_desc,
            kf_T=state.kf_T_cw, kf_xy=state.kf_xy, kf_valid=state.kf_kp_valid,
            kf_oct=state.kf_octave, kf_desc=state.kf_desc, pow_sf=_pow(sf, lv),
            sig2=_pow(sf, 2.0 * lv)),
        intr, width=cfg.camera.width, height=cfg.camera.height, P=state.mp_valid.shape[0],
        n_levels=n_levels, max_dist=cfg.matching.th_low, radius=3.0,
        inv_log_sf=float(np.float32(1.0) / log_sf))


def fuse_projected_points(state: MapState, k_new: int, nb_ids: torch.Tensor,
                          intr: Intrinsics, cfg: SLAMConfig) -> MapState:
    """Projection-space landmark fusion (SearchInNeighbors + Fuse): the 2W
    directions (new KF -> neighbours and back) match in one batch against
    the pre-fuse snapshot (kernel 22 on the card); the merge / add
    scatters then apply direction by direction, in the reference's order
    (kernel 23)."""
    obs = point_obs_counts(state)
    a_ids, b_ids, present = _fuse_directions(state, k_new, nb_ids)
    m = fuse_match_points(state, a_ids, b_ids, present, intr, cfg)
    kf_kp_mp, mp_valid = _apply_fuse(state.kf_kp_mp, state.mp_valid, obs, a_ids, b_ids, m)
    return state._replace(kf_kp_mp=kf_kp_mp, mp_valid=mp_valid)


def fuse_merge_plain(table: torch.Tensor, valid: torch.Tensor, obs: torch.Tensor,
                     a_ids: torch.Tensor, b_ids: torch.Tensor, feat_idx: torch.Tensor,
                     hits: torch.Tensor):
    """The reference's sequential fuse merges over the 2W directions (a
    fori_loop there, a host loop here): the candidates are row a_ids[i]
    of the table before the fuse; a match on a feature of row b_ids[i]
    bound to another landmark merges the two (the more-observed one
    survives), a match on an unbound feature adds the observation.
    Returns (table, valid, redirect)."""
    F = table.shape[1]
    P = valid.shape[0]
    dev = table.device
    cand_ids = table[a_ids]
    redirect = torch.arange(P, dtype=torch.int32, device=dev)
    clampP = lambda t: torch.clamp(t, 0, P - 1).long()  # noqa: E731
    for i in range(b_ids.shape[0]):
        b = b_ids[i]
        ids_i = cand_ids[i]
        ids_r = torch.where(ids_i >= 0, redirect[clampP(ids_i)], -1)
        ids_r = torch.where(valid[clampP(ids_r)], ids_r, -1)
        feat = torch.clamp(feat_idx[i].long(), 0, F - 1)
        hit = hits[i] & (ids_r >= 0)
        row_b = table[b]
        cur = row_b[feat]
        cur_r = torch.where(cur >= 0, redirect[clampP(cur)], -1)
        cand = ids_r
        mrg = hit & (cur_r >= 0) & (cand >= 0) & (cur_r != cand)
        keep_cand = obs[clampP(cand)] >= obs[clampP(cur_r)]
        src = torch.where(keep_cand, cur_r, cand)
        dst = torch.where(keep_cand, cand, cur_r)
        redirect = set_drop(redirect, torch.where(mrg, src, P), torch.where(mrg, dst, 0))
        valid = set_drop(valid, torch.where(mrg, src, P), False)
        present_b = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        present_b[torch.where(row_b >= 0, row_b, P).long()] = True
        add = hit & (cur_r < 0) & (cand >= 0) & ~present_b[clampP(cand)]
        new_row = set_drop(row_b, torch.where(add, feat, F), torch.where(add, cand, -1))
        table = table.clone()
        table[b] = new_row
    return table, valid, redirect


def fuse_merge(table: torch.Tensor, valid: torch.Tensor, obs: torch.Tensor,
               a_ids: torch.Tensor, b_ids: torch.Tensor, feat_idx: torch.Tensor,
               hits: torch.Tensor):
    """The fuse merges. CPU tensors -> plain version; CUDA tensors ->
    kernel 23's merge walk (or raise)."""
    if table.device.type == "cpu":
        return fuse_merge_plain(table, valid, obs, a_ids, b_ids, feat_idx, hits)
    if hits.shape[1] != table.shape[1]:
        raise ValueError(f"fuse_merge: {hits.shape[1]} candidate rows, table {tuple(table.shape)}")
    i32 = torch.int32
    return matching.merge_walk("fuse_merge", table, valid, b_ids.to(i32), feat_idx, hits,
                               obs=obs, a_ids=a_ids.to(i32))


def _apply_fuse(table: torch.Tensor, valid: torch.Tensor, obs: torch.Tensor,
                a_ids: torch.Tensor, b_ids: torch.Tensor, m: matching.MatchResult):
    """The merges of the 2W directions' matches, then the finish. Returns
    (table, valid)."""
    table, valid, redirect = fuse_merge(table, valid, obs, a_ids, b_ids, m.idx, m.valid)
    return matching.fuse_finish(table, valid, redirect, clear_invalid=True), valid


def fuse_match_lines_plain(state: MapState, a_ids: torch.Tensor, b_ids: torch.Tensor,
                           present: torch.Tensor, intr: Intrinsics,
                           cfg: SLAMConfig) -> matching.MatchResult:
    """The line fuse's direction matches, all directions batched (the
    reference's `direction_match`, :911-940): candidate lines' projected
    midpoints within 8 px and 15 deg of an observed line, LBD distance
    <= TH_HIGH through kernel 3, unique columns. Returns [2W, LF] idx /
    dist / valid."""
    L = state.ml_valid.shape[0]
    ids = state.kf_line_ml[a_ids]                                   # [2W, LF]
    has = (ids >= 0) & present[:, None]
    safe = torch.clamp(ids, 0, L - 1).long()
    ep = state.ml_endpoints[safe]                                    # [2W, LF, 6]
    T_b = state.kf_T_cw[b_ids]

    def proj(p):
        return cam_utils.project(intr, p @ T_b[:, :3, :3].transpose(1, 2) + T_b[:, None, :3, 3])

    uv_s, z_s = proj(ep[..., :3])
    uv_e, z_e = proj(ep[..., 3:])
    mid = 0.5 * (uv_s + uv_e)
    seg = uv_e - uv_s
    ang = fmath.atan2(seg[..., 1], seg[..., 0])
    vis = (has & (z_s > 0.1) & (z_e > 0.1)
           & cam_utils.in_image(cfg.camera, mid, margin=2.0))
    fr_ep = state.kf_line_ep[b_ids]                                  # [2W, LF, 4]
    fr_mid = 0.5 * (fr_ep[..., 0:2] + fr_ep[..., 2:4])
    fr_ang = fmath.atan2(fr_ep[..., 3] - fr_ep[..., 1], fr_ep[..., 2] - fr_ep[..., 0])
    allow = matching.window_mask(mid, vis, fr_mid, state.kf_line_valid[b_ids], 8.0)
    dang = matching.jnp_mod(ang[..., :, None] - fr_ang[..., None, :] + torch.pi / 2,
                            torch.pi) - torch.pi / 2
    allow = allow & (torch.abs(dang) < 0.26)
    return matching.masked_match(state.ml_desc[safe], state.kf_ldesc[b_ids], allow,
                                 max_dist=cfg.matching.th_high)


def fuse_match_lines(state: MapState, a_ids: torch.Tensor, b_ids: torch.Tensor,
                     present: torch.Tensor, intr: Intrinsics,
                     cfg: SLAMConfig) -> matching.MatchResult:
    """The line fuse's direction matches. CPU tensors -> plain version;
    CUDA tensors -> kernel 22's lines entry (or raise)."""
    if state.kf_line_ml.device.type == "cpu":
        return fuse_match_lines_plain(state, a_ids, b_ids, present, intr, cfg)
    LF = state.kf_line_ml.shape[1]
    i32 = torch.int32
    return matching.fused_match(
        "fuse_match_lines", a_ids.shape[0], LF, LF, dict(
            a_ids=a_ids.to(i32), b_ids=b_ids.to(i32), present=present,
            table=state.kf_line_ml, endpoints=state.ml_endpoints, desc=state.ml_desc,
            kf_T=state.kf_T_cw, line_ep=state.kf_line_ep, kf_valid=state.kf_line_valid,
            kf_desc=state.kf_ldesc),
        intr, width=cfg.camera.width, height=cfg.camera.height, P=state.ml_valid.shape[0],
        max_dist=cfg.matching.th_high, radius=8.0)


def fuse_projected_lines(state: MapState, k_new: int, nb_ids: torch.Tensor,
                         intr: Intrinsics, cfg: SLAMConfig) -> MapState:
    """Projection-space map-line fusion (SearchInNeighbors via LSDmatcher
    Fuse): the 2W directions match in one batch (kernel 22 on the card),
    the merges apply direction by direction (kernel 23)."""
    obs = line_obs_counts(state)
    a_ids, b_ids, present = _fuse_directions(state, k_new, nb_ids)
    m = fuse_match_lines(state, a_ids, b_ids, present, intr, cfg)
    kf_line_ml, ml_valid = _apply_fuse(state.kf_line_ml, state.ml_valid, obs, a_ids, b_ids, m)
    return state._replace(kf_line_ml=kf_line_ml, ml_valid=ml_valid)


def apply_ba_result(state: MapState, local_kf: torch.Tensor, local_mp: torch.Tensor,
                    ba: local_ba.BAResult, local_ln: torch.Tensor | None = None) -> MapState:
    """Scatter optimized poses, points (and line endpoints) back
    (non-finite updates dropped) and erase outlier observations."""
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
    st = st._replace(kf_kp_mp=set_drop(st.kf_kp_mp, kf_ids, torch.where(keep, cur, -1)))
    if local_ln is None or ba.ln_start is None:
        return st
    L = state.ml_valid.shape[0]
    ln_fin = torch.all(torch.isfinite(ba.ln_start), dim=1) & torch.all(torch.isfinite(ba.ln_end),
                                                                      dim=1)
    ln_ids = torch.where((local_ln >= 0) & ln_fin, local_ln, L)
    eps = torch.cat([ba.ln_start, ba.ln_end], dim=1)
    lcur = st.kf_line_ml[rows]
    lkeep = (lcur < 0) | ba.line_inlier
    return st._replace(ml_endpoints=set_drop(st.ml_endpoints, ln_ids, eps),
                       kf_line_ml=set_drop(st.kf_line_ml, kf_ids, torch.where(lkeep, lcur, -1)))


def gather_ba_problem(state: MapState, n_kf: int, cfg: SLAMConfig):
    """Last BA_WINDOW keyframes free, the BA_FIXED before them fixed,
    keyframe 0 gauge-fixed; returns (prob, lines, local_kf, local_mp,
    local_ln), `lines` / `local_ln` None with `use_lines` off."""
    lo_free = max(n_kf - BA_WINDOW, 0)
    lo_fix = max(lo_free - BA_FIXED, 0)
    ids = list(range(lo_fix, n_kf))
    pad = BA_LOCAL_KF - len(ids)
    dev = state.kf_valid.device
    local_kf = torch.tensor(ids + [-1] * pad, dtype=torch.int32, device=dev)
    free = torch.tensor([(i >= lo_free and i != 0) for i in ids] + [False] * pad,
                        device=dev)
    return _gather_ba_device(state, local_kf, free, cfg)[:5]


def _local_set(table: torch.Tensor, kf_ok: torch.Tensor, valid: torch.Tensor, cap: int):
    """Landmarks with edges in the window, up to `cap` of them: (global ids
    [cap] -1 padded, [KL, *] edges as local ids, count in the window)."""
    n = valid.shape[0]
    dev = table.device
    edge_glob = torch.where(kf_ok[:, None], table, -1)
    in_local = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    in_local[torch.where(edge_glob >= 0, edge_glob, n).reshape(-1).long()] = True
    in_local = in_local[:n] & valid
    local = nonzero_fixed(in_local, cap).to(torch.int32)
    g2l = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    g2l = set_drop(g2l, torch.where(local >= 0, local, n),
                   torch.arange(cap, dtype=torch.int32, device=dev))
    edge_local = torch.where(edge_glob >= 0, g2l[torch.clamp(edge_glob, 0, n).long()], -1)
    return local, edge_local, in_local.sum().to(torch.int32)


def _gather_ba_device(state: MapState, local_kf: torch.Tensor, free: torch.Tensor,
                      cfg: SLAMConfig, n_mp_cap: int = BA_LOCAL_MP,
                      n_ln_cap: int = BA_LOCAL_LN):
    """(prob, lines, local_kf, local_mp, local_ln, n_dropped): landmarks
    with edges in the window, indexed locally; `lines` / `local_ln` are
    None with `use_lines` off, `n_dropped` counts landmarks past the caps."""
    K = state.kf_valid.shape[0]
    rows = torch.clamp(local_kf, 0, K - 1).long()
    kf_ok = (local_kf >= 0) & state.kf_valid[rows]
    local_mp, edge_mp_local, n_mp = _local_set(state.kf_kp_mp[rows], kf_ok, state.mp_valid,
                                               n_mp_cap)
    mp_safe = torch.clamp(local_mp, 0, state.mp_valid.shape[0] - 1).long()
    sigma2 = _pow(cfg.frontend.scale_factor, 2.0 * state.kf_octave[rows].float())
    prob = local_ba.BAProblem(
        kf_T_cw=state.kf_T_cw[rows], kf_free=free & kf_ok, kf_valid=kf_ok,
        obs_uv=state.kf_xy[rows], obs_sigma2=sigma2, edge_mp=edge_mp_local,
        edge_valid=(edge_mp_local >= 0) & state.kf_kp_valid[rows],
        mp_xyz=state.mp_xyz[mp_safe],
        mp_valid=(local_mp >= 0) & state.mp_valid[mp_safe])
    n_drop = torch.clamp(n_mp - n_mp_cap, min=0)
    if not cfg.use_lines:
        return prob, None, local_kf, local_mp, None, n_drop
    local_ln, edge_ln_local, n_ln = _local_set(state.kf_line_ml[rows], kf_ok,
                                               state.ml_valid, n_ln_cap)
    ln_safe = torch.clamp(local_ln, 0, state.ml_valid.shape[0] - 1).long()
    lsigma2 = _pow(cfg.frontend.line_scale_factor, 2.0 * state.kf_loctave[rows].float())
    lines = local_ba.BALineProblem(
        ln_start=state.ml_endpoints[ln_safe, :3], ln_end=state.ml_endpoints[ln_safe, 3:],
        ln_valid=(local_ln >= 0) & state.ml_valid[ln_safe],
        obs_l=state.kf_line2d[rows], obs_sigma2=lsigma2, edge_ln=edge_ln_local,
        edge_valid=(edge_ln_local >= 0) & state.kf_line_valid[rows])
    n_drop = n_drop + torch.clamp(n_ln - n_ln_cap, min=0)
    return prob, lines, local_kf, local_mp, local_ln, n_drop


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


__all__ = ["MAX_NEW_POINTS", "MAX_NEW_LINES", "BA_WINDOW", "BA_FIXED", "BA_LOCAL_KF",
           "BA_LOCAL_MP", "BA_LOCAL_LN", "insert_keyframe", "create_new_points",
           "NewPointsResult", "create_new_lines", "NewLinesResult", "fuse_projected_points",
           "fuse_projected_lines", "apply_ba_result", "gather_ba_problem",
           "_gather_ba_device", "cull_points", "cull_lines", "cull_keyframes",
           "fuse_duplicate_points_3d", "fuse_duplicate_lines_3d", "fuse3d_points_match",
           "fuse3d_points_match_plain", "fuse3d_lines_match", "fuse3d_lines_match_plain",
           "FUSE3D_RECENT_MP", "FUSE3D_RECENT_ML", "fuse_match_points",
           "fuse_match_points_plain", "fuse_match_lines", "fuse_match_lines_plain",
           "fuse_merge", "fuse_merge_plain"]
