"""Local bundle adjustment: batched Gauss-Newton with a Schur complement.

Counterpart of structure_slam_pointline_tpu/optim/local_ba.py. The
[KL, F] keyframe-major edge grid is laid out once per call as a dense
[KL, PL] camera x landmark grid (each landmark is observed at most once
per keyframe), per-landmark 3x3 blocks reduce over KL, per-camera 6x6
blocks over PL, and the reduced camera system S = blockdiag(Hcc) -
(A Hpp^-1) A^T is solved densely. With `lines`, map-line endpoints join
the marginalized landmarks as two more sets with one point-to-line
residual row each ([KL, LL] grids). Schedule: 5 iterations, the chi2 cut,
15 more; 3x3 blocks get the trace-relative damping floor of the
reference (local_ba.py:286-315).

`bundle_adjust` is the wrapper of CUDA kernel 12 (csrc/local_ba.cu: the
whole schedule as a fixed chain of launches, no host synchronization),
for local BA's 10-16 keyframes and global BA's 64 (optim/global_ba.py).
`bundle_adjust_plain` is its plain version: the schedule as torch ops,
each Schur product one matmul, the reduced system by torch.linalg.solve
(the reference's jnp.linalg.solve), over the valid keyframes and the
landmarks that have an edge.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import OptimConfig
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.robust import huber_weight


class BAProblem(NamedTuple):
    kf_T_cw: torch.Tensor     # [KL, 4, 4]
    kf_free: torch.Tensor     # [KL] bool
    kf_valid: torch.Tensor    # [KL] bool
    obs_uv: torch.Tensor      # [KL, F, 2]
    obs_sigma2: torch.Tensor  # [KL, F]
    edge_mp: torch.Tensor     # [KL, F] local landmark index or -1
    edge_valid: torch.Tensor  # [KL, F] bool
    mp_xyz: torch.Tensor      # [PL, 3]
    mp_valid: torch.Tensor    # [PL] bool


class BALineProblem(NamedTuple):
    """Map-line endpoints as marginalized landmarks, one point-to-infinite-
    line residual per endpoint and observation."""
    ln_start: torch.Tensor    # [LL, 3] world start points
    ln_end: torch.Tensor      # [LL, 3]
    ln_valid: torch.Tensor    # [LL]
    obs_l: torch.Tensor       # [KL, LF, 3] observed normalized line coeffs
    obs_sigma2: torch.Tensor  # [KL, LF]
    edge_ln: torch.Tensor     # [KL, LF] local line index or -1
    edge_valid: torch.Tensor  # [KL, LF]


class BAResult(NamedTuple):
    kf_T_cw: torch.Tensor      # [KL, 4, 4]
    mp_xyz: torch.Tensor       # [PL, 3]
    edge_inlier: torch.Tensor  # [KL, F]
    cost: torch.Tensor
    ln_start: torch.Tensor | None = None     # [LL, 3]
    ln_end: torch.Tensor | None = None
    line_inlier: torch.Tensor | None = None  # [KL, LF]


def _to_dense_grid(prob: BAProblem):
    """[KL, F] observations -> ([2, KL, PL] obs, [KL, PL] info, edge mask)."""
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    dev = prob.edge_mp.device
    base_kf = prob.edge_valid & (prob.edge_mp >= 0) & prob.kf_valid[:, None]
    rows = torch.arange(KL, device=dev)[:, None].expand(KL, F)
    lin = (rows * PL + prob.edge_mp.long())[base_kf]
    info_kf = 1.0 / torch.clamp(prob.obs_sigma2, min=1e-12)
    vals = torch.stack([prob.obs_uv[..., 0], prob.obs_uv[..., 1], info_kf,
                        torch.ones_like(info_kf)], dim=-1)[base_kf]   # [E, 4]
    grid = torch.zeros((KL * PL, 4), dtype=vals.dtype, device=dev)
    grid.index_put_((lin,), vals, accumulate=True)
    grid = grid.reshape(KL, PL, 4).permute(2, 0, 1)
    edge = (grid[3] > 0.5) & prob.mp_valid[None, :]
    return grid[0:2], grid[2], edge, base_kf


def _lines_to_grid(lines: BALineProblem):
    """[KL, LF] line observations -> ([3, KL, LL] coeffs, [KL, LL] info,
    edge mask, the base [KL, LF] mask)."""
    KL, LF = lines.edge_ln.shape
    LL = lines.ln_start.shape[0]
    dev = lines.edge_ln.device
    base = lines.edge_valid & (lines.edge_ln >= 0)
    rows = torch.arange(KL, device=dev)[:, None].expand(KL, LF)
    lin = (rows * LL + lines.edge_ln.long())[base]
    info = 1.0 / torch.clamp(lines.obs_sigma2, min=1e-12)
    vals = torch.stack([lines.obs_l[..., 0], lines.obs_l[..., 1], lines.obs_l[..., 2], info,
                        torch.ones_like(info)], dim=-1)[base]          # [E, 5]
    grid = torch.zeros((KL * LL, 5), dtype=vals.dtype, device=dev)
    grid.index_put_((lin,), vals, accumulate=True)
    grid = grid.reshape(KL, LL, 5).permute(2, 0, 1)
    edge = (grid[4] > 0.5) & lines.ln_valid[None, :]
    return grid[0:3], grid[3], edge, base


def _project_planes(T, X, intr: Intrinsics):
    """All landmarks X [3, PL] in all cameras T [KL, 4, 4] as [KL, PL] planes."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    pc = [R[:, i, 0, None] * X[0][None, :] + R[:, i, 1, None] * X[1][None, :]
          + R[:, i, 2, None] * X[2][None, :] + t[:, i, None] for i in range(3)]
    x, y, z = pc
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    return dict(R=R, x=x, y=y, z=z, u=intr.fx * x * iz + intr.cx,
                v=intr.fy * y * iz + intr.cy, a=intr.fx * iz,
                c=-intr.fx * x * iz * iz, b=intr.fy * iz, d=-intr.fy * y * iz * iz)


def _jacobian_planes(pp):
    x, y, z = pp["x"], pp["y"], pp["z"]
    a, b, c, d = pp["a"], pp["b"], pp["c"], pp["d"]
    R = pp["R"]
    zero = torch.zeros_like(x)
    Ju = [-(c * y), -(a * z - c * x), a * y, -a, zero, -c]
    Jv = [-(-b * z + d * y), d * x, -(b * x), zero, -b, -d]
    Jxu = [-(a * R[:, 0, j, None] + c * R[:, 2, j, None]) for j in range(3)]
    Jxv = [-(b * R[:, 1, j, None] + d * R[:, 2, j, None]) for j in range(3)]
    return (Ju, Jv), (Jxu, Jxv)


def _plane_inv3(Hpp, lam, freef):
    """Damped adjugate inverse of symmetric 3x3 blocks held as planes, with
    the diagonal floor relative to the block's trace."""
    ds_ = 1.0 + lam
    tr = Hpp[0][0] + Hpp[1][1] + Hpp[2][2]
    eps = 1e-3 * tr + 1e-6
    a_, b_, c_ = Hpp[0][0] * ds_ + eps, Hpp[0][1], Hpp[0][2]
    e_, f_ = Hpp[1][1] * ds_ + eps, Hpp[1][2]
    i_ = Hpp[2][2] * ds_ + eps
    co00 = e_ * i_ - f_ * f_
    co01 = c_ * f_ - b_ * i_
    co02 = b_ * f_ - c_ * e_
    co11 = a_ * i_ - c_ * c_
    co12 = c_ * b_ - a_ * f_
    co22 = a_ * e_ - b_ * b_
    det = a_ * co00 + b_ * co01 + c_ * co02
    idet = freef / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    return [[co00 * idet, co01 * idet, co02 * idet],
            [co01 * idet, co11 * idet, co12 * idet],
            [co02 * idet, co12 * idet, co22 * idet]]


def _schur_block(A, Hpi, bp, KL, n_cols):
    """(A Hpp^-1 A^T as [KL, 6, KL, 6], A Hpp^-1 bp as [KL, 6]) of one
    landmark set held as planes."""
    AHi = torch.stack([torch.stack([
        A[i, 0] * Hpi[0][l][None, :] + A[i, 1] * Hpi[1][l][None, :]
        + A[i, 2] * Hpi[2][l][None, :] for l in range(3)]) for i in range(6)])
    M1 = AHi.permute(2, 0, 1, 3).reshape(KL * 6, 3 * n_cols)
    M2 = A.permute(2, 0, 1, 3).reshape(KL * 6, 3 * n_cols)
    S_c = (M1 @ M2.T).reshape(KL, 6, KL, 6)
    b_c = torch.stack([torch.sum(AHi[i, 0] * bp[0][None, :] + AHi[i, 1] * bp[1][None, :]
                                 + AHi[i, 2] * bp[2][None, :], dim=1)
                       for i in range(6)]).T
    return S_c, b_c


def _backsub(A, Hpi, bp, dxc, freef):
    rhs = [bp[j] - torch.sum(sum(A[i, j] * dxc[:, i, None] for i in range(6)), dim=0)
           for j in range(3)]
    dxp = torch.stack([(Hpi[l][0] * rhs[0] + Hpi[l][1] * rhs[1] + Hpi[l][2] * rhs[2]) * freef
                       for l in range(3)])
    pn = torch.sqrt(torch.sum(dxp * dxp, dim=0, keepdim=True))
    return dxp * torch.clamp(0.5 / torch.clamp(pn, min=1e-9), max=1.0)


def _used_columns(edge_ids, edge_ok, col_valid):
    """(kept column ids, old -> new column map with -1 for dropped ones) of
    the landmarks that have an edge and are valid; column 0 alone when none
    is (an edgeless column changes nothing)."""
    n = col_valid.shape[0]
    used = torch.zeros(n + 1, dtype=torch.bool, device=col_valid.device)
    used[torch.where(edge_ok, edge_ids.long(), n).reshape(-1)] = True
    cols = torch.nonzero(used[:n] & col_valid)[:, 0]
    if cols.numel() == 0:
        cols = cols.new_zeros(1)
    remap = torch.full((n + 1,), -1, dtype=edge_ids.dtype, device=col_valid.device)
    remap[cols] = torch.arange(cols.shape[0], dtype=edge_ids.dtype, device=col_valid.device)
    return cols, remap


def bundle_adjust_plain(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                        lines: BALineProblem | None = None) -> BAResult:
    """Run the 5 + cut + 15 schedule on the local problem; with `lines`,
    map-line endpoints are optimized with the points.

    Invalid keyframes and landmarks without an edge take no part in it:
    their poses and positions come back unchanged (a zero step) and they
    have no inlier edges. So the schedule runs on the problem without them
    (global BA's 64-keyframe, 16384-point window is mostly padding) and the
    result is scattered back; only the order of the sums over the dropped
    zeros differs. An invalid keyframe's line edges count, as in the
    reference (only its point edges are masked), so its row stays while it
    has one."""
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    keep = prob.kf_valid
    if lines is not None:
        LL = lines.ln_start.shape[0]
        ln_ok = lines.edge_valid & (lines.edge_ln >= 0) & (lines.edge_ln < LL)
        keep = keep | ln_ok.any(1)
    rows = torch.nonzero(keep)[:, 0]
    if rows.numel() == 0:
        rows = rows.new_zeros(1)
    pt_ok = prob.edge_valid & (prob.edge_mp >= 0) & (prob.edge_mp < PL) & prob.kf_valid[:, None]
    cols, remap = _used_columns(prob.edge_mp, pt_ok, prob.mp_valid)
    sub = BAProblem(
        kf_T_cw=prob.kf_T_cw[rows], kf_free=prob.kf_free[rows], kf_valid=prob.kf_valid[rows],
        obs_uv=prob.obs_uv[rows], obs_sigma2=prob.obs_sigma2[rows],
        edge_mp=torch.where(pt_ok, remap[torch.clamp(prob.edge_mp, 0, PL).long()], -1)[rows],
        edge_valid=pt_ok[rows], mp_xyz=prob.mp_xyz[cols], mp_valid=prob.mp_valid[cols])
    sub_lines = None
    if lines is not None:
        lcols, lremap = _used_columns(lines.edge_ln, ln_ok, lines.ln_valid)
        sub_lines = BALineProblem(
            ln_start=lines.ln_start[lcols], ln_end=lines.ln_end[lcols],
            ln_valid=lines.ln_valid[lcols], obs_l=lines.obs_l[rows],
            obs_sigma2=lines.obs_sigma2[rows],
            edge_ln=torch.where(ln_ok, lremap[torch.clamp(lines.edge_ln, 0, LL).long()],
                                -1)[rows],
            edge_valid=ln_ok[rows])
    res = _bundle_adjust_dense(sub, intr, cfg, sub_lines)

    def put(full, part, idx):
        out = full.clone()
        out[idx] = part
        return out

    inlier = put(torch.zeros((KL, F), dtype=torch.bool, device=rows.device),
                 res.edge_inlier, rows)
    out = BAResult(kf_T_cw=put(prob.kf_T_cw, res.kf_T_cw, rows),
                   mp_xyz=put(prob.mp_xyz, res.mp_xyz, cols), edge_inlier=inlier, cost=res.cost)
    if lines is None:
        return out
    line_inlier = put(torch.zeros(lines.edge_ln.shape, dtype=torch.bool, device=rows.device),
                      res.line_inlier, rows)
    return out._replace(ln_start=put(lines.ln_start, res.ln_start, lcols),
                        ln_end=put(lines.ln_end, res.ln_end, lcols), line_inlier=line_inlier)


def _bundle_adjust_dense(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                         lines: BALineProblem | None = None) -> BAResult:
    """The schedule on dense [KL, PL] (and [KL, LL]) planes."""
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    dtype = prob.kf_T_cw.dtype
    dev = prob.kf_T_cw.device
    obs, info, edge_lm, base_kf = _to_dense_grid(prob)
    free_f = (prob.kf_free & prob.kf_valid).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    kk = torch.arange(KL, device=dev)
    if lines is not None:
        LL = lines.ln_start.shape[0]
        l_g, linfo, ledge, lbase = _lines_to_grid(lines)

    def chi2_planes(T, X, mask):
        pp = _project_planes(T, X, intr)
        ru = obs[0] - pp["u"]
        rv = obs[1] - pp["v"]
        chi2 = (ru * ru + rv * rv) * info
        return pp, ru, rv, torch.where(mask, chi2, torch.zeros_like(chi2))

    def line_chi2_planes(T, Xs, Xe, mask):
        """Per-endpoint signed distances e = l . (u, v, 1) on [KL, LL]."""
        pps = _project_planes(T, Xs, intr)
        ppe = _project_planes(T, Xe, intr)
        e_s = l_g[0] * pps["u"] + l_g[1] * pps["v"] + l_g[2]
        e_e = l_g[0] * ppe["u"] + l_g[1] * ppe["v"] + l_g[2]
        zero = torch.zeros_like(e_s)
        c_s = torch.where(mask, e_s * e_s * linfo, zero)
        c_e = torch.where(mask, e_e * e_e * linfo, zero)
        return pps, ppe, e_s, e_e, c_s, c_e

    def line_terms(pp):
        """(Jc [6] planes, Jx [3] planes) of one endpoint set: l0 * Ju +
        l1 * Jv is d(-e)/d. in the point planes' convention."""
        (Ju, Jv), (Jxu, Jxv) = _jacobian_planes(pp)
        return ([l_g[0] * Ju[i] + l_g[1] * Jv[i] for i in range(6)],
                [l_g[0] * Jxu[j] + l_g[1] * Jxv[j] for j in range(3)])

    def one_endpoint(Jc_l, Jx_l, w_l, r_l, lam, lnf):
        wJc = [w_l * q for q in Jc_l]
        Hcc_l = torch.stack([torch.stack([torch.sum(wJc[i] * Jc_l[j], dim=1)
                                          for j in range(6)]) for i in range(6)]).permute(2, 0, 1)
        bc_l = -torch.stack([torch.sum(wJc[i] * r_l, dim=1) for i in range(6)]).T
        wJx = [w_l * q for q in Jx_l]
        Hpp_l = [[torch.sum(wJx[i] * Jx_l[j], dim=0) for j in range(3)] for i in range(3)]
        bp_l = [-torch.sum(wJx[i] * r_l, dim=0) for i in range(3)]
        A_l = torch.stack([torch.stack([wJc[i] * Jx_l[j] for j in range(3)]) for i in range(6)])
        Hpi_l = _plane_inv3(Hpp_l, lam, lnf)
        S_l, b_l = _schur_block(A_l, Hpi_l, bp_l, KL, LL)
        return Hcc_l, bc_l, A_l, Hpi_l, bp_l, S_l, b_l

    def lm_phase(T, X, Xs, Xe, edge_mask, ln_mask, n_iters, lam):
        cnt = edge_mask.sum(0)
        pt_free = prob.mp_valid & (cnt >= 2)
        evf = (edge_mask & pt_free[None, :]).to(dtype)
        ev = evf > 0
        ptf = pt_free.to(dtype)
        if lines is not None:
            ln_free = lines.ln_valid & (ln_mask.sum(0) >= 2)
            levf = (ln_mask & ln_free[None, :]).to(dtype)
            lev = levf > 0
            lnf = ln_free.to(dtype)
        cost = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(n_iters):
            pp, ru, rv, chi2 = chi2_planes(T, X, ev)
            cost = torch.sum(torch.clamp(chi2, max=cfg.chi2_mono * 4) * evf)
            w = huber_weight(chi2, cfg.huber_delta_point) * info * evf
            (Ju, Jv), (Jxu, Jxv) = _jacobian_planes(pp)
            wJu = [w * q for q in Ju]
            wJv = [w * q for q in Jv]
            Hcc = torch.stack([torch.stack([
                torch.sum(wJu[i] * Ju[j] + wJv[i] * Jv[j], dim=1) for j in range(6)])
                for i in range(6)]).permute(2, 0, 1)                  # [KL, 6, 6]
            bc = -torch.stack([torch.sum(wJu[i] * ru + wJv[i] * rv, dim=1)
                               for i in range(6)]).T                   # [KL, 6]
            wJxu = [w * q for q in Jxu]
            wJxv = [w * q for q in Jxv]
            Hpp = [[torch.sum(wJxu[i] * Jxu[j] + wJxv[i] * Jxv[j], dim=0)
                    for j in range(3)] for i in range(3)]
            bp = [-torch.sum(wJxu[i] * ru + wJxv[i] * rv, dim=0) for i in range(3)]
            A = torch.stack([torch.stack([wJu[i] * Jxu[j] + wJv[i] * Jxv[j]
                                          for j in range(3)]) for i in range(6)])
            Hpi = _plane_inv3(Hpp, lam, ptf)                           # [3][3] of [PL]
            S_pt, b_pt = _schur_block(A, Hpi, bp, KL, PL)
            if lines is not None:
                pps, ppe, e_s, e_e, c_s, c_e = line_chi2_planes(T, Xs, Xe, lev)
                cost = cost + torch.sum(torch.clamp(c_s + c_e, max=cfg.chi2_line * 8) * levf)
                w_s = huber_weight(c_s, cfg.huber_delta_line) * linfo * levf
                w_e = huber_weight(c_e, cfg.huber_delta_line) * linfo * levf
                Jc_s, Jx_s = line_terms(pps)
                Jc_e, Jx_e = line_terms(ppe)
                out_s = one_endpoint(Jc_s, Jx_s, w_s, -e_s, lam, lnf)
                out_e = one_endpoint(Jc_e, Jx_e, w_e, -e_e, lam, lnf)
                Hcc = Hcc + out_s[0] + out_e[0]
                bc = bc + out_s[1] + out_e[1]
            S = -S_pt
            b_red = bc - b_pt
            if lines is not None:
                S = S - out_s[5] - out_e[5]
                b_red = b_red - out_s[6] - out_e[6]
            S[kk, :, kk, :] += Hcc * (1.0 + lam * eye6)
            fm = free_f
            S = S * (fm[:, None, None, None] * fm[None, None, :, None])
            S[kk, :, kk, :] += (1.0 - fm)[:, None, None] * eye6
            b_m = b_red * fm[:, None]
            Sd = S.reshape(KL * 6, KL * 6)
            dxc = torch.linalg.solve(
                Sd + 1e-6 * torch.eye(KL * 6, dtype=dtype, device=dev),
                b_m.reshape(-1)).reshape(KL, 6) * fm[:, None]
            cn = torch.linalg.norm(dxc, dim=1, keepdim=True)
            dxc_c = dxc * torch.clamp(0.5 / torch.clamp(cn, min=1e-9), max=1.0)
            dxp = _backsub(A, Hpi, bp, dxc, ptf)
            if lines is not None:
                Xs = Xs + _backsub(out_s[2], out_s[3], out_s[4], dxc, lnf)
                Xe = Xe + _backsub(out_e[2], out_e[3], out_e[4], dxc, lnf)
            T = lie.se3_exp(dxc_c) @ T
            X = X + dxp
        return T, X, Xs, Xe, cost

    if lines is not None:
        Xs0, Xe0, ln_edge = lines.ln_start.T, lines.ln_end.T, ledge
    else:
        Xs0 = Xe0 = ln_edge = None
    T1, X1, Xs1, Xe1, _ = lm_phase(prob.kf_T_cw, prob.mp_xyz.T, Xs0, Xe0, edge_lm, ln_edge,
                                   cfg.local_ba_iters_first, cfg.lm_lambda_init)
    pp, _, _, chi2 = chi2_planes(T1, X1, edge_lm)
    keep = edge_lm & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
    keep_ln = ln_edge
    if lines is not None:
        pps, ppe, _, _, c_s, c_e = line_chi2_planes(T1, Xs1, Xe1, ln_edge)
        keep_ln = ln_edge & (c_s + c_e <= 2.0 * cfg.chi2_line) & (pps["z"] > 0) & (ppe["z"] > 0)
    T2, X2, Xs2, Xe2, cost = lm_phase(T1, X1, Xs1, Xe1, keep, keep_ln,
                                      cfg.local_ba_iters_second, cfg.lm_lambda_init)
    pp, _, _, chi2 = chi2_planes(T2, X2, edge_lm)
    inlier_lm = edge_lm & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
    idx = kk[:, None] * PL + torch.clamp(prob.edge_mp.long(), 0, PL - 1)
    inlier = base_kf & (prob.edge_mp >= 0) & (prob.edge_mp < PL) \
        & inlier_lm.reshape(-1)[idx]
    if lines is None:
        return BAResult(kf_T_cw=T2, mp_xyz=X2.T, edge_inlier=inlier, cost=cost)
    pps, ppe, _, _, c_s, c_e = line_chi2_planes(T2, Xs2, Xe2, ln_edge)
    inl_ln = ln_edge & (c_s + c_e <= 2.0 * cfg.chi2_line) & (pps["z"] > 0) & (ppe["z"] > 0)
    lidx = kk[:, None] * LL + torch.clamp(lines.edge_ln.long(), 0, LL - 1)
    line_inlier = lbase & (lines.edge_ln >= 0) & (lines.edge_ln < LL) \
        & inl_ln.reshape(-1)[lidx]
    return BAResult(kf_T_cw=T2, mp_xyz=X2.T, edge_inlier=inlier, cost=cost,
                    ln_start=Xs2.T, ln_end=Xe2.T, line_inlier=line_inlier)


MAX_BA_KEYFRAMES = 64   # kernel 12 keeps a landmark's edges as 64 bits
# reduced camera systems above this many bytes are solved in global memory
_MAX_SOLVE_SMEM = 200 * 1024


class _Work(ctypes.Structure):
    """Kernel 12's work description (`struct Work` in csrc/local_ba.cu):
    sizes, scalars and device pointers, read by every launch."""
    _fields_ = ([(n, ctypes.c_int) for n in ("KL", "F", "PL", "LF", "LL", "NJ")]
                + [(n, ctypes.c_float) for n in (
                    "fx", "fy", "cx", "cy", "chi2_mono", "chi2_mono4", "chi2_line2",
                    "chi2_line8", "delta_pt", "delta_ln", "ds", "lam")]
                + [(n, ctypes.c_void_p) for n in (
                    "cam_free", "kf_valid", "obs_uv", "obs_sigma2", "edge_mp",
                    "edge_valid", "mp_valid", "obs_l", "ln_sigma2", "edge_ln",
                    "ln_edge_valid", "ln_valid", "T", "X", "pgrid", "lgrid", "edge_bits",
                    "act_bits", "inl_bits", "A", "AHi", "HB", "Hpi", "bp", "lm_cost",
                    "Sred", "Hk", "dxc", "cost", "Sg")])


def bundle_adjust(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                  lines: BALineProblem | None = None) -> BAResult:
    """`bundle_adjust_plain`'s schedule. CPU tensors -> plain version; CUDA
    tensors -> kernel 12 (4 launches per iteration and 5 more, 85 at the
    default 5 + 15 iterations; no host synchronization), or raise."""
    if prob.kf_T_cw.device.type == "cpu":
        return bundle_adjust_plain(prob, intr, cfg, lines=lines)
    f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    if not 1 <= KL <= MAX_BA_KEYFRAMES:
        raise ValueError(f"bundle_adjust: {KL} keyframes, at most {MAX_BA_KEYFRAMES}")
    typed = [(prob.kf_T_cw, f32), (prob.kf_free, b8), (prob.kf_valid, b8),
             (prob.obs_uv, f32), (prob.obs_sigma2, f32), (prob.edge_mp, i32),
             (prob.edge_valid, b8), (prob.mp_xyz, f32), (prob.mp_valid, b8)]
    if lines is not None:
        LF, LL = lines.edge_ln.shape[1], lines.ln_start.shape[0]
        typed += [(lines.ln_start, f32), (lines.ln_end, f32), (lines.ln_valid, b8),
                  (lines.obs_l, f32), (lines.obs_sigma2, f32), (lines.edge_ln, i32),
                  (lines.edge_valid, b8)]
    else:
        LF = LL = 0
    for t, dt in typed:
        kernels.check_dtype("bundle_adjust", t, dt)
    ins = [t.contiguous() for t, _ in typed]
    kernels.check_cuda("bundle_adjust", *ins)
    (T_in, kf_free, kf_valid, obs_uv, obs_sigma2, edge_mp, edge_valid, mp_xyz,
     mp_valid) = ins[:9]
    dev = T_in.device
    NJ = PL + 2 * LL
    T = T_in.clone()
    X = torch.cat([mp_xyz] + ins[9:11]) if lines is not None else mp_xyz.clone()
    cam_free = kf_free & kf_valid
    empty = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    buf = dict(
        T=T, X=X, cam_free=cam_free,
        pgrid=torch.zeros((KL, PL, 4), dtype=f32, device=dev),
        lgrid=torch.zeros((KL, max(LL, 1), 5), dtype=f32, device=dev),
        edge_bits=empty(PL + LL, dt=i64), act_bits=empty(NJ, dt=i64),
        inl_bits=empty(PL + LL, dt=i64), A=empty(KL, NJ, 18), AHi=empty(KL, NJ, 18),
        HB=empty(KL, NJ, 27), Hpi=empty(NJ, 9), bp=empty(NJ, 3), lm_cost=empty(PL + LL),
        Sred=empty(KL * (KL + 1) // 2, 36), Hk=empty(KL, 33), dxc=empty(KL, 6),
        cost=empty(1))
    n_red = 6 * KL
    if n_red * (n_red + 1) * 4 > _MAX_SOLVE_SMEM:
        buf["Sg"] = empty(n_red * (n_red + 1))
    work = _Work(KL=KL, F=F, PL=PL, LF=LF, LL=LL, NJ=NJ, fx=intr.fx, fy=intr.fy,
                 cx=intr.cx, cy=intr.cy, chi2_mono=cfg.chi2_mono,
                 chi2_mono4=cfg.chi2_mono * 4, chi2_line2=2.0 * cfg.chi2_line,
                 chi2_line8=cfg.chi2_line * 8, delta_pt=cfg.huber_delta_point,
                 delta_ln=cfg.huber_delta_line, ds=1.0 + cfg.lm_lambda_init,
                 lam=cfg.lm_lambda_init, kf_valid=kf_valid.data_ptr(),
                 obs_uv=obs_uv.data_ptr(), obs_sigma2=obs_sigma2.data_ptr(),
                 edge_mp=edge_mp.data_ptr(), edge_valid=edge_valid.data_ptr(),
                 mp_valid=mp_valid.data_ptr(),
                 **{k: v.data_ptr() for k, v in buf.items()})
    if lines is not None:
        (work.ln_valid, work.obs_l, work.ln_sigma2, work.edge_ln,
         work.ln_edge_valid) = [t.data_ptr() for t in ins[11:]]
    ws = ctypes.addressof(work)
    kernels.launch("local_ba", ws, entry="ba_grid")
    kernels.launch("local_ba", ws, 0, entry="ba_classify")
    for phase, iters in enumerate((cfg.local_ba_iters_first, cfg.local_ba_iters_second)):
        if phase:
            kernels.launch("local_ba", ws, 1, entry="ba_classify")
        for _ in range(iters):
            for entry in ("ba_landmarks", "ba_reduce", "ba_solve", "ba_backsub"):
                kernels.launch("local_ba", ws, entry=entry)
    kernels.launch("local_ba", ws, 2, entry="ba_classify")
    inlier = empty(KL, F, dt=b8)
    line_inlier = empty(KL, LF, dt=b8) if lines is not None else None
    kernels.launch("local_ba", ws, kernels.ptr(inlier),
                   kernels.ptr(line_inlier if lines is not None else inlier),
                   entry="ba_edges")
    T = T.reshape(KL, 4, 4)
    if lines is None:
        return BAResult(kf_T_cw=T, mp_xyz=X, edge_inlier=inlier, cost=buf["cost"][0])
    return BAResult(kf_T_cw=T, mp_xyz=X[:PL], edge_inlier=inlier, cost=buf["cost"][0],
                    ln_start=X[PL:PL + LL], ln_end=X[PL + LL:], line_inlier=line_inlier)


__all__ = ["BAProblem", "BALineProblem", "BAResult", "bundle_adjust", "bundle_adjust_plain"]
