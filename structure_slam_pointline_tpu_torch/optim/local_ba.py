"""Local bundle adjustment: batched Gauss-Newton with a Schur complement.

Counterpart of structure_slam_pointline_tpu/optim/local_ba.py, points
only (the reference passes `lines=None` when `use_lines` is off; line
endpoints are the next slice). The [KL, F] keyframe-major edge grid is
laid out once per call as a dense [KL, PL] camera x landmark grid (each
landmark is observed at most once per keyframe), per-landmark 3x3 blocks
reduce over KL, per-camera 6x6 blocks over PL, and the reduced camera
system S = blockdiag(Hcc) - (A Hpp^-1) A^T is solved densely. Schedule:
5 iterations, the chi2 cut, 15 more; 3x3 blocks get the trace-relative
damping floor of the reference (local_ba.py:286-315). These run as torch
ops on the device; the Schur product is one matmul.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


class BAResult(NamedTuple):
    kf_T_cw: torch.Tensor      # [KL, 4, 4]
    mp_xyz: torch.Tensor       # [PL, 3]
    edge_inlier: torch.Tensor  # [KL, F]
    cost: torch.Tensor


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


def bundle_adjust(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig) -> BAResult:
    """Run the 5 + cut + 15 schedule on the local problem."""
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    dtype = prob.kf_T_cw.dtype
    dev = prob.kf_T_cw.device
    obs, info, edge_lm, base_kf = _to_dense_grid(prob)
    free_f = (prob.kf_free & prob.kf_valid).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    kk = torch.arange(KL, device=dev)

    def chi2_planes(T, X, mask):
        pp = _project_planes(T, X, intr)
        ru = obs[0] - pp["u"]
        rv = obs[1] - pp["v"]
        chi2 = (ru * ru + rv * rv) * info
        return pp, ru, rv, torch.where(mask, chi2, torch.zeros_like(chi2))

    def lm_phase(T, X, edge_mask, n_iters, lam):
        cnt = edge_mask.sum(0)
        pt_free = prob.mp_valid & (cnt >= 2)
        evf = (edge_mask & pt_free[None, :]).to(dtype)
        ev = evf > 0
        ptf = pt_free.to(dtype)
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
            AHi = torch.stack([torch.stack([
                A[i, 0] * Hpi[0][l][None, :] + A[i, 1] * Hpi[1][l][None, :]
                + A[i, 2] * Hpi[2][l][None, :] for l in range(3)]) for i in range(6)])
            M1 = AHi.permute(2, 0, 1, 3).reshape(KL * 6, 3 * PL)
            M2 = A.permute(2, 0, 1, 3).reshape(KL * 6, 3 * PL)
            S_pt = (M1 @ M2.T).reshape(KL, 6, KL, 6)
            b_pt = torch.stack([torch.sum(AHi[i, 0] * bp[0][None, :]
                                          + AHi[i, 1] * bp[1][None, :]
                                          + AHi[i, 2] * bp[2][None, :], dim=1)
                                for i in range(6)]).T
            S = -S_pt
            S[kk, :, kk, :] += Hcc * (1.0 + lam * eye6)
            fm = free_f
            S = S * (fm[:, None, None, None] * fm[None, None, :, None])
            S[kk, :, kk, :] += (1.0 - fm)[:, None, None] * eye6
            b_m = (bc - b_pt) * fm[:, None]
            Sd = S.reshape(KL * 6, KL * 6)
            dxc = torch.linalg.solve(
                Sd + 1e-6 * torch.eye(KL * 6, dtype=dtype, device=dev),
                b_m.reshape(-1)).reshape(KL, 6) * fm[:, None]
            cn = torch.linalg.norm(dxc, dim=1, keepdim=True)
            dxc_c = dxc * torch.clamp(0.5 / torch.clamp(cn, min=1e-9), max=1.0)
            rhs = [bp[j] - torch.sum(sum(A[i, j] * dxc[:, i, None] for i in range(6)),
                                     dim=0) for j in range(3)]
            dxp = torch.stack([(Hpi[l][0] * rhs[0] + Hpi[l][1] * rhs[1]
                                + Hpi[l][2] * rhs[2]) * ptf for l in range(3)])
            pn = torch.sqrt(torch.sum(dxp * dxp, dim=0, keepdim=True))
            dxp = dxp * torch.clamp(0.5 / torch.clamp(pn, min=1e-9), max=1.0)
            T = lie.se3_exp(dxc_c) @ T
            X = X + dxp
        return T, X, cost

    T1, X1, _ = lm_phase(prob.kf_T_cw, prob.mp_xyz.T, edge_lm,
                         cfg.local_ba_iters_first, cfg.lm_lambda_init)
    pp, _, _, chi2 = chi2_planes(T1, X1, edge_lm)
    keep = edge_lm & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
    T2, X2, cost = lm_phase(T1, X1, keep, cfg.local_ba_iters_second,
                            cfg.lm_lambda_init)
    pp, _, _, chi2 = chi2_planes(T2, X2, edge_lm)
    inlier_lm = edge_lm & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
    idx = kk[:, None] * PL + torch.clamp(prob.edge_mp.long(), 0, PL - 1)
    inlier = base_kf & (prob.edge_mp >= 0) & (prob.edge_mp < PL) \
        & inlier_lm.reshape(-1)[idx]
    return BAResult(kf_T_cw=T2, mp_xyz=X2.T, edge_inlier=inlier, cost=cost)


__all__ = ["BAProblem", "BAResult", "bundle_adjust"]
