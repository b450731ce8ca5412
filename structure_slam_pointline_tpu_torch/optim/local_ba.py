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

`bundle_adjust` is the wrapper of CUDA kernel 12 (csrc/local_ba.cu), in
two forms picked by shape, neither with a host synchronization: local
BA's 10-16 keyframes in one launch a call (`_persist_ba`: one thread-block
cluster runs the whole schedule, landmark-major over edge lists), global
BA's 64 (optim/global_ba.py) as a fixed chain of launches (`_kernel_ba`).
`bundle_adjust_plain` is its plain version: the schedule as torch ops,
each Schur product one matmul, the reduced system by torch.linalg.solve
(the reference's jnp.linalg.solve), over the valid keyframes and the
landmarks that have an edge.

The same schedule runs landmark-sharded (the reference's `axis_name`
form, local_ba.py:236-250, :532-555, shard-mapped by
parallel/dist_ba.py): `bundle_adjust_sharded` (kernel 12's sharded form,
the chain)
and `bundle_adjust_sharded_plain` run this process's shards of a mesh
(parallel/mesh.py), each over its own landmark columns, and sum only the
camera side of the system over the shards before one replicated solve.
One engine, `_schedule`, serves every plain form, and one launch chain,
`_kernel_ba`, the sharded form and global BA: one shard is the unsharded
schedule.
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


def _first(parts):
    """The reduction of a single shard: its own partial."""
    return parts[0]


def _restrict(prob: BAProblem, lines, rows, span):
    """The part of the problem that one landmark shard solves: the kept
    camera rows, and of the columns in the shard's span (points [lo, hi),
    lines [llo, lhi)) the ones that have an edge and are valid, with the
    edges the shard owns renumbered to them. Returns (problem, line
    problem or None, kept point columns, kept line columns) with column
    ids of the whole problem."""
    lo, hi, llo, lhi = span
    PL = prob.mp_xyz.shape[0]
    pt_ok = prob.edge_valid & (prob.edge_mp >= 0) & (prob.edge_mp < PL) & prob.kf_valid[:, None]
    pt_ok = pt_ok & (prob.edge_mp >= lo) & (prob.edge_mp < hi)
    rel = prob.edge_mp - lo
    cols, remap = _used_columns(rel, pt_ok, prob.mp_valid[lo:hi])
    sub = BAProblem(
        kf_T_cw=prob.kf_T_cw[rows], kf_free=prob.kf_free[rows], kf_valid=prob.kf_valid[rows],
        obs_uv=prob.obs_uv[rows], obs_sigma2=prob.obs_sigma2[rows],
        edge_mp=torch.where(pt_ok, remap[torch.clamp(rel, 0, hi - lo).long()], -1)[rows],
        edge_valid=pt_ok[rows], mp_xyz=prob.mp_xyz[lo:hi][cols],
        mp_valid=prob.mp_valid[lo:hi][cols])
    if lines is None:
        return sub, None, cols + lo, None
    LL = lines.ln_start.shape[0]
    ln_ok = lines.edge_valid & (lines.edge_ln >= 0) & (lines.edge_ln < LL)
    ln_ok = ln_ok & (lines.edge_ln >= llo) & (lines.edge_ln < lhi)
    lrel = lines.edge_ln - llo
    lcols, lremap = _used_columns(lrel, ln_ok, lines.ln_valid[llo:lhi])
    sub_lines = BALineProblem(
        ln_start=lines.ln_start[llo:lhi][lcols], ln_end=lines.ln_end[llo:lhi][lcols],
        ln_valid=lines.ln_valid[llo:lhi][lcols], obs_l=lines.obs_l[rows],
        obs_sigma2=lines.obs_sigma2[rows],
        edge_ln=torch.where(ln_ok, lremap[torch.clamp(lrel, 0, lhi - llo).long()], -1)[rows],
        edge_valid=ln_ok[rows])
    return sub, sub_lines, cols + lo, lcols + llo


def _plain(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig, lines, spans, psum, any_):
    """The schedule over the landmark shards in `spans` (see `_restrict`),
    run without the invalid keyframes and each shard's edgeless landmarks;
    the result scattered back. `psum` / `any_` reduce the shards' partials
    and edge flags (over the process group too, for a mesh)."""
    KL, F = prob.edge_mp.shape
    keep = prob.kf_valid
    if lines is not None:
        LL = lines.ln_start.shape[0]
        ln_ok = lines.edge_valid & (lines.edge_ln >= 0) & (lines.edge_ln < LL)
        keep = keep | ln_ok.any(1)
    rows = torch.nonzero(keep)[:, 0]
    if rows.numel() == 0:
        rows = rows.new_zeros(1)
    subs = [_restrict(prob, lines, rows, span) for span in spans]
    T, outs, inlier, line_inlier, cost = _schedule(
        [_Shard(sp, sl, intr) for sp, sl, _, _ in subs], intr, cfg, psum, any_)

    def put(full, part, idx):
        out = full.clone()
        out[idx] = part
        return out

    mp_xyz = prob.mp_xyz.clone()
    for (_, _, cols, _), (X, _, _) in zip(subs, outs):
        mp_xyz[cols] = X
    out = BAResult(kf_T_cw=put(prob.kf_T_cw, T, rows), mp_xyz=mp_xyz,
                   edge_inlier=put(torch.zeros((KL, F), dtype=torch.bool, device=rows.device),
                                   inlier, rows), cost=cost)
    if lines is None:
        return out
    ln_start, ln_end = lines.ln_start.clone(), lines.ln_end.clone()
    for (_, _, _, lcols), (_, Xs, Xe) in zip(subs, outs):
        ln_start[lcols] = Xs
        ln_end[lcols] = Xe
    line_inlier = put(torch.zeros(lines.edge_ln.shape, dtype=torch.bool, device=rows.device),
                      line_inlier, rows)
    return out._replace(ln_start=ln_start, ln_end=ln_end, line_inlier=line_inlier)


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
    PL = prob.mp_xyz.shape[0]
    LL = lines.ln_start.shape[0] if lines is not None else 0
    return _plain(prob, intr, cfg, lines, [(0, PL, 0, LL)], _first, _first)


def shard_spans(mesh, PL: int, LL: int) -> list:
    """The (lo, hi, llo, lhi) column spans of this process's shards of a
    mesh: shard g owns points [g PL / n, (g + 1) PL / n) and lines alike,
    the reference's split (`col0 = axis_index * PL`); PL and LL must
    divide by the mesh size n (parallel/dist_ba.py pads them)."""
    n = mesh.size
    if PL % n or LL % n:
        raise ValueError(f"{PL} points / {LL} lines do not divide into {n} shards: pad them")
    ps, ls = PL // n, LL // n
    return [(g * ps, (g + 1) * ps, g * ls, (g + 1) * ls) for g in mesh.local_shards]


def bundle_adjust_sharded_plain(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                                lines: BALineProblem | None, mesh) -> BAResult:
    """The sharded schedule's plain version: this process's landmark shards
    of the dense column order (`shard_spans`, padding included), each run
    over its own used columns as `bundle_adjust_plain` runs them; per
    iteration the shards' partial camera systems, gradients and costs are
    summed in shard order and over the process group (`mesh.psum`), one
    replicated solve gives the camera step and every shard
    back-substitutes its landmarks; the edge flags are ORed
    (`mesh.any`). Cameras and edge tables are replicated. Only this
    process's columns of the landmarks are optimized; the other processes'
    come back as given (parallel/dist_ba.py gathers them)."""
    PL = prob.mp_xyz.shape[0]
    LL = lines.ln_start.shape[0] if lines is not None else 0
    return _plain(prob, intr, cfg, lines, shard_spans(mesh, PL, LL), mesh.psum, mesh.any)


def _bundle_adjust_dense(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                         lines: BALineProblem | None = None) -> BAResult:
    """The schedule on dense [KL, PL] (and [KL, LL]) planes."""
    T, outs, inlier, line_inlier, cost = _schedule([_Shard(prob, lines, intr)], intr, cfg)
    X, Xs, Xe = outs[0]
    if lines is None:
        return BAResult(kf_T_cw=T, mp_xyz=X, edge_inlier=inlier, cost=cost)
    return BAResult(kf_T_cw=T, mp_xyz=X, edge_inlier=inlier, cost=cost,
                    ln_start=Xs, ln_end=Xe, line_inlier=line_inlier)


class _Shard:
    """One landmark shard on dense planes: its [KL, PL] point grids and,
    with lines, [KL, LL] line grids (column ids local to the shard), and
    the plane functions the schedule evaluates on them."""

    def __init__(self, prob: BAProblem, lines: BALineProblem | None, intr: Intrinsics):
        self.prob, self.lines, self.intr = prob, lines, intr
        self.obs, self.info, self.edge, self.base = _to_dense_grid(prob)
        self.ledge = None
        if lines is not None:
            self.l_g, self.linfo, self.ledge, self.lbase = _lines_to_grid(lines)

    def chi2_planes(self, T, X, mask):
        pp = _project_planes(T, X, self.intr)
        ru = self.obs[0] - pp["u"]
        rv = self.obs[1] - pp["v"]
        chi2 = (ru * ru + rv * rv) * self.info
        return pp, ru, rv, torch.where(mask, chi2, torch.zeros_like(chi2))

    def line_chi2_planes(self, T, Xs, Xe, mask):
        """Per-endpoint signed distances e = l . (u, v, 1) on [KL, LL]."""
        l_g = self.l_g
        pps = _project_planes(T, Xs, self.intr)
        ppe = _project_planes(T, Xe, self.intr)
        e_s = l_g[0] * pps["u"] + l_g[1] * pps["v"] + l_g[2]
        e_e = l_g[0] * ppe["u"] + l_g[1] * ppe["v"] + l_g[2]
        zero = torch.zeros_like(e_s)
        c_s = torch.where(mask, e_s * e_s * self.linfo, zero)
        c_e = torch.where(mask, e_e * e_e * self.linfo, zero)
        return pps, ppe, e_s, e_e, c_s, c_e

    def line_terms(self, pp):
        """(Jc [6] planes, Jx [3] planes) of one endpoint set: l0 * Ju +
        l1 * Jv is d(-e)/d. in the point planes' convention."""
        l_g = self.l_g
        (Ju, Jv), (Jxu, Jxv) = _jacobian_planes(pp)
        return ([l_g[0] * Ju[i] + l_g[1] * Jv[i] for i in range(6)],
                [l_g[0] * Jxu[j] + l_g[1] * Jxv[j] for j in range(3)])

    def inliers(self, T, X, Xs, Xe, cfg):
        """The final classification in the shard's [KL, F] / [KL, LF]
        layout: True only on inlier edges the shard owns."""
        KL = T.shape[0]
        prob, lines = self.prob, self.lines
        PL = prob.mp_xyz.shape[0]
        kk = torch.arange(KL, device=T.device)
        pp, _, _, chi2 = self.chi2_planes(T, X, self.edge)
        inlier_lm = self.edge & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
        idx = kk[:, None] * PL + torch.clamp(prob.edge_mp.long(), 0, PL - 1)
        inlier = self.base & (prob.edge_mp >= 0) & (prob.edge_mp < PL) \
            & inlier_lm.reshape(-1)[idx]
        if lines is None:
            return inlier, None
        LL = lines.ln_start.shape[0]
        pps, ppe, _, _, c_s, c_e = self.line_chi2_planes(T, Xs, Xe, self.ledge)
        inl_ln = self.ledge & (c_s + c_e <= 2.0 * cfg.chi2_line) & (pps["z"] > 0) \
            & (ppe["z"] > 0)
        lidx = kk[:, None] * LL + torch.clamp(lines.edge_ln.long(), 0, LL - 1)
        line_inlier = self.lbase & (lines.edge_ln >= 0) & (lines.edge_ln < LL) \
            & inl_ln.reshape(-1)[lidx]
        return inlier, line_inlier


def _schedule(shards: list, intr: Intrinsics, cfg: OptimConfig, psum=_first, any_=_first):
    """The 5 + cut + 15 schedule over landmark shards that share the cameras
    (the same rows and poses, `shards[0].prob.kf_T_cw`). Each iteration
    every shard forms its partial reduced camera system -sum A Hpp^-1 A^T,
    gradient, camera blocks Hcc and cost; `psum` sums them (one shard: its
    own); damping and the fixed cameras' identity rows go in once, after
    the sum; the one solve gives the camera step and each shard
    back-substitutes its landmarks. Returns (poses, per shard (points [PL,
    3], line starts, line ends), inlier flags, line inlier flags, cost),
    the flags reduced with `any_`."""
    prob0 = shards[0].prob
    KL = prob0.edge_mp.shape[0]
    dtype = prob0.kf_T_cw.dtype
    dev = prob0.kf_T_cw.device
    free_f = (prob0.kf_free & prob0.kf_valid).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    kk = torch.arange(KL, device=dev)

    def one_endpoint(Jc_l, Jx_l, w_l, r_l, lam, lnf, LL):
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

    def partial(sh, T, X, Xs, Xe, fl, lam):
        """One shard's (-sum A Hpp^-1 A^T, bc - A Hpp^-1 bp, Hcc, cost) and
        its back-substitution terms."""
        ev, evf, ptf, lev, levf, lnf = fl
        PL = sh.prob.mp_xyz.shape[0]
        pp, ru, rv, chi2 = sh.chi2_planes(T, X, ev)
        cost = torch.sum(torch.clamp(chi2, max=cfg.chi2_mono * 4) * evf)
        w = huber_weight(chi2, cfg.huber_delta_point) * sh.info * evf
        (Ju, Jv), (Jxu, Jxv) = _jacobian_planes(pp)
        wJu = [w * q for q in Ju]
        wJv = [w * q for q in Jv]
        Hcc = torch.stack([torch.stack([
            torch.sum(wJu[i] * Ju[j] + wJv[i] * Jv[j], dim=1) for j in range(6)])
            for i in range(6)]).permute(2, 0, 1)                      # [KL, 6, 6]
        bc = -torch.stack([torch.sum(wJu[i] * ru + wJv[i] * rv, dim=1)
                           for i in range(6)]).T                       # [KL, 6]
        wJxu = [w * q for q in Jxu]
        wJxv = [w * q for q in Jxv]
        Hpp = [[torch.sum(wJxu[i] * Jxu[j] + wJxv[i] * Jxv[j], dim=0)
                for j in range(3)] for i in range(3)]
        bp = [-torch.sum(wJxu[i] * ru + wJxv[i] * rv, dim=0) for i in range(3)]
        A = torch.stack([torch.stack([wJu[i] * Jxu[j] + wJv[i] * Jxv[j]
                                      for j in range(3)]) for i in range(6)])
        Hpi = _plane_inv3(Hpp, lam, ptf)                               # [3][3] of [PL]
        S_pt, b_pt = _schur_block(A, Hpi, bp, KL, PL)
        out_s = out_e = None
        if sh.lines is not None:
            LL = sh.lines.ln_start.shape[0]
            pps, ppe, e_s, e_e, c_s, c_e = sh.line_chi2_planes(T, Xs, Xe, lev)
            cost = cost + torch.sum(torch.clamp(c_s + c_e, max=cfg.chi2_line * 8) * levf)
            w_s = huber_weight(c_s, cfg.huber_delta_line) * sh.linfo * levf
            w_e = huber_weight(c_e, cfg.huber_delta_line) * sh.linfo * levf
            Jc_s, Jx_s = sh.line_terms(pps)
            Jc_e, Jx_e = sh.line_terms(ppe)
            out_s = one_endpoint(Jc_s, Jx_s, w_s, -e_s, lam, lnf, LL)
            out_e = one_endpoint(Jc_e, Jx_e, w_e, -e_e, lam, lnf, LL)
            Hcc = Hcc + out_s[0] + out_e[0]
            bc = bc + out_s[1] + out_e[1]
        S = -S_pt
        b_red = bc - b_pt
        if sh.lines is not None:
            S = S - out_s[5] - out_e[5]
            b_red = b_red - out_s[6] - out_e[6]
        return S, b_red, Hcc, cost, (A, Hpi, bp, out_s, out_e)

    def flags(sh, edge_mask, ln_mask):
        cnt = edge_mask.sum(0)
        pt_free = sh.prob.mp_valid & (cnt >= 2)
        evf = (edge_mask & pt_free[None, :]).to(dtype)
        lev = levf = lnf = None
        if sh.lines is not None:
            ln_free = sh.lines.ln_valid & (ln_mask.sum(0) >= 2)
            levf = (ln_mask & ln_free[None, :]).to(dtype)
            lev = levf > 0
            lnf = ln_free.to(dtype)
        return evf > 0, evf, pt_free.to(dtype), lev, levf, lnf

    def lm_phase(T, Xs, masks, n_iters, lam):
        fls = [flags(sh, *m) for sh, m in zip(shards, masks)]
        cost = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(n_iters):
            parts = [partial(sh, T, *x, fl, lam) for sh, x, fl in zip(shards, Xs, fls)]
            S = psum([p[0] for p in parts])
            b_red = psum([p[1] for p in parts])
            Hcc = psum([p[2] for p in parts])
            cost = psum([p[3] for p in parts])
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
            new = []
            for (X, Xs_, Xe_), p, fl in zip(Xs, parts, fls):
                A, Hpi, bp, out_s, out_e = p[4]
                dxp = _backsub(A, Hpi, bp, dxc, fl[2])
                if out_s is not None:
                    Xs_ = Xs_ + _backsub(out_s[2], out_s[3], out_s[4], dxc, fl[5])
                    Xe_ = Xe_ + _backsub(out_e[2], out_e[3], out_e[4], dxc, fl[5])
                new.append((X + dxp, Xs_, Xe_))
            T = lie.se3_exp(dxc_c) @ T
            Xs = new
        return T, Xs, cost

    X0 = [(sh.prob.mp_xyz.T,) + ((sh.lines.ln_start.T, sh.lines.ln_end.T)
                                 if sh.lines is not None else (None, None)) for sh in shards]
    T1, X1, _ = lm_phase(prob0.kf_T_cw, X0, [(sh.edge, sh.ledge) for sh in shards],
                         cfg.local_ba_iters_first, cfg.lm_lambda_init)
    masks = []
    for sh, (Xp, Xs1, Xe1) in zip(shards, X1):
        pp, _, _, chi2 = sh.chi2_planes(T1, Xp, sh.edge)
        keep = sh.edge & (chi2 <= cfg.chi2_mono) & (pp["z"] > 0)
        keep_ln = sh.ledge
        if sh.lines is not None:
            pps, ppe, _, _, c_s, c_e = sh.line_chi2_planes(T1, Xs1, Xe1, sh.ledge)
            keep_ln = sh.ledge & (c_s + c_e <= 2.0 * cfg.chi2_line) & (pps["z"] > 0) \
                & (ppe["z"] > 0)
        masks.append((keep, keep_ln))
    T2, X2, cost = lm_phase(T1, X1, masks, cfg.local_ba_iters_second, cfg.lm_lambda_init)
    flags_out = [sh.inliers(T2, *x, cfg) for sh, x in zip(shards, X2)]
    inlier = any_([f[0] for f in flags_out])
    line_inlier = any_([f[1] for f in flags_out]) if shards[0].lines is not None else None
    outs = [(Xp.T, Xs.T if Xs is not None else None, Xe.T if Xe is not None else None)
            for Xp, Xs, Xe in X2]
    return T2, outs, inlier, line_inlier, cost


MAX_BA_KEYFRAMES = 64   # kernel 12 keeps a landmark's edges as 64 bits


class _Work(ctypes.Structure):
    """Kernel 12's work description (`struct Work` in csrc/local_ba.cu):
    sizes, scalars and device pointers, read by every launch. The sharded
    form's fields (`col0`, `ln_col0`, `cost_part`) stay 0 / null in the
    unsharded forms; the one-launch form's (`iters1` on) stay 0 / null in
    the chain."""
    _fields_ = ([(n, ctypes.c_int) for n in ("KL", "F", "PL", "LF", "LL", "NJ", "col0",
                                             "ln_col0")]
                + [(n, ctypes.c_float) for n in (
                    "fx", "fy", "cx", "cy", "chi2_mono", "chi2_mono4", "chi2_line2",
                    "chi2_line8", "delta_pt", "delta_ln", "ds", "lam")]
                + [(n, ctypes.c_void_p) for n in (
                    "cam_free", "kf_valid", "obs_uv", "obs_sigma2", "edge_mp",
                    "edge_valid", "mp_valid", "obs_l", "ln_sigma2", "edge_ln",
                    "ln_edge_valid", "ln_valid", "T", "X", "pgrid", "lgrid", "edge_bits",
                    "act_bits", "inl_bits", "A", "AHi", "HB", "Hpi", "bp", "lm_cost",
                    "Sred", "Hk", "dxc", "cost", "Sg", "cost_part", "piv")]
                + [(n, ctypes.c_int) for n in ("iters1", "iters2")]
                + [(n, ctypes.c_void_p) for n in (
                    "T_in", "X_pt", "X_ls", "X_le", "kf_free", "lm_info", "lm_off", "counts",
                    "obs", "Ae", "trace")])


def _kernel_inputs(what: str, prob: BAProblem, lines):
    """Kernel 12's inputs checked (dtype, one CUDA device) and contiguous:
    the problem's 9 tensors, then the line problem's 7."""
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    KL = prob.edge_mp.shape[0]
    if not 1 <= KL <= MAX_BA_KEYFRAMES:
        raise ValueError(f"{what}: {KL} keyframes, at most {MAX_BA_KEYFRAMES}")
    typed = [(prob.kf_T_cw, f32), (prob.kf_free, b8), (prob.kf_valid, b8),
             (prob.obs_uv, f32), (prob.obs_sigma2, f32), (prob.edge_mp, i32),
             (prob.edge_valid, b8), (prob.mp_xyz, f32), (prob.mp_valid, b8)]
    if lines is not None:
        typed += [(lines.ln_start, f32), (lines.ln_end, f32), (lines.ln_valid, b8),
                  (lines.obs_l, f32), (lines.obs_sigma2, f32), (lines.edge_ln, i32),
                  (lines.edge_valid, b8)]
    for t, dt in typed:
        kernels.check_dtype(what, t, dt)
    ins = [t.contiguous() for t, _ in typed]
    kernels.check_cuda(what, *ins)
    return ins


def _work(ins, intr: Intrinsics, cfg: OptimConfig, PL: int, LL: int, buf: dict,
          col0: int = 0, ln_col0: int = 0) -> _Work:
    """The Work of one launch chain over landmark columns [col0, col0 + PL)
    and lines [ln_col0, ln_col0 + LL) (`buf`: its device buffers)."""
    KL, F = ins[5].shape
    LF = ins[14].shape[1] if len(ins) > 9 else 0
    work = _Work(KL=KL, F=F, PL=PL, LF=LF, LL=LL, NJ=PL + 2 * LL, col0=col0, ln_col0=ln_col0,
                 fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy, chi2_mono=cfg.chi2_mono,
                 chi2_mono4=cfg.chi2_mono * 4, chi2_line2=2.0 * cfg.chi2_line,
                 chi2_line8=cfg.chi2_line * 8, delta_pt=cfg.huber_delta_point,
                 delta_ln=cfg.huber_delta_line, ds=1.0 + cfg.lm_lambda_init,
                 lam=cfg.lm_lambda_init, kf_valid=ins[2].data_ptr(),
                 obs_uv=ins[3].data_ptr(), obs_sigma2=ins[4].data_ptr(),
                 edge_mp=ins[5].data_ptr(), edge_valid=ins[6].data_ptr(),
                 **{k: v.data_ptr() for k, v in buf.items()})
    if len(ins) > 9:
        (work.obs_l, work.ln_sigma2, work.edge_ln, work.ln_edge_valid) = [
            t.data_ptr() for t in ins[12:]]
    return work


def _landmark_buffers(KL: int, PL: int, LL: int, dev) -> dict:
    """Device buffers of one launch chain's landmark side."""
    NJ = PL + 2 * LL
    empty = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    return dict(pgrid=torch.zeros((KL, PL, 4), dtype=torch.float32, device=dev),
                lgrid=torch.zeros((KL, max(LL, 1), 5), dtype=torch.float32, device=dev),
                edge_bits=empty(PL + LL, dt=torch.int64), act_bits=empty(NJ, dt=torch.int64),
                inl_bits=empty(PL + LL, dt=torch.int64), A=empty(KL, NJ, 18),
                AHi=empty(KL, NJ, 18), HB=empty(KL, NJ, 27), Hpi=empty(NJ, 9), bp=empty(NJ, 3),
                lm_cost=empty(PL + LL))


def _solve_matrix(KL: int, dev) -> dict:
    """The solve's augmented matrix (global memory, L2-resident; 6 rows per
    free camera, so the free cameras' rows fill its front) and pivot rows."""
    n_red = 6 * KL
    return {"Sg": torch.empty(n_red * (n_red + 1), dtype=torch.float32, device=dev),
            "piv": torch.empty(n_red, dtype=torch.int32, device=dev)}


ONE_LAUNCH_KEYFRAMES = 16   # kernel 12's one-launch form: a camera per half-warp lane


def bundle_adjust(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                  lines: BALineProblem | None = None) -> BAResult:
    """`bundle_adjust_plain`'s schedule. CPU tensors -> plain version; CUDA
    tensors -> kernel 12, or raise, in the form its shape picks (no host
    synchronization in either):
    - up to 16 keyframes (local BA's window): one launch a call
      (`_persist_ba`: the whole schedule in one thread-block cluster,
      landmark-major, no [KL, landmarks] planes);
    - more (global BA's 64): the launch chain (`_kernel_ba`: 4 launches per
      iteration and 5 more, 85 at the default 5 + 15 iterations)."""
    if prob.kf_T_cw.device.type == "cpu":
        return bundle_adjust_plain(prob, intr, cfg, lines=lines)
    if prob.edge_mp.shape[0] <= ONE_LAUNCH_KEYFRAMES:
        return _persist_ba("bundle_adjust", prob, intr, cfg, lines)
    return _kernel_ba("bundle_adjust", prob, intr, cfg, lines, None)


def bundle_adjust_sharded(prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                          lines: BALineProblem | None, mesh) -> BAResult:
    """`bundle_adjust_sharded_plain`'s schedule over this process's shards of
    `mesh` (parallel/mesh.py; the landmark counts divide by its size).
    CPU tensors -> plain version; CUDA tensors -> kernel 12's sharded form
    (or raise), counted as `local_ba_shard`: 65 launches per local shard
    and 20 solves per call (default 5 + 15 iterations), no host
    synchronization. Only this process's landmark columns are optimized;
    the others come back as given."""
    if prob.kf_T_cw.device.type == "cpu":
        return bundle_adjust_sharded_plain(prob, intr, cfg, lines, mesh)
    if prob.kf_T_cw.device != mesh.device:
        raise ValueError(f"bundle_adjust_sharded: tensors on {prob.kf_T_cw.device}, mesh on "
                         f"{mesh.device}")
    return _kernel_ba("bundle_adjust_sharded", prob, intr, cfg, lines, mesh)


def _persist_ba(what: str, prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
                lines: BALineProblem | None, trace: torch.Tensor | None = None) -> BAResult:
    """Kernel 12's one-launch form (`ba_persist`, counted as `local_ba`):
    the caller's inputs are read in place and the outputs written by the
    launch itself (no torch op runs on the card); `trace` (int64 [16]) is
    for a build with -DSSPL_BA_TRACE (tools/kernel_ab.py)."""
    ins = _kernel_inputs(what, prob, lines)
    dev = ins[0].device
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    LL = lines.ln_start.shape[0] if lines is not None else 0
    LF = lines.edge_ln.shape[1] if lines is not None else 0
    NJ = PL + 2 * LL
    slots = KL * (F + 2 * LF)   # a point edge takes one slot, a line edge two
    empty = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    i32, i64 = torch.int32, torch.int64
    T = empty(KL, 4, 4)
    X = empty(max(NJ, 1), 3)
    inl = empty(KL, F, dt=torch.bool)
    linl = empty(KL, LF, dt=torch.bool) if lines is not None else inl
    cost = empty(1)
    buf = dict(T=T, X=X, cost=cost, edge_bits=empty(PL + LL, dt=i64),
               inl_bits=empty(PL + LL, dt=i64),
               Hpi=empty(NJ, 9), bp=empty(NJ, 3), mp_valid=ins[8], T_in=ins[0], X_pt=ins[7],
               kf_free=ins[1], lm_info=empty(PL + LL, 4, dt=i32), lm_off=empty(PL + LL, dt=i32),
               counts=empty(3, dt=i32), obs=empty(slots, 4), Ae=empty(slots, 18),
               **_solve_matrix(KL, dev))
    if lines is not None:
        buf.update(ln_valid=ins[11], X_ls=ins[9], X_le=ins[10])
    if trace is not None:
        buf["trace"] = trace
    work = _work(ins, intr, cfg, PL, LL, buf)
    work.iters1, work.iters2 = cfg.local_ba_iters_first, cfg.local_ba_iters_second
    kernels.launch("local_ba", ctypes.addressof(work), kernels.ptr(inl), kernels.ptr(linl),
                   entry="ba_persist")
    res = BAResult(kf_T_cw=T, mp_xyz=X[:PL], edge_inlier=inl, cost=cost[0])
    if lines is None:
        return res
    return res._replace(ln_start=X[PL:PL + LL], ln_end=X[PL + LL:NJ], line_inlier=linl)


def _kernel_ba(what: str, prob: BAProblem, intr: Intrinsics, cfg: OptimConfig,
               lines: BALineProblem | None, mesh, trace: torch.Tensor | None = None) -> BAResult:
    """Kernel 12's launch chain, unsharded (`mesh` None: one span of every
    column on the caller's stream, counted as `local_ba`) or over this
    process's shards of `mesh` (counted as `local_ba_shard`):
    - each shard runs ba_grid, ba_classify, and per iteration ba_landmarks
      and ba_reduce (its partial Sred / Hk, and with a mesh its partial
      cost) on its own stream with its own buffers; its edge ids are taken
      relative to its first column;
    - with a mesh, on the caller's stream after every shard's reduce
      (events), the partials are summed in shard order, then
      `all_reduce`d over the process group when it has more than one
      rank, and one ba_solve reads the sum (the damping and fixed-camera
      rows added there, once); unsharded, ba_solve reads the one span's
      buffers and sums its landmark costs itself;
    - every shard stream waits for the solve, then back-substitutes;
    - each shard's ba_edges writes its own flags; they are ORed, then
      summed over the group (> 0).
    `trace` (int64 [16]) reaches the solve's Work, for a build with
    -DSSPL_BA_TRACE (tools/kernel_ab.py)."""
    ins = _kernel_inputs(what, prob, lines)
    T_in, kf_free, kf_valid, mp_xyz, mp_valid = ins[0], ins[1], ins[2], ins[7], ins[8]
    dev = T_in.device
    KL, F = prob.edge_mp.shape
    PL = prob.mp_xyz.shape[0]
    LL = lines.ln_start.shape[0] if lines is not None else 0
    LF = lines.edge_ln.shape[1] if lines is not None else 0
    sharded = mesh is not None
    name = "local_ba_shard" if sharded else "local_ba"
    spans = shard_spans(mesh, PL, LL) if sharded else [(0, PL, 0, LL)]
    nl = len(spans)
    n_pairs = KL * (KL + 1) // 2
    n_part = n_pairs * 36 + KL * 33 + 1
    f32 = torch.float32
    T = T_in.clone()
    cost = torch.empty(1, dtype=f32, device=dev)
    shared = dict(T=T, cam_free=kf_free & kf_valid, cost=cost,
                  dxc=torch.empty((KL, 6), dtype=f32, device=dev))
    # per shard: [Sred | Hk | cost]; zeros where its reduce skips a pair
    parts = torch.zeros((nl, n_part), dtype=f32, device=dev)
    total = torch.empty(n_part, dtype=f32, device=dev) if sharded else None

    def views(v):
        out = dict(Sred=v[:n_pairs * 36], Hk=v[n_pairs * 36:n_pairs * 36 + KL * 33])
        if sharded:
            out["cost_part"] = v[n_pairs * 36 + KL * 33:]
        return out

    works, bufs = [], []   # Work structs and their buffers, alive until every launch
    for s, (lo, hi, llo, lhi) in enumerate(spans):
        X = torch.cat([mp_xyz[lo:hi], ins[9][llo:lhi], ins[10][llo:lhi]]) \
            if lines is not None else mp_xyz[lo:hi].clone()
        buf = dict(X=X, mp_valid=mp_valid[lo:hi].contiguous(), **shared, **views(parts[s]),
                   **_landmark_buffers(KL, hi - lo, lhi - llo, dev))
        if lines is not None:
            buf["ln_valid"] = ins[11][llo:lhi].contiguous()
        if not sharded:
            buf.update(_solve_matrix(KL, dev))
        works.append(_work(ins, intr, cfg, hi - lo, lhi - llo, buf, col0=lo, ln_col0=llo))
        bufs.append(buf)
    if sharded:   # the solve's own Work, reading the summed partials
        bufs.append(dict(**shared, **views(total), **_solve_matrix(KL, dev)))
        works.append(_work(ins, intr, cfg, 0, 0, bufs[-1]))
    if trace is not None:
        bufs[-1]["trace"] = trace
        works[-1].trace = trace.data_ptr()
    solve = works[-1]
    inl = torch.empty((nl, KL, F), dtype=torch.bool, device=dev)
    linl = torch.empty((nl, KL, LF), dtype=torch.bool, device=dev) if lines is not None \
        else None
    main = torch.cuda.current_stream(dev)
    streams = mesh.streams if sharded else [main]

    def launch(work, *args, entry):
        kernels.launch(name, ctypes.addressof(work), *args, entry=entry)

    def on_shards(fn):
        for s, (ws, stream) in enumerate(zip(works[:nl], streams)):
            with torch.cuda.stream(stream):
                fn(s, ws)

    def wait(waiters, waited):
        if sharded:
            for a, b in ((w, x) for w in waiters for x in waited):
                a.wait_stream(b)

    wait(streams, [main])
    on_shards(lambda s, ws: (launch(ws, entry="ba_grid"), launch(ws, 0, entry="ba_classify")))
    for phase, iters in enumerate((cfg.local_ba_iters_first, cfg.local_ba_iters_second)):
        if phase:
            on_shards(lambda s, ws: launch(ws, 1, entry="ba_classify"))
        for _ in range(iters):
            on_shards(lambda s, ws: (launch(ws, entry="ba_landmarks"),
                                     launch(ws, entry="ba_reduce")))
            if sharded:
                wait([main], streams)
                total.copy_(parts[0])
                for s in range(1, nl):
                    total.add_(parts[s])
                mesh.all_reduce(total)
            launch(solve, entry="ba_solve")
            wait(streams, [main])
            on_shards(lambda s, ws: launch(ws, entry="ba_backsub"))
    on_shards(lambda s, ws: (launch(ws, 2, entry="ba_classify"),
                             launch(ws, kernels.ptr(inl[s]),
                                    kernels.ptr(linl[s] if lines is not None else inl[s]),
                                    entry="ba_edges")))
    wait([main], streams)
    reduce_or = mesh.any if sharded else (lambda parts: parts[0])
    out_xyz = mp_xyz.clone()
    for (lo, hi, _, _), buf in zip(spans, bufs):
        out_xyz[lo:hi] = buf["X"][:hi - lo]
    res = BAResult(kf_T_cw=T.reshape(KL, 4, 4), mp_xyz=out_xyz,
                   edge_inlier=reduce_or(list(inl)), cost=cost[0])
    if lines is None:
        return res
    ln_start, ln_end = ins[9].clone(), ins[10].clone()
    for (lo, hi, llo, lhi), buf in zip(spans, bufs):
        n, X = hi - lo, buf["X"]
        ln_start[llo:lhi] = X[n:n + lhi - llo]
        ln_end[llo:lhi] = X[n + lhi - llo:]
    return res._replace(ln_start=ln_start, ln_end=ln_end, line_inlier=reduce_or(list(linl)))


__all__ = ["BAProblem", "BALineProblem", "BAResult", "bundle_adjust", "bundle_adjust_plain",
           "bundle_adjust_sharded", "bundle_adjust_sharded_plain", "shard_spans"]
