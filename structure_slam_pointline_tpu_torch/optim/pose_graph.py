"""Sim(3) pose-graph (essential graph) optimization and the Sim(3) pair
refinement of loop verification (kernels 18 and 17).

Counterpart of structure_slam_pointline_tpu/optim/pose_graph.py.
Vertices are per-keyframe Sim(3) transforms S_cw; edge (i, j) carries a
measured S_ji and the residual r = log(S_ji S_i S_j^-1). The reference
takes both 7x7 Jacobians with jax.jacfwd, scatters the normal equations
into a dense [7K, 7K] system, and runs damped LM steps with
accept / reject. `optimize_sim3_pair` is the reference's OptimizeSim3:
one Sim(3) vertex, two projection edges per matched pair, Huber IRLS,
5 iterations, the chi2 cut, 10 more.

`optimize_pose_graph` is the wrapper of CUDA kernel 18
(csrc/pose_graph.cu, five launches per iteration, no host
synchronization) and `optimize_sim3_pair` of kernel 17
(csrc/sim3_pair.cu, one launch). Their plain versions follow the
reference op for op; the Jacobians are forward-mode derivatives
(torch.func.jvp, the tangent lanes batched in one call) through utils/lie.py's
Sim(3) maps, which is what jacfwd computes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.utils import lie


class PoseGraphProblem(NamedTuple):
    S_cw: torch.Tensor        # [K, 4, 4] initial Sim(3) world -> camera per keyframe
    kf_valid: torch.Tensor    # [K] bool
    kf_fixed: torch.Tensor    # [K] bool (the loop keyframe, invalid ones)
    edge_i: torch.Tensor      # [E] int32
    edge_j: torch.Tensor      # [E] int32
    edge_Sji: torch.Tensor    # [E, 4, 4] measured S_j S_i^-1
    edge_valid: torch.Tensor  # [E] bool
    edge_weight: torch.Tensor  # [E] information weight


def _edge_residual(S_i, S_j, S_m):
    """[..., 7] Sim(3) residual of edges."""
    return lie.sim3_log(S_m @ S_i @ lie.sim3_inverse(S_j))


def _jacobian_columns(f, z: torch.Tensor):
    """d f / d z [..., R, 7] at z [..., 7] by forward mode: the 7 tangent
    lanes ride in one leading batch axis of a single jvp (f broadcasts
    over it), lane l seeded with the unit vector e_l, as jacfwd seeds them."""
    L = z.shape[-1]
    zb = z.expand(L, *z.shape).contiguous()
    seed = torch.eye(L, dtype=z.dtype, device=z.device)
    t = seed.reshape(L, *([1] * (z.dim() - 1)), L).expand_as(zb).contiguous()
    return torch.func.jvp(f, (zb,), (t,))[1].movedim(0, -1)


def edge_jacobians(S_all: torch.Tensor, prob: PoseGraphProblem):
    """(r [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]) at xi = 0 (pose_graph.py:58-78):
    one jvp of 14 lanes, the first seven perturbing S_i, the last seven
    S_j (the other side's tangent is zero, so each lane is jacfwd's)."""
    S_i = S_all[prob.edge_i.long()]
    S_j = S_all[prob.edge_j.long()]
    S_m = prob.edge_Sji
    z = torch.zeros(S_i.shape[:-2] + (14,), dtype=S_all.dtype, device=S_all.device)
    r = _edge_residual(S_i, S_j, S_m)
    J = _jacobian_columns(lambda x: _edge_residual(lie.sim3_exp(x[..., :7]) @ S_i,
                                                   lie.sim3_exp(x[..., 7:]) @ S_j, S_m), z)
    return r, J[..., :7], J[..., 7:]


def normal_equations(prob: PoseGraphProblem, S_all: torch.Tensor, lam):
    """The damped dense system (H [7K, 7K], b [7K]) of one LM iteration
    (pose_graph.py:80-109): fixed and invalid vertices get (1 + lam) I and
    a zero right side."""
    K = S_all.shape[0]
    dtype, dev = S_all.dtype, S_all.device
    free_f = (prob.kf_valid & ~prob.kf_fixed).to(dtype)
    ew = prob.edge_weight * prob.edge_valid.to(dtype)
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    kk = torch.arange(K, device=dev)
    r, Ji, Jj = edge_jacobians(S_all, prob)
    Hii = torch.einsum("e,eri,erj->eij", ew, Ji, Ji)
    Hjj = torch.einsum("e,eri,erj->eij", ew, Jj, Jj)
    Hij = torch.einsum("e,eri,erj->eij", ew, Ji, Jj)
    bi = -torch.einsum("e,eri,er->ei", ew, Ji, r)
    bj = -torch.einsum("e,eri,er->ei", ew, Jj, r)
    H = torch.zeros((K, K, 7, 7), dtype=dtype, device=dev)
    H.index_put_((ei, ei), Hii, accumulate=True)
    H.index_put_((ej, ej), Hjj, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((K, 7), dtype=dtype, device=dev)
    b.index_add_(0, ei, bi)
    b.index_add_(0, ej, bj)
    H = H * (free_f[:, None, None, None] * free_f[None, :, None, None])
    H[kk, kk] += (1.0 - free_f)[:, None, None] * eye7 + lam * eye7
    b = b * free_f[:, None]
    return H.permute(0, 2, 1, 3).reshape(K * 7, K * 7), b.reshape(-1)


def optimize_pose_graph_plain(prob: PoseGraphProblem, n_iters: int = 20,
                              lam_init: float = 1e-6) -> torch.Tensor:
    """Optimized S_cw [K, 4, 4]: the reference's dense [7K, 7K] LM."""
    K = prob.S_cw.shape[0]
    dtype, dev = prob.S_cw.dtype, prob.S_cw.device
    free_f = (prob.kf_valid & ~prob.kf_fixed).to(dtype)
    ew = prob.edge_weight * prob.edge_valid.to(dtype)
    ei, ej = prob.edge_i.long(), prob.edge_j.long()

    def cost_of(S_all):
        r = _edge_residual(S_all[ei], S_all[ej], prob.edge_Sji)
        return torch.sum(ew * torch.sum(r * r, dim=-1))

    # a fixed or invalid vertex's rows are (1 + lam) I with a zero right
    # side and no coupling, so its step is exactly zero: solve the free
    # vertices' block alone, as kernel 18 does
    free_v = torch.nonzero(free_f > 0)[:, 0]
    rows = (7 * free_v[:, None] + torch.arange(7, device=dev)).reshape(-1)
    S_all = prob.S_cw
    lam = torch.tensor(lam_init, dtype=dtype, device=dev)
    for _ in range(n_iters):
        Hd, b = normal_equations(prob, S_all, lam)
        dx = torch.zeros(K * 7, dtype=dtype, device=dev)
        dx[rows] = torch.linalg.solve(Hd[rows][:, rows], b[rows])
        dx = dx.reshape(K, 7)
        S_new = lie.sim3_exp(dx) @ S_all
        accept = cost_of(S_new) < cost_of(S_all)
        S_all = torch.where(accept, S_new, S_all)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-12, 1e6)
    return S_all


class _PG(ctypes.Structure):
    """Kernel 18's work description (`struct PG` in csrc/pose_graph.cu)."""
    _fields_ = ([("K", ctypes.c_int), ("E", ctypes.c_int)]
                + [(n, ctypes.c_void_p) for n in (
                    "free", "pos", "nfree", "ei", "ej", "Sm", "evalid", "ew", "S", "Snew",
                    "r", "J", "H", "piv", "cost", "lam")])


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20,
                        lam_init: float = 1e-6) -> torch.Tensor:
    """Optimized S_cw [K, 4, 4]. CPU tensors -> plain version; CUDA tensors
    -> kernel 18 (five launches per iteration, no host synchronization),
    or raise."""
    if prob.S_cw.device.type == "cpu":
        return optimize_pose_graph_plain(prob, n_iters, lam_init)
    name = "optimize_pose_graph"
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    K, E = prob.S_cw.shape[0], prob.edge_i.shape[0]
    typed = [(prob.S_cw, f32), (prob.kf_valid, b8), (prob.kf_fixed, b8), (prob.edge_i, i32),
             (prob.edge_j, i32), (prob.edge_Sji, f32), (prob.edge_valid, b8),
             (prob.edge_weight, f32)]
    for t, dt in typed:
        kernels.check_dtype(name, t, dt)
    if (prob.S_cw.shape != (K, 4, 4) or prob.kf_valid.shape != (K,)
            or prob.kf_fixed.shape != (K,) or prob.edge_j.shape != (E,)
            or prob.edge_Sji.shape != (E, 4, 4) or prob.edge_valid.shape != (E,)
            or prob.edge_weight.shape != (E,) or E == 0):
        raise ValueError(f"{name}: {K} vertices, {E} edges, inconsistent shapes")
    ins = [t.contiguous() for t, _ in typed]
    dev = kernels.check_cuda(name, *ins)
    S_in, kf_valid, kf_fixed, ei, ej, Sm, evalid, ew = ins
    free = kf_valid & ~kf_fixed
    pos = (torch.cumsum(free.to(i32), 0) - 1).to(i32)
    nfree = free.sum().to(i32).reshape(1)
    empty = lambda *shape: torch.empty(shape, dtype=f32, device=dev)  # noqa: E731
    buf = dict(S=S_in.clone(), Snew=empty(K, 4, 4), r=empty(E, 7), J=empty(E, 7, 14),
               H=empty(7 * K * (7 * K + 1)), piv=torch.empty(7 * K, dtype=i32, device=dev),
               cost=empty(E, 2),
               lam=torch.full((1,), lam_init, dtype=f32, device=dev))
    pg = _PG(K=K, E=E, free=free.data_ptr(), pos=pos.data_ptr(), nfree=nfree.data_ptr(),
             ei=ei.data_ptr(), ej=ej.data_ptr(), Sm=Sm.data_ptr(), evalid=evalid.data_ptr(),
             ew=ew.data_ptr(), **{k: v.data_ptr() for k, v in buf.items()})
    ws = ctypes.addressof(pg)
    for _ in range(n_iters):
        for entry in ("pg_jacobians", "pg_assemble", "pg_solve", "pg_cost", "pg_decide"):
            kernels.launch("pose_graph", ws, entry=entry)
    return buf["S"]


class Sim3PairResult(NamedTuple):
    S12: torch.Tensor        # [4, 4] refined Sim(3) (frame-2 coords -> frame 1)
    inliers: torch.Tensor    # [N] both edges' chi2 <= threshold
    n_inliers: torch.Tensor  # int32


def _pair_residuals(S, X1, X2, uv1, uv2, fx, fy, cx, cy):
    """[..., N, 4] residuals of both projection edges at S [..., 4, 4]."""
    Si = lie.sim3_inverse(S)
    p1 = X2 @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]
    p2 = X1 @ Si[..., :3, :3].transpose(-1, -2) + Si[..., None, :3, 3]

    def proj(p):
        z = torch.where(torch.abs(p[..., 2]) < 1e-9, torch.full_like(p[..., 2], 1e-9),
                        p[..., 2])
        return torch.stack([p[..., 0] / z * fx + cx, p[..., 1] / z * fy + cy], -1)

    return torch.cat([uv1 - proj(p1), uv2 - proj(p2)], dim=-1)


def optimize_sim3_pair_plain(S12, X1, X2, uv1, uv2, valid, sigma2_1, sigma2_2,
                             fx: float, fy: float, cx: float, cy: float,
                             chi2_th: float = 10.0, fix_scale: bool = False,
                             n_iters_first: int = 5) -> Sim3PairResult:
    dtype, dev = S12.dtype, S12.device
    s_init = torch.linalg.norm(S12[0, :3])
    cam = (fx, fy, cx, cy)

    def edge_residuals(xi, S):
        return _pair_residuals(lie.sim3_exp(xi) @ S, X1, X2, uv1, uv2, *cam)

    s1 = torch.clamp(sigma2_1, min=1e-12)
    s2 = torch.clamp(sigma2_2, min=1e-12)
    info = torch.stack([1.0 / s1, 1.0 / s1, 1.0 / s2, 1.0 / s2], dim=-1)
    delta = torch.sqrt(torch.tensor(chi2_th, dtype=dtype)).to(dev)
    z7 = torch.zeros(7, dtype=dtype, device=dev)
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def chi2_pair(r):
        return (r[:, 0] ** 2 + r[:, 1] ** 2) / s1, (r[:, 2] ** 2 + r[:, 3] ** 2) / s2

    def rho(c):
        return torch.where(c > chi2_th, 2.0 * delta * torch.sqrt(torch.clamp(c, min=1e-12))
                           - chi2_th, c)

    def lm_iters(S, mask, n):
        maskf = mask.to(dtype)

        def huber_cost(S_):
            c1, c2 = chi2_pair(_pair_residuals(S_, X1, X2, uv1, uv2, *cam))
            return torch.sum((rho(c1) + rho(c2)) * maskf)

        lam = torch.tensor(1e-3, dtype=dtype, device=dev)
        for _ in range(n):
            r = _pair_residuals(S, X1, X2, uv1, uv2, *cam)
            J = _jacobian_columns(lambda x: edge_residuals(x, S), z7)      # [N, 4, 7]
            c1, c2 = chi2_pair(r)
            one = torch.ones_like(c1)
            w1 = torch.where(c1 > chi2_th, delta / torch.sqrt(torch.clamp(c1, min=1e-12)), one)
            w2 = torch.where(c2 > chi2_th, delta / torch.sqrt(torch.clamp(c2, min=1e-12)), one)
            w = torch.stack([w1, w1, w2, w2], -1) * info * maskf[:, None]
            H = torch.einsum("nri,nr,nrj->ij", J, w, J)
            b = -torch.einsum("nri,nr,nr->i", J, w, r)
            s_cur = torch.linalg.norm(S[0, :3])
            w_s = torch.tensor(1e3, dtype=dtype, device=dev)
            H = H.clone()
            b = b.clone()
            H[6, 6] += w_s
            b[6] += -w_s * torch.log(torch.clamp(s_cur / s_init, min=1e-12))
            if fix_scale:
                H[6, 6] += 1e12
            damp = lam * (torch.diag(torch.diag(H)) + 1e-3 * eye7)
            dx = torch.linalg.solve(H + damp, b)
            S_new = lie.sim3_exp(dx) @ S
            accept = huber_cost(S_new) < huber_cost(S)
            S = torch.where(accept, S_new, S)
            lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 8.0), 1e-8, 1e8)
        return S

    def inliers(S, mask):
        c1, c2 = chi2_pair(_pair_residuals(S, X1, X2, uv1, uv2, *cam))
        return mask & (c1 <= chi2_th) & (c2 <= chi2_th)

    S_a = lm_iters(S12, valid, n_iters_first)
    S_b = lm_iters(S_a, inliers(S_a, valid), 10)
    inl = inliers(S_b, valid)
    return Sim3PairResult(S12=S_b, inliers=inl, n_inliers=inl.sum().to(torch.int32))


def optimize_sim3_pair(S12: torch.Tensor, X1: torch.Tensor, X2: torch.Tensor,
                       uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                       sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
                       fx: float, fy: float, cx: float, cy: float, chi2_th: float = 10.0,
                       fix_scale: bool = False, n_iters_first: int = 5) -> Sim3PairResult:
    """Inlier-gated Sim(3) refinement over N matched pairs. CPU tensors ->
    plain version; CUDA tensors -> kernel 17 (one launch), or raise."""
    if S12.device.type == "cpu":
        return optimize_sim3_pair_plain(S12, X1, X2, uv1, uv2, valid, sigma2_1, sigma2_2,
                                        fx, fy, cx, cy, chi2_th, fix_scale, n_iters_first)
    name = "optimize_sim3_pair"
    N = valid.shape[0]
    for t in (S12, X1, X2, uv1, uv2, sigma2_1, sigma2_2):
        kernels.check_dtype(name, t, torch.float32)
    kernels.check_dtype(name, valid, torch.bool)
    if (S12.shape != (4, 4) or X1.shape != (N, 3) or X2.shape != (N, 3)
            or uv1.shape != (N, 2) or uv2.shape != (N, 2) or sigma2_1.shape != (N,)
            or sigma2_2.shape != (N,)):
        raise ValueError(f"{name}: inconsistent shapes for {N} pairs")
    ins = [t.contiguous() for t in (S12, X1, X2, uv1, uv2, valid, sigma2_1, sigma2_2)]
    dev = kernels.check_cuda(name, *ins)
    S_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inl = torch.empty((N,), dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    delta = float(torch.sqrt(torch.tensor(chi2_th, dtype=torch.float32)))
    kernels.launch("sim3_pair", *[kernels.ptr(t) for t in ins], N, fx, fy, cx, cy,
                   float(chi2_th), delta, int(n_iters_first), 10, int(fix_scale),
                   kernels.ptr(S_out), kernels.ptr(inl), kernels.ptr(n_inl))
    return Sim3PairResult(S12=S_out, inliers=inl, n_inliers=n_inl)


__all__ = ["PoseGraphProblem", "optimize_pose_graph", "optimize_pose_graph_plain",
           "edge_jacobians", "normal_equations", "Sim3PairResult", "optimize_sim3_pair",
           "optimize_sim3_pair_plain"]
