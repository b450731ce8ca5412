"""Pose-only Gauss-Newton with chi2-gated outlier rounds (kernel 4).

Counterpart of structure_slam_pointline_tpu/optim/pose_opt.py.

`pose_optimize` is the wrapper of CUDA kernel 4 (csrc/pose_lm.cu), which
replaces the reference's `pose_optimize` (pose_opt.py:114): the whole
rounds x iterations schedule runs in ONE launch of one block (the masked
rows staged in shared memory, the active rows compacted after each chi2
classification with the floor of 10 edges, an edge pass reduced to
(H | g) with one block-wide barrier, the unrolled damped 6x6 Cholesky of
`_chol_solve6` (:43), the 0.5 step clip and T <- se3_exp(dx) @ T in every
thread, and the final inlier count). The kernel reads the landmark arrays
through their row strides and the raw sigma2, so nothing else launches
around it.
`pose_optimize_plain` is the plain version, written with the same
per-edge planes, rounds and solve as the reference.

Point edges: r = obs - proj, chi2 = |r|^2 / sigma2, Huber delta
sqrt(5.991). Line edges (two rows per line, start then end point):
e = l . (u, v, 1), chi2 = e^2 / sigma2, Huber delta sqrt(7.815); a line is
an inlier only if both endpoints pass and lie in front of the camera.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import OptimConfig
from structure_slam_pointline_tpu_torch.utils import lie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.robust import huber_weight


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor           # [4, 4]
    point_inliers: torch.Tensor  # [N] bool
    line_inliers: torch.Tensor   # [M] bool
    n_inliers: torch.Tensor      # int32 scalar
    chi2: torch.Tensor           # robust cost of the last iteration


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 Cholesky solve (same elimination order as the reference)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _solve_damped(H, g, lam: float):
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    A = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye
    return _chol_solve6(A, g)


def _edge_planes(T, X, intr: Intrinsics):
    """Projection planes for flat world points X [3, R] (left perturbation)."""
    R3 = T[:3, :3]
    t = T[:3, 3]
    x = R3[0, 0] * X[0] + R3[0, 1] * X[1] + R3[0, 2] * X[2] + t[0]
    y = R3[1, 0] * X[0] + R3[1, 1] * X[1] + R3[1, 2] * X[2] + t[1]
    z = R3[2, 0] * X[0] + R3[2, 1] * X[1] + R3[2, 2] * X[2] + t[2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    a = intr.fx * iz
    c = -intr.fx * x * iz * iz
    b = intr.fy * iz
    d = -intr.fy * y * iz * iz
    zero = torch.zeros_like(x)
    Ju = torch.stack([c * y, a * z - c * x, -a * y, a, zero, c])
    Jv = torch.stack([-b * z + d * y, -d * x, b * x, zero, b, d])
    return u, v, z, Ju, Jv


def pose_optimize_plain(T_init, pts_w, obs_uv, pt_mask, pt_sigma2, line_sw,
                        line_ew, line_obs, ln_mask, ln_sigma2,
                        intr: Intrinsics, cfg: OptimConfig) -> PoseOptResult:
    dtype = T_init.dtype
    N = pts_w.shape[0]
    M = line_sw.shape[0]
    pt_info = 1.0 / torch.clamp(pt_sigma2, min=1e-12)
    ln_info = 1.0 / torch.clamp(ln_sigma2, min=1e-12)
    ln_info2 = torch.cat([ln_info, ln_info])
    X_all = torch.cat([pts_w, line_sw, line_ew]).T
    obs_u, obs_v = obs_uv[:, 0], obs_uv[:, 1]
    l0 = torch.cat([line_obs[:, 0]] * 2)
    l1 = torch.cat([line_obs[:, 1]] * 2)
    l2 = torch.cat([line_obs[:, 2]] * 2)
    sign = torch.cat([torch.ones(2 * N, dtype=dtype, device=T_init.device),
                      -torch.ones(2 * M, dtype=dtype, device=T_init.device)])

    def edge_pass(T):
        u, v, z, Ju, Jv = _edge_planes(T, X_all, intr)
        ru = obs_u - u[:N]
        rv = obs_v - v[:N]
        e = l0 * u[N:] + l1 * v[N:] + l2
        return dict(ru=ru, rv=rv, z=z[:N], Ju=Ju[:, :N], Jv=Jv[:, :N], e=e,
                    lz=z[N:], Jl=l0[None] * Ju[:, N:] + l1[None] * Jv[:, N:],
                    pt_chi2=(ru * ru + rv * rv) * pt_info,
                    ln_chi2_ep=(e * e) * ln_info2)

    def normal_eqs(ep, pt_inf, ln_inf):
        wp = huber_weight(ep["pt_chi2"], cfg.huber_delta_point) * pt_info * pt_inf
        ln_inf2 = torch.cat([ln_inf, ln_inf])
        wl = huber_weight(ep["ln_chi2_ep"], cfg.huber_delta_line) * ln_info2 * ln_inf2
        J = torch.cat([ep["Ju"], ep["Jv"], ep["Jl"]], dim=1)
        w = torch.cat([wp, wp, wl])
        r = torch.cat([ep["ru"], ep["rv"], ep["e"]])
        Hg = (J * w[None]) @ torch.cat([J, (r * sign)[None]], dim=0).T
        cost = (torch.sum(torch.clamp(ep["pt_chi2"], max=cfg.chi2_mono * 4) * pt_inf)
                + torch.sum(torch.clamp(ep["ln_chi2_ep"], max=cfg.chi2_line * 4)
                            * ln_inf2))
        return Hg[:, :6], Hg[:, 6], cost

    def classify(ep, first: bool):
        ln_ep_ok = ep["ln_chi2_ep"] <= cfg.chi2_line
        ln_z_ok = ep["lz"] > 0
        pt_in = pt_mask & (ep["z"] > 0)
        ln_in = ln_mask & ln_z_ok[:M] & ln_z_ok[M:]
        if not first:
            pt_in = pt_in & (ep["pt_chi2"] <= cfg.chi2_mono)
            ln_in = ln_in & ln_ep_ok[:M] & ln_ep_ok[M:]
        return pt_in, ln_in

    T = T_init
    cost = torch.zeros((), dtype=dtype, device=T.device)
    for rnd in range(cfg.pose_rounds):
        ep = edge_pass(T)
        pt_in, ln_in = classify(ep, rnd == 0)
        enough = (pt_in.sum() + ln_in.sum()) >= 10
        lz_ok = (ep["lz"][:M] > 0) & (ep["lz"][M:] > 0)
        pt_in = torch.where(enough, pt_in, pt_mask & (ep["z"] > 0))
        ln_in = torch.where(enough, ln_in, ln_mask & lz_ok)
        pt_inf, ln_inf = pt_in.to(dtype), ln_in.to(dtype)
        for _ in range(cfg.pose_iters):
            ep = edge_pass(T)
            H, g, cost = normal_eqs(ep, pt_inf, ln_inf)
            dx = _solve_damped(H, g, cfg.lm_lambda_init)
            nrm = torch.linalg.norm(dx)
            dx = dx * torch.clamp(0.5 / torch.clamp(nrm, min=1e-9), max=1.0)
            T = lie.se3_exp(dx) @ T
    ep = edge_pass(T)
    pt_in, ln_in = classify(ep, False)
    n_inl = pt_in.sum().to(torch.int32) + ln_in.sum().to(torch.int32)
    return PoseOptResult(T_cw=T, point_inliers=pt_in, line_inliers=ln_in,
                         n_inliers=n_inl, chi2=cost)


def pose_optimize(T_init, pts_w, obs_uv, pt_mask, pt_sigma2, line_sw, line_ew,
                  line_obs, ln_mask, ln_sigma2, intr: Intrinsics,
                  cfg: OptimConfig) -> PoseOptResult:
    """Pose LM over N point edges and M line edges (2 endpoint rows each).
    CPU tensors -> plain version; CUDA tensors -> kernel 4 (or raise)."""
    if T_init.device.type == "cpu":
        return pose_optimize_plain(T_init, pts_w, obs_uv, pt_mask, pt_sigma2,
                                   line_sw, line_ew, line_obs, ln_mask, ln_sigma2,
                                   intr, cfg)
    name = "pose_optimize"
    N, M = pts_w.shape[0], line_sw.shape[0]
    f32 = [T_init, pts_w, obs_uv, pt_sigma2, line_sw, line_ew, line_obs, ln_sigma2]
    for t in f32:
        kernels.check_dtype(name, t, torch.float32)
    for t in (pt_mask, ln_mask):
        kernels.check_dtype(name, t, torch.bool)
    if (T_init.shape != (4, 4) or pts_w.shape != (N, 3) or obs_uv.shape != (N, 2)
            or pt_mask.shape != (N,) or pt_sigma2.shape != (N,)
            or line_sw.shape != (M, 3) or line_ew.shape != (M, 3)
            or line_obs.shape != (M, 3) or ln_mask.shape != (M,) or ln_sigma2.shape != (M,)):
        raise ValueError(f"{name}: inconsistent edge shapes")
    if N + M > 8192:   # a thread of the kernel's block stages at most 32 rows
        raise ValueError(f"{name}: at most 8192 edges (N + M), got {N + M}")
    # the landmark arrays go in with their row strides (the tracking's line
    # endpoints are column slices of one [M, 6] array): no copy
    rows3 = [t if t.stride(1) == 1 else t.contiguous() for t in (pts_w, line_sw, line_ew)]
    ins = [T_init.contiguous(), obs_uv.contiguous(), pt_mask.contiguous(),
           pt_sigma2.contiguous(), line_obs.contiguous(), ln_mask.contiguous(),
           ln_sigma2.contiguous()]
    dev = kernels.check_cuda(name, *ins)
    if any(t.device != dev for t in rows3):
        raise ValueError(f"{name}: tensors on more than one device")
    T_out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    pt_in = torch.empty((N,), dtype=torch.bool, device=dev)
    ln_in = torch.empty((M,), dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    strided = [a for t in rows3 for a in (kernels.ptr(t), t.stride(0))]
    kernels.launch("pose_lm", kernels.ptr(ins[0]), *strided,
                   *[kernels.ptr(t) for t in ins[1:]], N, M,
                   intr.fx, intr.fy, intr.cx, intr.cy, cfg.pose_rounds,
                   cfg.pose_iters, cfg.chi2_mono, cfg.chi2_line,
                   cfg.huber_delta_point, cfg.huber_delta_line,
                   cfg.lm_lambda_init, kernels.ptr(T_out), kernels.ptr(pt_in),
                   kernels.ptr(ln_in), kernels.ptr(cost), kernels.ptr(n_inl))
    return PoseOptResult(T_cw=T_out, point_inliers=pt_in, line_inliers=ln_in,
                         n_inliers=n_inl, chi2=cost)


__all__ = ["PoseOptResult", "pose_optimize", "pose_optimize_plain"]
