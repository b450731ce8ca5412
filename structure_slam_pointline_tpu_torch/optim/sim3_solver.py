"""Batched Sim(3) RANSAC: Horn's closed-form alignment of three-point
sets and the mutual-projection inlier test (kernel 16).

Counterpart of structure_slam_pointline_tpu/optim/sim3_solver.py (the
reference's Sim3Solver::ComputeSim3 and CheckInliers): every hypothesis
aligns its three sampled pairs by Horn's quaternion method (centroids,
the 3x3 cross-covariance, the top eigenvector of Horn's 4x4 N), and is
scored by projecting each side's points through the candidate Sim(3)
into the other camera; the first hypothesis with the most inliers wins.

`ransac_sim3` is the wrapper of CUDA kernel 16 (csrc/sim3_ransac.cu,
three launches per call). `ransac_sim3_plain` is its plain version: the
reference's arithmetic in float32 torch ops, the eigenvector from
torch.linalg.eigh as the reference takes it from jnp.linalg.eigh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

CHI2_1 = 9.210
CHI2_2 = 9.210


class Sim3Result(NamedTuple):
    success: torch.Tensor    # bool
    S12: torch.Tensor        # [4, 4] Sim(3) mapping frame-2 coords into frame 1
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # int32
    counts: torch.Tensor     # [I] int32 inliers of every hypothesis
    scale: torch.Tensor      # [I] every hypothesis' s
    hyp: torch.Tensor        # [I, 3, 4] every hypothesis' [R | t]


def horn_matrix(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 N [..., 4, 4] of centred point sets q1, q2
    [..., M, 3]; its top eigenvector is the rotation's quaternion."""
    M = torch.einsum("...mi,...mj->...ij", q2, q1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    return N


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form Sim(3) with p1 ~ s R p2 + t, batched over leading axes
    (p1, p2 [..., M, 3]); returns (s, R, t)."""
    c1 = torch.mean(p1, dim=-2, keepdim=True)
    c2 = torch.mean(p2, dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    _, vecs = torch.linalg.eigh(horn_matrix(q1, q2))
    q = vecs[..., :, -1]   # eigenvector of the largest eigenvalue, (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        s = torch.sqrt(torch.sum(q1 * q1, dim=(-2, -1))
                       / torch.clamp(torch.sum(q2 * q2, dim=(-2, -1)), min=1e-12))
    t = c1[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, c2[..., 0, :])
    return s, R, t


def _rows(A, b, X):
    """A X + b for A [I, 3, 3], b [I, 3], X [N, 3] or [I, N, 3] -> three
    [I, N] planes, each sum taken left to right as kernel 16 takes it."""
    X = X[None] if X.dim() == 2 else X
    return [A[:, a, 0, None] * X[..., 0] + A[:, a, 1, None] * X[..., 1]
            + A[:, a, 2, None] * X[..., 2] + b[:, a, None] for a in range(3)]


def _proj(p, intr: Intrinsics):
    x, y, z = p
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return x / zs * intr.fx + intr.cx, y / zs * intr.fy + intr.cy


def inlier_masks_plain(scale, R, t, p1_cam, p2_cam, mask, intr: Intrinsics,
                       sigma2_1: float = 1.0, sigma2_2: float = 1.0) -> torch.Tensor:
    """[I, N] inlier masks of every hypothesis (sim3_solver.py:94-109):
    p2 through S12 into camera 1 and p1 through S12^-1 into camera 2."""
    zero = torch.zeros_like(t)
    u1, v1 = _proj(p1_cam.unbind(-1), intr)
    u2, v2 = _proj(p2_cam.unbind(-1), intr)
    sR = scale[:, None, None] * R
    a_u, a_v = _proj(_rows(sR, t, p2_cam), intr)
    e1 = (a_u - u1) * (a_u - u1) + (a_v - v1) * (a_v - v1)
    s_inv = 1.0 / torch.clamp(scale, min=1e-12)
    Rt = s_inv[:, None, None] * R.transpose(-1, -2)
    b_u, b_v = _proj(_rows(Rt, zero, p1_cam[None] - t[:, None, :]), intr)
    e2 = (b_u - u2) * (b_u - u2) + (b_v - v2) * (b_v - v2)
    th1 = torch.tensor(CHI2_1 * sigma2_1, dtype=torch.float32)
    th2 = torch.tensor(CHI2_2 * sigma2_2, dtype=torch.float32)
    return (e1 < th1.to(e1.device)) & (e2 < th2.to(e2.device)) & mask[None]


def _result(scale, R, t, ok, min_inliers: int) -> Sim3Result:
    counts = ok.sum(-1).to(torch.int32)
    best = torch.argmax(counts)   # the first index of the largest count
    n_best = counts[best]
    S12 = torch.eye(4, dtype=torch.float32, device=R.device)
    S12[:3, :3] = scale[best] * R[best]
    S12[:3, 3] = t[best]
    return Sim3Result(success=n_best >= min_inliers, S12=S12, inliers=ok[best],
                      n_inliers=n_best, counts=counts, scale=scale,
                      hyp=torch.cat([R, t[..., None]], -1))


def ransac_sim3_plain(p1_cam, p2_cam, mask, sets, intr: Intrinsics, sigma2_1: float = 1.0,
                      sigma2_2: float = 1.0, fix_scale: bool = False,
                      min_inliers: int = 20) -> Sim3Result:
    s_ = sets.long()
    scale, R, t = horn_sim3(p1_cam[s_], p2_cam[s_], fix_scale=fix_scale)
    ok = inlier_masks_plain(scale, R, t, p1_cam, p2_cam, mask, intr, sigma2_1, sigma2_2)
    return _result(scale, R, t, ok, min_inliers)


def ransac_sim3(p1_cam: torch.Tensor, p2_cam: torch.Tensor, mask: torch.Tensor,
                sets: torch.Tensor, intr: Intrinsics, sigma2_1: float = 1.0,
                sigma2_2: float = 1.0, fix_scale: bool = False,
                min_inliers: int = 20) -> Sim3Result:
    """RANSAC over I three-point sets (sets [I, 3]) of N matched pairs
    (p1_cam, p2_cam [N, 3], mask [N]). CPU tensors -> plain version; CUDA
    tensors -> kernel 16 (or raise)."""
    if p1_cam.device.type == "cpu":
        return ransac_sim3_plain(p1_cam, p2_cam, mask, sets, intr, sigma2_1, sigma2_2,
                                 fix_scale, min_inliers)
    name = "ransac_sim3"
    for t in (p1_cam, p2_cam):
        kernels.check_dtype(name, t, torch.float32)
    kernels.check_dtype(name, mask, torch.bool)
    N, I = mask.shape[0], sets.shape[0]
    if p1_cam.shape != (N, 3) or p2_cam.shape != (N, 3) or sets.shape != (I, 3) or I == 0:
        raise ValueError(f"{name}: shapes {tuple(p1_cam.shape)}, {tuple(p2_cam.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(sets.shape)}")
    ins = [p1_cam.contiguous(), p2_cam.contiguous(), mask.contiguous(),
           sets.to(torch.int32).contiguous()]
    dev = kernels.check_cuda(name, *ins)
    scale = torch.empty((I,), dtype=torch.float32, device=dev)
    hyp = torch.empty((I, 3, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((I,), dtype=torch.int32, device=dev)
    S12 = torch.empty((4, 4), dtype=torch.float32, device=dev)
    inl = torch.empty((N,), dtype=torch.bool, device=dev)
    n_best = torch.empty((), dtype=torch.int32, device=dev)
    th1 = float(torch.tensor(CHI2_1 * sigma2_1, dtype=torch.float32))
    th2 = float(torch.tensor(CHI2_2 * sigma2_2, dtype=torch.float32))
    cam = (intr.fx, intr.fy, intr.cx, intr.cy)
    p = kernels.ptr
    kernels.launch(name, p(ins[0]), p(ins[1]), p(ins[3]), I, int(fix_scale), p(scale), p(hyp),
                   entry="sim3_hypotheses")
    kernels.launch(name, p(ins[0]), p(ins[1]), p(ins[2]), p(scale), p(hyp), I, N, *cam, th1,
                   th2, p(counts), entry="sim3_count")
    kernels.launch(name, p(ins[0]), p(ins[1]), p(ins[2]), p(scale), p(hyp), p(counts), I, N,
                   *cam, th1, th2, p(S12), p(inl), p(n_best), entry="sim3_select")
    return Sim3Result(success=n_best >= min_inliers, S12=S12, inliers=inl, n_inliers=n_best,
                      counts=counts, scale=scale, hyp=hyp)


__all__ = ["CHI2_1", "CHI2_2", "Sim3Result", "horn_matrix", "horn_sim3", "ransac_sim3", "ransac_sim3_plain",
           "inlier_masks_plain"]
