"""Batched RANSAC PnP for relocalization (kernel 15).

Counterpart of structure_slam_pointline_tpu/ops/pnp.py. Every hypothesis
solves a 6-point DLT (the null vector of a 12x12 system), recovers R by
orthonormal projection of the 3x3 block, t by the mean singular value,
fixes the sign by cheirality over its six points, and is scored by
reprojection over all N points; the first hypothesis with the most
inliers wins.

`ransac_pnp` is the wrapper of CUDA kernel 15 (csrc/pnp.cu), which
replaces the reference's `ransac_pnp` (pnp.py:34) vmapped over the
relocalization candidates (models/relocalization.py:62): one call takes
every candidate ([C, N, 3] points, [C, N] masks, [C, I, 6] sample sets)
in two launches (a warp per hypothesis solves and scores it; a block per
candidate selects). `ransac_pnp_plain` is its plain version, the
reference's arithmetic in float32 torch ops.

One deliberate departure from the reference: the sign of the DLT null
vector. `jnp.linalg.svd` may return it with either sign, and with the
negative one det(P[:, :3]) < 0, the det fix yields a wrong rotation and
the cheirality flip then a reflection. The result would depend on the
SVD routine's sign rule. Both versions here flip the null vector so that
det(P[:, :3]) > 0 before recovering R, so they agree with the reference
on every hypothesis the reference itself solved with that sign.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

CHI2_2D = 5.991


class PnPResult(NamedTuple):
    success: torch.Tensor    # [C] bool
    T_cw: torch.Tensor       # [C, 4, 4]
    inliers: torch.Tensor    # [C, N] bool
    n_inliers: torch.Tensor  # [C] int32
    counts: torch.Tensor     # [C, I] int32 inliers of every hypothesis
    hyp: torch.Tensor        # [C, I, 3, 4] every hypothesis' [R | t]


def _normalized(uv: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    c = lambda v: torch.tensor(v, dtype=torch.float32, device=uv.device)  # noqa: E731
    return torch.stack([(uv[:, 0] - c(intr.cx)) / c(intr.fx),
                        (uv[:, 1] - c(intr.cy)) / c(intr.fy)], 1)


def dlt_systems(pts_w: torch.Tensor, uv: torch.Tensor, sets: torch.Tensor,
                intr: Intrinsics):
    """The 12x12 DLT matrices [C, I, 12, 12] of pnp.py:49-57 and the
    sample points [C, I, 6, 3]."""
    xn = _normalized(uv, intr)
    s = sets.long()
    X = torch.gather(pts_w[:, None].expand(-1, s.shape[1], -1, -1), 2,
                     s[..., None].expand(-1, -1, -1, 3))          # [C, I, 6, 3]
    x = xn[s]                                                     # [C, I, 6, 2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([zero, -Xh, x[..., 1:2] * Xh], -1)
    r2 = torch.cat([Xh, zero, -x[..., 0:1] * Xh], -1)
    return torch.cat([r1, r2], -2), X


def hypotheses_plain(pts_w, uv, sets, intr: Intrinsics) -> torch.Tensor:
    """[C, I, 3, 4] hypotheses [R | t] from the DLT null vectors (the
    reference's pnp.py:58-73 after the sign normalization)."""
    A, X = dlt_systems(pts_w, uv, sets, intr)
    _, _, vt = torch.linalg.svd(A)
    P = vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)
    P = torch.where((torch.linalg.det(P[..., :3]) < 0)[..., None, None], -P, P)
    u_, s_, v_ = torch.linalg.svd(P[..., :3])
    d = torch.ones_like(u_[..., 0, :])
    d[..., 2] = torch.linalg.det(u_ @ v_)
    R = (u_ * d[..., None, :]) @ v_
    scale = torch.sum(s_, dim=-1) / 3.0
    t = P[..., 3] / torch.clamp(scale, min=1e-12)[..., None]
    z = torch.einsum("cikj,cinj->cink", R[..., 2:3, :], X)[..., 0] + t[..., 2:3]
    flip = (torch.sum(torch.sign(z), dim=-1) < 0)[..., None]
    R = torch.where(flip[..., None], -R, R)
    t = torch.where(flip, -t, t)
    return torch.cat([R, t[..., None]], -1)


def inlier_masks_plain(hyp, pts_w, uv, mask, intr: Intrinsics, sigma2: float = 4.0):
    """[C, I, N] inlier masks of every hypothesis (pnp.py:76-83), each
    coordinate summed left to right as kernel 15 does."""
    R, t = hyp[..., :3], hyp[..., 3]
    X = pts_w[:, None]                                            # [C, 1, N, 3]

    def row(a):
        r = R[..., a, :][..., None, :]                            # [C, I, 1, 3]
        return (r[..., 0] * X[..., 0] + r[..., 1] * X[..., 1] + r[..., 2] * X[..., 2]
                + t[..., a:a + 1])

    pc0, pc1, zc = row(0), row(1), row(2)
    zsafe = torch.where(torch.abs(zc) < 1e-9, torch.full_like(zc, 1e-9), zc)
    up = pc0 / zsafe * intr.fx + intr.cx
    vp = pc1 / zsafe * intr.fy + intr.cy
    du = up - uv[:, 0]
    dv = vp - uv[:, 1]
    err = du * du + dv * dv
    return (err <= CHI2_2D * sigma2) & (zc > 0) & mask[:, None, :]


def ransac_pnp_plain(pts_w, uv, mask, sets, intr: Intrinsics, sigma2: float = 4.0,
                     min_inliers: int = 12) -> PnPResult:
    hyp = hypotheses_plain(pts_w, uv, sets, intr)
    ok = inlier_masks_plain(hyp, pts_w, uv, mask, intr, sigma2)
    counts = ok.sum(-1).to(torch.int32)
    best = torch.argmax(counts, dim=-1)
    C = sets.shape[0]
    ar = torch.arange(C, device=sets.device)
    n_best = counts[ar, best]
    T = torch.eye(4, dtype=torch.float32, device=hyp.device).repeat(C, 1, 1)
    T[:, :3, :] = hyp[ar, best]
    return PnPResult(success=n_best >= min_inliers, T_cw=T, inliers=ok[ar, best],
                     n_inliers=n_best, counts=counts, hyp=hyp)


def ransac_pnp(pts_w: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor,
               sets: torch.Tensor, intr: Intrinsics, sigma2: float = 4.0,
               min_inliers: int = 12) -> PnPResult:
    """RANSAC PnP of C candidates at once (pts_w [C, N, 3], mask [C, N],
    sets [C, I, 6]), the undistorted pixels uv [N, 2] shared. CPU tensors
    -> plain version; CUDA tensors -> kernel 15 (or raise)."""
    if pts_w.device.type == "cpu":
        return ransac_pnp_plain(pts_w, uv, mask, sets, intr, sigma2, min_inliers)
    name = "ransac_pnp"
    for t in (pts_w, uv):
        kernels.check_dtype(name, t, torch.float32)
    kernels.check_dtype(name, mask, torch.bool)
    C, N, I = mask.shape[0], mask.shape[-1], sets.shape[-2]
    if (mask.shape != (C, N) or pts_w.shape != (C, N, 3) or uv.shape != (N, 2)
            or sets.shape != (C, I, 6) or I == 0):
        raise ValueError(f"{name}: shapes {tuple(pts_w.shape)}, {tuple(uv.shape)}, "
                         f"{tuple(mask.shape)}, {tuple(sets.shape)}")
    ins = [pts_w.contiguous(), uv.contiguous(), mask.contiguous(),
           sets.to(torch.int32).contiguous()]
    dev = kernels.check_cuda(name, *ins)
    hyp = torch.empty((C, I, 3, 4), dtype=torch.float32, device=dev)
    counts = torch.empty((C, I), dtype=torch.int32, device=dev)
    T = torch.empty((C, 4, 4), dtype=torch.float32, device=dev)
    inl = torch.empty((C, N), dtype=torch.bool, device=dev)
    n_best = torch.empty((C,), dtype=torch.int32, device=dev)
    thresh = float(torch.tensor(CHI2_2D * sigma2, dtype=torch.float32))
    cam = (intr.fx, intr.fy, intr.cx, intr.cy)
    p = kernels.ptr
    kernels.launch(name, p(ins[0]), p(ins[1]), p(ins[3]), p(ins[2]), C, I, N, *cam, thresh,
                   p(hyp), p(counts), entry="pnp_hypotheses")
    kernels.launch(name, p(hyp), p(counts), p(ins[0]), p(ins[1]), p(ins[2]), C, I, N, *cam,
                   thresh, p(T), p(inl), p(n_best), entry="pnp_select")
    return PnPResult(success=n_best >= min_inliers, T_cw=T, inliers=inl, n_inliers=n_best,
                     counts=counts, hyp=hyp)


__all__ = ["CHI2_2D", "PnPResult", "ransac_pnp", "ransac_pnp_plain", "hypotheses_plain",
           "inlier_masks_plain", "dlt_systems"]
