"""Two-view monocular bootstrap: batched H/F RANSAC + R,t recovery.

Counterpart of structure_slam_pointline_tpu/ops/twoview.py (the point
half: `initialize_two_view` and `triangulate`; the line triangulation is
the next slice). All RANSAC iterations of both models evaluate at once:
batched DLT SVDs, one [ITERS, N] scoring pass per model, the reference's
RH = SH / (SH + SF) > 0.40 model choice, 4 E and 8 H (Faugeras)
candidates with cheirality counts. Null vectors from SVD may carry the
opposite sign to LAPACK's under JAX; the scores, R, t and the good mask
do not depend on it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.utils import linalg
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

CHI2_2D = 5.991
CHI2_1D = 3.841


def _normalize(uv: torch.Tensor, mask: torch.Tensor):
    wsum = torch.clamp(mask.sum(), min=1.0)
    mean = torch.sum(uv * mask[:, None], dim=0) / wsum
    dev = torch.sum(torch.abs(uv - mean) * mask[:, None], dim=0) / wsum
    s = 1.0 / torch.clamp(dev, min=1e-8)
    Tm = torch.zeros((3, 3), dtype=uv.dtype, device=uv.device)
    Tm[0, 0], Tm[0, 2] = s[0], -mean[0] * s[0]
    Tm[1, 1], Tm[1, 2] = s[1], -mean[1] * s[1]
    Tm[2, 2] = 1.0
    return (uv - mean) * s, Tm


def triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor) -> torch.Tensor:
    """Batched DLT: P1/P2 [..., 3, 4] and pixels [..., N, 2] -> [..., N, 3]
    by the 5-sweep Jacobi null vector of the 4x4 system."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    rows = torch.stack([
        uv1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)                                                # [..., N, 4, 4]
    X = linalg.null_vector_4(rows)
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


class TwoViewResult(NamedTuple):
    success: torch.Tensor
    used_homography: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    points3d: torch.Tensor
    good_mask: torch.Tensor
    parallax_deg: torch.Tensor


def _fit_F(uv1n, uv2n, sets):
    a1, a2 = uv1n[sets], uv2n[sets]
    u1, v1, u2, v2 = a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    f = vt[:, -1].reshape(-1, 3, 3)
    uF, sF, vFt = torch.linalg.svd(f)
    sF = torch.cat([sF[:, :2], torch.zeros_like(sF[:, 2:])], dim=1)
    return uF @ (sF[..., None] * vFt)


def _fit_H(uv1n, uv2n, sets):
    a1, a2 = uv1n[sets], uv2n[sets]
    u1, v1, u2, v2 = a1[..., 0], a1[..., 1], a2[..., 0], a2[..., 1]
    zero, one = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=1)
    vt = torch.linalg.svd(A, full_matrices=True)[2]
    return vt[:, -1].reshape(-1, 3, 3)


def _homog(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)


def _score_F(F, uv1, uv2, mask, sigma2):
    p1, p2 = _homog(uv1), _homog(uv2)
    l2 = torch.einsum("iab,nb->ina", F, p1)
    l1 = torch.einsum("iba,nb->ina", F, p2)
    d2 = torch.einsum("ina,na->in", l2, p2) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.einsum("ina,na->in", l1, p1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    chi1, chi2_ = d1 / sigma2, d2 / sigma2
    mf = mask[None].to(chi1.dtype)
    ok = (chi1 <= CHI2_1D) & (chi2_ <= CHI2_1D) & mask[None]
    score = torch.sum(torch.where(chi1 <= CHI2_1D, CHI2_2D - chi1, 0.0) * mf
                      + torch.where(chi2_ <= CHI2_1D, CHI2_2D - chi2_, 0.0) * mf, dim=1)
    return score, ok


def _score_H(H, uv1, uv2, mask, sigma2):
    Hinv = torch.linalg.inv(H)
    p1, p2 = _homog(uv1), _homog(uv2)

    def transfer(M, p, q):
        mp = torch.einsum("iab,nb->ina", M, p)
        w = torch.where(torch.abs(mp[..., 2]) < 1e-12,
                        torch.full_like(mp[..., 2], 1e-12), mp[..., 2])
        return torch.sum((mp[..., :2] / w[..., None] - q[None, :, :2]) ** 2, dim=-1)

    chi1 = transfer(Hinv, p2, p1) / sigma2
    chi2_ = transfer(H, p1, p2) / sigma2
    mf = mask[None].to(chi1.dtype)
    ok = (chi1 <= CHI2_2D) & (chi2_ <= CHI2_2D) & mask[None]
    score = torch.sum(torch.where(chi1 <= CHI2_2D, CHI2_2D - chi1, 0.0) * mf
                      + torch.where(chi2_ <= CHI2_2D, CHI2_2D - chi2_, 0.0) * mf, dim=1)
    return score, ok


def _check_rt(Rs, ts, uv1, uv2, mask, K, sigma2):
    """Cheirality + reprojection count for [C] candidates at once."""
    C = Rs.shape[0]
    dev, dt = Rs.device, Rs.dtype
    P1 = K @ torch.cat([torch.eye(3, dtype=dt, device=dev),
                        torch.zeros((3, 1), dtype=dt, device=dev)], dim=1)
    P2 = K @ torch.cat([Rs, ts[..., None]], dim=2)           # [C, 3, 4]
    X = triangulate(P1.expand(C, 3, 4), P2, uv1.expand(C, *uv1.shape),
                    uv2.expand(C, *uv2.shape))               # [C, N, 3]
    finite = torch.all(torch.isfinite(X), dim=-1)
    z1 = X[..., 2]
    X2 = X @ Rs.transpose(1, 2) + ts[:, None, :]
    z2 = X2[..., 2]
    o2 = -(Rs.transpose(1, 2) @ ts[..., None])[..., 0]      # [C, 3]
    r1, r2 = X, X - o2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)

    def reproj(P, uv):
        ph = X @ P[..., :3].transpose(-1, -2) + P[..., None, :, 3]
        w = torch.where(torch.abs(ph[..., 2]) < 1e-12,
                        torch.full_like(ph[..., 2], 1e-12), ph[..., 2])
        return torch.sum((ph[..., :2] / w[..., None] - uv) ** 2, dim=-1)

    e1 = reproj(P1.expand(C, 3, 4), uv1)
    e2 = reproj(P2, uv2)
    good = (mask[None] & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2))
    n_good = good.sum(-1)
    cosp_in = torch.where(good, cosp, torch.full_like(cosp, -2.0))
    sorted_desc = torch.flip(torch.sort(cosp_in, dim=-1).values, dims=[-1])
    idx = torch.clamp(n_good - 1, min=0).clamp(max=49)
    cos50 = torch.gather(sorted_desc, 1, idx[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(cos50, -1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, torch.zeros_like(parallax))
    return n_good, good, parallax, X


def _decompose_E(E):
    u, s, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _decompose_H(H, K):
    A = torch.linalg.inv(K) @ H @ K
    u, s, vt = torch.linalg.svd(A)
    V = vt.transpose(-1, -2)
    sgn = torch.linalg.det(u) * torch.linalg.det(V)
    d1, d2, d3 = s[0], s[1], s[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    z = torch.zeros((), dtype=H.dtype, device=H.device)
    one = torch.ones((), dtype=H.dtype, device=H.device)
    Rs, ts = [], []
    sin_t = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / torch.clamp((d1 + d3) * d2, min=1e-12)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        st = torch.where(x1s[i] * x3s[i] >= 0, sin_t, -sin_t)
        Rp = torch.stack([torch.stack([cos_t, z, -st]), torch.stack([z, one, z]),
                          torch.stack([st, z, cos_t])])
        tp = torch.stack([x1s[i], z, -x3s[i]]) * (d1 - d3)
        Rs.append(sgn * (u @ Rp @ vt))
        t = u @ tp
        ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-12))
    sin_p = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / torch.clamp((d1 - d3) * d2, min=1e-12)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sp = torch.where(x1s[i] * x3s[i] >= 0, sin_p, -sin_p)
        Rp = torch.stack([torch.stack([cos_p, z, sp]), torch.stack([z, -one, z]),
                          torch.stack([sp, z, -cos_p])])
        tp = torch.stack([x1s[i], z, x3s[i]]) * (d1 + d3)
        Rs.append(sgn * (u @ Rp @ vt))
        t = u @ tp
        ts.append(t / torch.clamp(torch.linalg.norm(t), min=1e-12))
    return torch.stack(Rs), torch.stack(ts)


def initialize_two_view(uv1, uv2, mask, sets, intr: Intrinsics, sigma: float = 1.0,
                        min_triangulated: int = 50, rh_threshold: float = 0.40,
                        min_parallax_deg: float = 0.5) -> TwoViewResult:
    """Full two-view bootstrap; degenerate cases return success=False."""
    sigma2 = sigma * sigma
    dev = uv1.device
    K = intr.K(dev)
    mf = mask.to(uv1.dtype)
    sets = sets.long()
    uv1n, T1 = _normalize(uv1, mf)
    uv2n, T2 = _normalize(uv2, mf)
    Fn = _fit_F(uv1n, uv2n, sets)
    F = torch.einsum("ab,ibc,cd->iad", T2.T, Fn, T1)
    scoreF, okF = _score_F(F, uv1, uv2, mask, sigma2)
    bestF = torch.argmax(scoreF)
    SF, F_best, inlF = scoreF[bestF], F[bestF], okF[bestF]
    Hn = _fit_H(uv1n, uv2n, sets)
    H = torch.einsum("ab,ibc,cd->iad", torch.linalg.inv(T2), Hn, T1)
    scoreH, okH = _score_H(H, uv1, uv2, mask, sigma2)
    bestH = torch.argmax(scoreH)
    SH, H_best, inlH = scoreH[bestH], H[bestH], okH[bestH]
    RH = SH / torch.clamp(SH + SF, min=1e-12)
    use_H = RH > rh_threshold
    RsF, tsF = _decompose_E(K.T @ F_best @ K)
    RsH, tsH = _decompose_H(H_best, K)
    Rs = torch.cat([RsF, RsH])
    ts = torch.cat([tsF, tsH])
    is_h = torch.arange(12, device=dev) >= 4
    inl = torch.where(use_H, inlH, inlF)
    n_good, good, par, X = _check_rt(Rs, ts, uv1, uv2, inl, K, sigma2)
    sel = torch.where(use_H, is_h, ~is_h)
    n_eff = torch.where(sel, n_good, -1)
    best = torch.argmax(n_eff)
    n_best = n_eff[best]
    second = torch.sort(n_eff, descending=True).values[1]
    n_inl = inl.sum()
    ok = ((n_best >= min_triangulated)
          & (n_best.float() >= 0.75 * n_inl.float())
          & (second.float() < 0.9 * n_best.float())
          & (par[best] > min_parallax_deg))
    return TwoViewResult(success=ok, used_homography=use_H, R=Rs[best], t=ts[best],
                         points3d=X[best], good_mask=good[best],
                         parallax_deg=par[best])


__all__ = ["TwoViewResult", "triangulate", "initialize_two_view", "CHI2_1D",
           "CHI2_2D"]
