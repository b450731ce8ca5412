"""SO(3) / SE(3) operations on batched torch tensors.

Counterpart of structure_slam_pointline_tpu/utils/lie.py. Poses are 4x4
(or [..., 4, 4]) homogeneous matrices T_cw; tangent vectors are
xi = (omega[0:3], upsilon[3:6]), rotation first, and updates are LEFT
multiplicative, T' = exp(xi) @ T. Sim(3) elements are [..., 4, 4] with
sR in the rotation block and tangents (omega, upsilon, sigma). Small-angle
branches use the same Taylor expansions, thresholds and "safe"
denominators as the reference, so forward-mode derivatives through them
(optim/pose_graph.py) stay finite on every branch.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL_THETA2 = 1e-4  # float32: Taylor below theta ~ 0.01 beats cancellation


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_factors(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), stably."""
    small = theta2 < _SMALL_THETA2
    t2 = torch.clamp(theta2, min=_SMALL_THETA2)
    theta = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return A, B, C


def _eye3(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(ref.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_factors(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map [..., 3, 3] -> [..., 3], stable near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    w_raw = vee(R - R.transpose(-1, -2)) * 0.5
    small = cos_t > 1.0 - 1e-4
    cos_gen = torch.clamp(cos_t, -1.0 + 1e-6, 1.0 - 1e-6)
    theta_gen = torch.arccos(cos_gen)
    scale_generic = theta_gen / torch.sin(theta_gen)
    one_m_c = 1.0 - cos_t
    scale_small = 1.0 + one_m_c / 3.0 + 7.0 * one_m_c * one_m_c / 45.0
    near_pi = cos_t < -1.0 + 1e-5
    w_generic = torch.where(small[..., None], w_raw * scale_small[..., None],
                            w_raw * scale_generic[..., None])
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, min=1e-12)
    axis = torch.sqrt(axis2)
    k = torch.argmax(axis2, dim=-1)
    Rsym = (R + R.transpose(-1, -2)) * 0.5
    row = torch.take_along_dim(
        Rsym, k[..., None, None].expand(*k.shape, 1, 3), dim=-2)[..., 0, :]
    ax_k = torch.take_along_dim(axis, k[..., None], dim=-1)[..., 0]
    signed = row / torch.where(ax_k[..., None] < _EPS,
                               torch.ones_like(ax_k[..., None]), ax_k[..., None])
    axis_pi = torch.sign(torch.where(torch.abs(signed) < _EPS,
                                     torch.ones_like(signed), signed)) * axis
    nrm = torch.linalg.norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.where(nrm < _EPS, torch.ones_like(nrm), nrm)
    w_pi = axis_pi * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map [..., 6] (omega, upsilon) -> [..., 4, 4]."""
    w = xi[..., 0:3]
    v = xi[..., 3:6]
    theta2 = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_factors(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map [..., 4, 4] -> [..., 6] (omega, upsilon)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_factors(theta2)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta2)(1 - A/(2B)) W^2
    coef = torch.where(theta2 < _SMALL_THETA2, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=_SMALL_THETA2))
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: T [..., 4, 4] x p [..., 3] -> [..., 3]."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_normalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via SVD (drift control)."""
    R = T[..., :3, :3]
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.ones(T.shape[:-2] + (3,), dtype=T.dtype, device=T.device)
    d[..., 2] = det
    Rn = (u * d[..., None, :]) @ vt
    return rt_to_mat(Rn, T[..., :3, 3])


# ---------------------------------------------------------------------------
# Sim(3) (the reference's lie.py:189-297), used by loop closing
# ---------------------------------------------------------------------------

def sim3_make(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_scale(S: torch.Tensor) -> torch.Tensor:
    """Scale from the sR block (its rows have norm s)."""
    return torch.linalg.norm(S[..., 0, :3], dim=-1)


def sim3_rotation(S: torch.Tensor) -> torch.Tensor:
    return S[..., :3, :3] / sim3_scale(S)[..., None, None]


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    s = sim3_scale(S)
    R = sim3_rotation(S)
    t = S[..., :3, 3]
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return sim3_make(sinv, Rt, -(sinv[..., None] * (Rt @ t[..., None])[..., 0]))


def sim3_apply(S: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", S[..., :3, :3], p) + S[..., :3, 3]


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W of the Sim(3) exponential, t = W @ upsilon (the reference's
    `_sim3_W`: Sophus' calcW with Taylor limits for small sigma / theta)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    sigma2 = sigma * sigma
    s = torch.exp(sigma)
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < _EPS
    one = torch.ones_like(sigma)
    zero = torch.zeros_like(sigma)

    sig_safe = torch.where(small_sig, one, sigma)
    th_safe = torch.where(small_th, one, theta)
    th2_safe = torch.where(small_th, one, theta2)

    C = torch.where(small_sig, 1.0 + sigma * 0.5 + sigma2 / 6.0, (s - 1.0) / sig_safe)

    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sigma2
    c_safe = torch.where(c < _EPS, one, c)

    A_gen = (a * sigma + (1.0 - b) * theta) / (th_safe * c_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / th2_safe
    A_sig = torch.where(small_sig, zero,
                        ((sigma - 1.0) * s + 1.0) / torch.where(small_sig, one, sigma2))
    B_sig = torch.where(small_sig, zero,
                        ((0.5 * sigma2 - sigma + 1.0) * s - 1.0)
                        / torch.where(small_sig, one, sigma2 * sig_safe))
    _, A0, B0 = _sinc_factors(theta2)

    A = torch.where(small_sig, A0, torch.where(small_th, A_sig, A_gen))
    B = torch.where(small_sig, B0, torch.where(small_th, B_sig, B_gen))

    W = hat(w)
    W2 = W @ W
    return C[..., None, None] * _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exp map [..., 7] (omega, upsilon, sigma) -> Sim(3) [..., 4, 4]."""
    w = xi[..., 0:3]
    v = xi[..., 3:6]
    sigma = xi[..., 6]
    R = so3_exp(w)
    Wm = _sim3_W(w, sigma)
    t = (Wm @ v[..., None])[..., 0]
    return sim3_make(torch.exp(sigma), R, t)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Log map [..., 4, 4] -> [..., 7]; upsilon solves W(omega, sigma) v = t."""
    s = sim3_scale(S)
    R = sim3_rotation(S)
    t = S[..., :3, 3]
    w = so3_log(R)
    sigma = torch.log(s)
    Wm = _sim3_W(w, sigma)
    v = torch.linalg.solve(Wm, t[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


__all__ = [
    "hat", "vee", "so3_exp", "so3_log", "se3_exp", "se3_log", "rt_to_mat", "se3_inverse",
    "se3_apply", "se3_compose", "se3_normalize", "sim3_make", "sim3_scale", "sim3_rotation",
    "sim3_inverse", "sim3_apply", "sim3_exp", "sim3_log",
]
