"""Reprojection residuals + analytic Jacobians for points and lines.

Counterpart of structure_slam_pointline_tpu/optim/residuals.py. Pose
perturbation is LEFT multiplicative: T' = exp(xi) @ T, xi = (omega,
upsilon). Line edges use e = l . (u, v, 1) per projected endpoint.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics


def transform_points(T_cw: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    return pts_w @ T_cw[:3, :3].T + T_cw[:3, 3]


def project_jacobian(intr: Intrinsics, p_cam: torch.Tensor, eps: float = 1e-6):
    """(uv [N, 2], J_uv_pcam [N, 2, 3]) for camera-frame points [N, 3]."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    z = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    iz = 1.0 / z
    iz2 = iz * iz
    u = intr.fx * x * iz + intr.cx
    v = intr.fy * y * iz + intr.cy
    zero = torch.zeros_like(x)
    J = torch.stack([
        torch.stack([intr.fx * iz, zero, -intr.fx * x * iz2], dim=-1),
        torch.stack([zero, intr.fy * iz, -intr.fy * y * iz2], dim=-1),
    ], dim=-2)
    return torch.stack([u, v], dim=-1), J


def pcam_pose_jacobian(p_cam: torch.Tensor) -> torch.Tensor:
    """d p_cam / d xi for left perturbation: [N, 3, 6] = [-[p]_x | I]."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zero = torch.zeros_like(x)
    neg_skew = torch.stack([
        torch.stack([zero, z, -y], dim=-1),
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([y, -x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=p_cam.dtype, device=p_cam.device).expand(neg_skew.shape)
    return torch.cat([neg_skew, eye], dim=-1)


class PointResiduals(NamedTuple):
    r: torch.Tensor        # [N, 2] residual (obs - proj)
    J_pose: torch.Tensor   # [N, 2, 6]
    J_point: torch.Tensor  # [N, 2, 3]
    depth: torch.Tensor    # [N]


def point_residuals(T_cw, pts_w, obs_uv, intr: Intrinsics) -> PointResiduals:
    p_cam = transform_points(T_cw, pts_w)
    uv, J_proj = project_jacobian(intr, p_cam)
    J_pose = -torch.einsum("nij,njk->nik", J_proj, pcam_pose_jacobian(p_cam))
    J_point = -torch.einsum("nij,jk->nik", J_proj, T_cw[:3, :3])
    return PointResiduals(r=obs_uv - uv, J_pose=J_pose, J_point=J_point,
                          depth=p_cam[..., 2])


class LineResiduals(NamedTuple):
    r: torch.Tensor        # [M, 2] (start, end) line distances
    J_pose: torch.Tensor   # [M, 2, 6]
    J_start: torch.Tensor  # [M, 1, 3]
    J_end: torch.Tensor    # [M, 1, 3]
    depth: torch.Tensor    # [M, 2]


def line_residuals(T_cw, start_w, end_w, line2d, intr: Intrinsics) -> LineResiduals:
    def endpoint(pts_w):
        p_cam = transform_points(T_cw, pts_w)
        uv, J_proj = project_jacobian(intr, p_cam)
        e = line2d[:, 0] * uv[:, 0] + line2d[:, 1] * uv[:, 1] + line2d[:, 2]
        l01 = line2d[:, :2]
        J_uv_pose = torch.einsum("nij,njk->nik", J_proj, pcam_pose_jacobian(p_cam))
        J_pose = torch.einsum("ni,nik->nk", l01, J_uv_pose)
        J_pt = torch.einsum("ni,nij,jk->nk", l01, J_proj, T_cw[:3, :3])
        return e, J_pose, J_pt, p_cam[..., 2]

    e_s, Jp_s, Jx_s, z_s = endpoint(start_w)
    e_e, Jp_e, Jx_e, z_e = endpoint(end_w)
    return LineResiduals(
        r=torch.stack([e_s, e_e], dim=-1),
        J_pose=torch.stack([Jp_s, Jp_e], dim=-2),
        J_start=Jx_s[:, None, :], J_end=Jx_e[:, None, :],
        depth=torch.stack([z_s, z_e], dim=-1))


__all__ = ["transform_points", "project_jacobian", "pcam_pose_jacobian",
           "PointResiduals", "point_residuals", "LineResiduals",
           "line_residuals"]
