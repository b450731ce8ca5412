"""Pinhole camera with radial-tangential distortion on torch tensors.

Counterpart of structure_slam_pointline_tpu/utils/camera.py. `Intrinsics`
holds Python floats (the reference keeps device scalars; here every op
broadcasts a float against the tensor it is given, so the same instance
serves CPU and CUDA tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from structure_slam_pointline_tpu_torch.config import CameraConfig


class Intrinsics(NamedTuple):
    """fy may be negative (ICL-NUIM convention)."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple  # (k1, k2, p1, p2, k3)

    def K(self, device=None, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device)

    @staticmethod
    def from_config(cam: CameraConfig) -> "Intrinsics":
        # float32 round trip: the reference stores these as f32 scalars
        f = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
        return Intrinsics(
            fx=f(cam.fx), fy=f(cam.fy), cx=f(cam.cx), cy=f(cam.cy),
            dist=tuple(f(v) for v in (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)),
        )


def distort(intr: Intrinsics, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = intr.dist
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(intr: Intrinsics, xd: torch.Tensor,
                         iters: int = 5) -> torch.Tensor:
    """Invert radtan by a fixed number of fixed-point iterations."""
    k1, k2, p1, p2, k3 = intr.dist
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def pixel_to_normalized(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    return torch.stack([x, y], dim=-1)


def normalized_to_pixel(intr: Intrinsics, xn: torch.Tensor) -> torch.Tensor:
    u = xn[..., 0] * intr.fx + intr.cx
    v = xn[..., 1] * intr.fy + intr.cy
    return torch.stack([u, v], dim=-1)


def undistort_pixels(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixel coords -> undistorted pixel coords."""
    return normalized_to_pixel(
        intr, undistort_normalized(intr, pixel_to_normalized(intr, uv)))


def project(intr: Intrinsics, p_cam: torch.Tensor, eps: float = 1e-6):
    """Camera-frame points [..., 3] -> (uv [..., 2], depth [...])."""
    z = p_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    xn = p_cam[..., 0:2] / z_safe[..., None]
    return normalized_to_pixel(intr, xn), z


def backproject(intr: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels + depth -> camera-frame 3D points [..., 3]."""
    xn = pixel_to_normalized(intr, uv)
    return torch.cat([xn * depth[..., None], depth[..., None]], dim=-1)


def in_image(cam: CameraConfig, uv: torch.Tensor,
             margin: float = 0.0) -> torch.Tensor:
    """Frustum bounds check against the (undistorted) image rectangle."""
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )


__all__ = [
    "Intrinsics", "distort", "undistort_normalized", "pixel_to_normalized",
    "normalized_to_pixel", "undistort_pixels", "project", "backproject", "in_image",
]
