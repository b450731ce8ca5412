"""Robust-cost utilities: Huber IRLS weights, Huber cost, MAD sigma.

Counterpart of structure_slam_pointline_tpu/utils/robust.py.
"""

from __future__ import annotations

import torch


def huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for Huber loss given squared error chi2 = ||r||^2."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.clamp(delta / r, max=1.0)


def huber_cost(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """rho(chi2): quadratic inside delta, linear outside."""
    r = torch.sqrt(torch.clamp(chi2, min=0.0))
    lin = 2.0 * delta * r - delta * delta
    return torch.where(r <= delta, chi2, lin)


def mad_sigma(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Robust sigma 1.4826 * median(|x - median(x)|) over masked values."""
    if mask is None:
        med = torch.quantile(x, 0.5)
        return 1.4826 * torch.quantile(torch.abs(x - med), 0.5)
    vals = x[mask]
    med = torch.quantile(vals, 0.5)
    return 1.4826 * torch.quantile(torch.abs(vals - med), 0.5)


__all__ = ["huber_weight", "huber_cost", "mad_sigma"]
