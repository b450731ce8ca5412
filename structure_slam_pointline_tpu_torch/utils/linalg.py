"""Fixed-sweep cyclic Jacobi for batched symmetric 4x4 matrices.

Counterpart of structure_slam_pointline_tpu/utils/linalg.py: the same
5-sweep Jacobi with the same rotation formulas, so the null vectors agree
with the reference (torch.linalg.eigh would pick other signs and, for
near-degenerate systems, other vectors). Entries live as separate [N]
vectors, exactly as in the reference.
"""

from __future__ import annotations

import torch

_PAIRS4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _sweep(m, V):
    for p, q in _PAIRS4:
        app, aqq, apq = m[p][p], m[q][q], m[p][q]
        theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
        c = torch.cos(theta)
        s = torch.sin(theta)
        cc, ss, sc = c * c, s * s, s * c
        for r in range(4):
            if r == p or r == q:
                continue
            mrp, mrq = m[r][p], m[r][q]
            m[r][p] = c * mrp + s * mrq
            m[r][q] = c * mrq - s * mrp
            m[p][r] = m[r][p]
            m[q][r] = m[r][q]
        m[p][p] = cc * app + 2.0 * sc * apq + ss * aqq
        m[q][q] = ss * app - 2.0 * sc * apq + cc * aqq
        m[p][q] = m[q][p] = (cc - ss) * apq + sc * (aqq - app)
        for r in range(4):
            vrp, vrq = V[r][p], V[r][q]
            V[r][p] = c * vrp + s * vrq
            V[r][q] = c * vrq - s * vrp
    return m, V


def _identity_lists(ref: torch.Tensor):
    one = torch.ones_like(ref)
    zero = torch.zeros_like(ref)
    return [[one if i == j else zero for j in range(4)] for i in range(4)]


def jacobi_eigh_4x4(M: torch.Tensor, sweeps: int = 5):
    """(eigvals [..., 4], eigvecs [..., 4, 4]) with eigenvectors in
    COLUMNS; eigenvalues unsorted."""
    m = [[M[..., i, j] for j in range(4)] for i in range(4)]
    V = _identity_lists(M[..., 0, 0])
    for _ in range(sweeps):
        m, V = _sweep(m, V)
    vals = torch.stack([m[i][i] for i in range(4)], dim=-1)
    vecs = torch.stack(
        [torch.stack([V[i][j] for j in range(4)], dim=-1) for i in range(4)],
        dim=-2)
    return vals, vecs


def null_vector_4(A: torch.Tensor, sweeps: int = 5) -> torch.Tensor:
    """Unit vector minimizing ||A v|| for [..., r, 4] stacked rows: the
    eigenvector of A^T A with the smallest eigenvalue."""
    a = [A[..., :, i] for i in range(4)]
    m = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            m[i][j] = m[j][i] = torch.sum(a[i] * a[j], dim=-1)
    V = _identity_lists(m[0][0])
    for _ in range(sweeps):
        m, V = _sweep(m, V)
    best_val = m[0][0]
    best = [V[r][0] for r in range(4)]
    for j in range(1, 4):
        take = m[j][j] < best_val
        best_val = torch.where(take, m[j][j], best_val)
        best = [torch.where(take, V[r][j], best[r]) for r in range(4)]
    return torch.stack(best, dim=-1)


__all__ = ["jacobi_eigh_4x4", "null_vector_4"]
