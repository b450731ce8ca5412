"""Fixed-sweep cyclic Jacobi for batched symmetric 4x4 matrices.

Counterpart of structure_slam_pointline_tpu/utils/linalg.py: the same
5-sweep Jacobi with the same rotation formulas, so the null vectors agree
with the reference (torch.linalg.eigh would pick other signs and, for
near-degenerate systems, other vectors). Entries live as separate [N]
vectors, exactly as in the reference.

`null_vector_4` is the wrapper of CUDA kernel 10 (csrc/null_vector4.cu,
one system per thread); `null_vector_4_plain` is its plain version and
sums the Gram entries row after row, as the kernel does.
`jacobi_eigh_4x4` is the wrapper of the same source's second entry
(`jacobi_eigh4`, counted apart; no path calls it, in either package),
`jacobi_eigh_4x4_plain` its plain version.

`dense_solve` is the wrapper of the dense solver that kernels 12 and 18
share (csrc/dense_lu.cuh, exported alone by local_ba.cu's library as
`dense_solve`, counted apart; no path calls it: the paths reach the
solver through their own launches). `lu_solve_blocked_plain` is its
plain version: the kernel's panel order, pivot rule and update order, so
its factorization equals an unblocked partial-pivot LU's bit for bit.
The plain BA and pose-graph versions keep torch.linalg.solve, as the
reference keeps jnp.linalg.solve.
"""

from __future__ import annotations

import torch

from structure_slam_pointline_tpu_torch import kernels

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


def jacobi_eigh_4x4_plain(M: torch.Tensor, sweeps: int = 5):
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


def jacobi_eigh_4x4(M: torch.Tensor, sweeps: int = 5):
    """(eigvals [..., 4], eigvecs [..., 4, 4] in columns, unsorted) of
    symmetric float32 [..., 4, 4] matrices. CPU tensor -> plain version;
    CUDA tensor -> kernel 10's eigensolver entry (or raise)."""
    if M.device.type == "cpu":
        return jacobi_eigh_4x4_plain(M, sweeps)
    if M.dim() < 2 or M.shape[-2:] != (4, 4):
        raise ValueError(f"jacobi_eigh_4x4: expects [..., 4, 4], got {tuple(M.shape)}")
    kernels.check_dtype("jacobi_eigh_4x4", M, torch.float32)
    M = M.contiguous()
    kernels.check_cuda("jacobi_eigh_4x4", M)
    batch = M.shape[:-2]
    n = M[..., 0, 0].numel()
    vals = torch.empty(batch + (4,), dtype=M.dtype, device=M.device)
    vecs = torch.empty(batch + (4, 4), dtype=M.dtype, device=M.device)
    kernels.launch("jacobi_eigh4", kernels.ptr(M), n, sweeps, kernels.ptr(vals),
                   kernels.ptr(vecs))
    return vals, vecs


def null_vector_4_plain(A: torch.Tensor, sweeps: int = 5) -> torch.Tensor:
    """Unit vector minimizing ||A v|| for [..., r, 4] stacked rows: the
    eigenvector of A^T A with the smallest eigenvalue."""
    a = [A[..., :, i] for i in range(4)]
    m = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            s = a[i][..., 0] * a[j][..., 0]
            for q in range(1, A.shape[-2]):
                s = s + a[i][..., q] * a[j][..., q]
            m[i][j] = m[j][i] = s
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


def null_vector_4(A: torch.Tensor, sweeps: int = 5) -> torch.Tensor:
    """[..., 4] null vectors of float32 [..., r, 4] systems. CPU tensor ->
    plain version; CUDA tensor -> kernel 10 (or raise)."""
    if A.device.type == "cpu":
        return null_vector_4_plain(A, sweeps)
    if A.dim() < 2 or A.shape[-1] != 4 or A.shape[-2] < 1:
        raise ValueError(f"null_vector_4: expects [..., r, 4], got {tuple(A.shape)}")
    kernels.check_dtype("null_vector_4", A, torch.float32)
    A = A.contiguous()
    kernels.check_cuda("null_vector_4", A)
    batch = A.shape[:-2]
    n = A[..., 0, 0].numel()
    out = torch.empty(batch + (4,), dtype=A.dtype, device=A.device)
    kernels.launch("null_vector4", kernels.ptr(A), n, A.shape[-2], sweeps,
                   kernels.ptr(out))
    return out


# csrc/dense_lu.cuh's launch shape: its cluster, warps per block, trailing
# tile width, row limit and dynamic shared memory budget, which pick the
# panel width
_DENSE_CLUSTER, _DENSE_WARPS, _DENSE_CT = 8, 8, 32
_DENSE_MAX_ROWS, _DENSE_MAX_SMEM = 2048, 200 * 1024


def dense_panel_width(cap: int) -> int:
    """The panel width NB that dense_lu.cuh takes for systems of up to
    `cap` rows (`panel_width`): 32 while the strip, its row maps and the
    tiles fit in shared memory, else 16."""
    tiles = -(-cap // _DENSE_CT)
    tpb = max(1, -(-tiles // (_DENSE_CLUSTER - 1)))   # trailing tiles a block owns
    for nb in (32, 16):
        if (1 <= cap < _DENSE_MAX_ROWS and tpb <= _DENSE_WARPS
                and (cap * (nb + 3) + 2 * tpb * nb * _DENSE_CT) * 4 <= _DENSE_MAX_SMEM):
            return nb
    raise ValueError(f"dense_solve: {cap} rows do not fit the solver")


def lu_solve_blocked_plain(Ab: torch.Tensor, n: int, nb: int):
    """(x [n], pivot rows [n] int32) of the augmented float32 system Ab
    ([n, n + 1], or flat), by the kernel's algorithm: panels of nb columns,
    each factored column by column (the largest |a|, the first row on
    ties, NaN never winning; one reciprocal of the pivot, one multiplier
    per row; the rank-1 update of the panel), the panel's row swaps on the
    columns right of it, U12 by forward substitution and A22 -= L21 U12,
    each product subtracted one term at a time in the panel's column
    order; then the back substitution blocked by 32 rows, the diagonal
    triangle from the bottom row up (each x the right side times the
    pivot's reciprocal, kept in place of the pivot) and the products of the
    rows above summed as the kernel's warp shuffle tree sums them."""
    A = Ab.reshape(n, n + 1).clone()
    piv = torch.empty(n, dtype=torch.int32)
    neg = torch.tensor(-1.0, dtype=A.dtype, device=A.device)
    for k0 in range(0, n, nb):
        c1 = min(k0 + nb, n)
        for j in range(k0, c1):
            col = A[j:, j].abs()
            p = j + int(torch.argmax(torch.where(torch.isnan(col), neg, col)))
            piv[j] = p
            if p != j:
                A[[j, p], k0:c1] = A[[p, j], k0:c1]
            rcp = 1.0 / A[j, j]
            f = A[j + 1:, j] * rcp
            A[j + 1:, j] = f
            A[j, j] = rcp
            A[j + 1:, j + 1:c1] = A[j + 1:, j + 1:c1] - f[:, None] * A[j, j + 1:c1][None, :]
        for j in range(k0, c1):
            p = int(piv[j])
            if p != j:
                A[[j, p], c1:] = A[[p, j], c1:]
        for l in range(k0, c1):
            A[l + 1:c1, c1:] = A[l + 1:c1, c1:] - A[l + 1:c1, l:l + 1] * A[l:l + 1, c1:]
        for l in range(k0, c1):
            A[c1:, c1:] = A[c1:, c1:] - A[c1:, l:l + 1] * A[l:l + 1, c1:]
    c = A[:, n].clone()
    x = torch.empty(n, dtype=A.dtype, device=A.device)
    for r0 in reversed(range(0, n, 32)):
        h = min(32, n - r0)
        v = c[r0:r0 + h].clone()
        for r in reversed(range(h)):
            v[r] = v[r] * A[r0 + r, r0 + r]
            v[:r] = v[:r] - A[r0:r0 + r, r0 + r] * v[r]
        x[r0:r0 + h] = v
        if r0:
            prod = torch.zeros((r0, 32), dtype=A.dtype, device=A.device)
            prod[:, :h] = A[:r0, r0:r0 + h] * v[None, :]
            for off in (16, 8, 4, 2, 1):
                prod = prod[:, :off] + prod[:, off:2 * off]
            c[:r0] = c[:r0] - prod[:, 0]
    return x, piv.to(A.device)


def dense_solve(Ab: torch.Tensor, cap: int | None = None):
    """(x [n], pivot rows [n] int32) of the float32 augmented system Ab
    [n, n + 1] (b as column n); `cap` >= n picks the panel width as a
    caller of that capacity gets it (default n). CPU tensor -> plain
    version; CUDA tensor -> the cluster solver (one launch), or raise."""
    if Ab.dim() != 2 or Ab.shape[1] != Ab.shape[0] + 1 or Ab.shape[0] < 1:
        raise ValueError(f"dense_solve: expects [n, n + 1], got {tuple(Ab.shape)}")
    n = Ab.shape[0]
    cap = n if cap is None else int(cap)
    if cap < n:
        raise ValueError(f"dense_solve: capacity {cap} below {n} rows")
    nb = dense_panel_width(cap)
    if Ab.device.type == "cpu":
        return lu_solve_blocked_plain(Ab, n, nb)
    kernels.check_dtype("dense_solve", Ab, torch.float32)
    A = Ab.contiguous().clone()
    kernels.check_cuda("dense_solve", A)
    x = torch.empty(n, dtype=torch.float32, device=A.device)
    piv = torch.empty(n, dtype=torch.int32, device=A.device)
    kernels.launch("dense_solve", kernels.ptr(A), n, cap, kernels.ptr(piv), kernels.ptr(x))
    return x, piv


__all__ = ["jacobi_eigh_4x4", "jacobi_eigh_4x4_plain", "null_vector_4",
           "null_vector_4_plain", "dense_panel_width", "dense_solve",
           "lu_solve_blocked_plain"]
