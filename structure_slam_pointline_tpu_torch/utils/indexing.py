"""Index helpers with the reference's JAX semantics.

- `.at[idx].set(v, mode="drop")` throws away out-of-range (sentinel)
  indices; torch indexing would raise or write past the end, so the
  helpers mask them first.
- With repeated indices XLA:CPU applies scatter updates in order, so the
  LAST write wins; CUDA's index_put_ picks any. `set_drop` keeps only
  the last occurrence of each index, which makes the port deterministic
  and equal to the reference.
- `lax.top_k` breaks ties toward the lower index; `stable_topk` sorts
  stably, `torch.topk` promises no order.
- `jnp.nonzero(mask, size=n, fill_value=-1)` is `nonzero_fixed`.

All helpers return new tensors (functional, like the JAX arrays they
stand in for).
"""

from __future__ import annotations

import torch


def _as_values(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    v = torch.as_tensor(val, dtype=t.dtype, device=t.device)
    return v.expand(idx.shape + t.shape[1:])


def _last_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """[n] bool: position holds the last occurrence of its index value."""
    if idx.numel() == 0:
        return torch.zeros_like(idx, dtype=torch.bool)
    order = torch.argsort(idx, stable=True)
    s = idx[order]
    last_sorted = torch.ones_like(s, dtype=torch.bool)
    last_sorted[:-1] = s[:-1] != s[1:]
    last = torch.empty_like(last_sorted)
    last[order] = last_sorted
    return last


def set_drop(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """t.at[idx].set(val, mode="drop") along dim 0, last write wins."""
    idx = idx.reshape(-1).long()
    v = _as_values(t, idx, val.reshape((-1,) + t.shape[1:])
                   if isinstance(val, torch.Tensor) and val.dim() > 0 else val)
    keep = (idx >= 0) & (idx < t.shape[0]) & _last_occurrence(idx)
    out = t.clone()
    out[idx[keep]] = v[keep]
    return out


def set_drop2(t: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, val) -> torch.Tensor:
    """t.at[rows, cols].set(val, mode="drop") on the first two dims."""
    rows = rows.reshape(-1).long()
    cols = cols.reshape(-1).long()
    ok = (rows >= 0) & (rows < t.shape[0]) & (cols >= 0) & (cols < t.shape[1])
    lin = torch.where(ok, rows * t.shape[1] + cols, torch.full_like(rows, -1))
    flat = t.reshape((t.shape[0] * t.shape[1],) + t.shape[2:])
    v = _as_values(flat, lin, val.reshape((-1,) + t.shape[2:])
                   if isinstance(val, torch.Tensor) and val.dim() > 0 else val)
    keep = ok & _last_occurrence(lin)
    out = flat.clone()
    out[lin[keep]] = v[keep]
    return out.reshape(t.shape)


def add_drop(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """t.at[idx].add(val, mode="drop") along dim 0 (order-free)."""
    idx = idx.reshape(-1).long()
    v = _as_values(t, idx, val)
    ok = (idx >= 0) & (idx < t.shape[0])
    out = t.clone()
    out.index_put_((idx[ok],), v[ok], accumulate=True)
    return out


def max_drop(t: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """t.at[idx].max(val, mode="drop") for 1-D t (order-free)."""
    idx = idx.reshape(-1).long()
    v = _as_values(t, idx, val)
    ok = (idx >= 0) & (idx < t.shape[0])
    return t.scatter_reduce(0, idx[ok], v[ok], reduce="amax")


def nonzero_fixed(mask: torch.Tensor, size: int) -> torch.Tensor:
    """First `size` indices where the 1-D `mask` is True, -1 padded (int64)."""
    pos = torch.cumsum(mask.long(), 0) - 1
    slot = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), -1, dtype=torch.long, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index, like lax.top_k."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


__all__ = ["set_drop", "set_drop2", "add_drop", "max_drop", "nonzero_fixed",
           "stable_topk"]
