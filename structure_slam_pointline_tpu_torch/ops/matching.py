"""Projection- and window-guided descriptor matching on masks.

Counterpart of structure_slam_pointline_tpu/ops/matching.py. Every search
shares `masked_match`; the row reductions run in kernel 3
(`hamming.masked_best2`), and the ratio, same-level and column-unique
logic stay in torch after it, as in the reference (matching.py:62-91).
Column winners use the same float32 (dist * M + row) key and
`scatter_reduce("amin")`, so a column is claimed by exactly one row.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.ops import hamming

_BIG = hamming.BIG


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [..., M] best feature per query row (int32)
    dist: torch.Tensor   # [..., M] its Hamming distance
    valid: torch.Tensor  # [..., M] bool
    second: torch.Tensor | None = None  # [..., M] re-masked second distance


def masked_match(desc_a: torch.Tensor, desc_b: torch.Tensor, allow: torch.Tensor,
                 max_dist: int, ratio: float = 1.0, unique_cols: bool = True,
                 col_octave: torch.Tensor | None = None) -> MatchResult:
    """Row-wise best match of descriptors `desc_a` against `desc_b` under
    the candidate mask `allow` ([M, N], or [B, M, N] batched) + ratio test.

    Same contract as the reference's `masked_match(hamming_matrix(a, b),
    allow, ...)`: `col_octave` ([N] or [B, N]) restricts the ratio test to
    best/second on the same level; `unique_cols` keeps each column for the
    row with the smallest (dist, row) key."""
    best, best_j, second, second_j = hamming.masked_best2(desc_a, desc_b, allow)
    m, n = allow.shape[-2:]
    ok = best <= max_dist
    if ratio < 1.0:
        passes = best.float() < ratio * torch.clamp(second, max=_BIG).float()
        if col_octave is not None:
            same = (torch.gather(col_octave, -1, best_j.long())
                    == torch.gather(col_octave, -1, second_j.long()))
            passes = passes | ~same
        ok = ok & passes
    if unique_cols:
        bound = max_dist if isinstance(max_dist, (int, float)) else hamming.DESC_BITS
        big_f = float(1 << 24)
        assert (bound + 1) * m < big_f, "masked_match key overflow"
        row_ids = torch.arange(m, dtype=torch.float32, device=allow.device)
        key = torch.where(ok, best.float() * m + row_ids,
                          torch.full((), big_f, device=allow.device))
        col_best = torch.full(allow.shape[:-2] + (n,), big_f,
                              dtype=torch.float32, device=allow.device)
        col_best = col_best.scatter_reduce(-1, best_j.long(), key, reduce="amin")
        ok = ok & (torch.gather(col_best, -1, best_j.long()) == key)
    return MatchResult(idx=best_j, dist=best, valid=ok, second=second)


def jnp_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """Floor modulo computed as jnp.mod does (fmod, then shift by y where
    the signs differ); torch.remainder rounds differently."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def window_mask(pred_uv, pred_ok, kp_xy, kp_valid, radius,
                kp_octave=None, pred_octave=None, octave_slack: int = 1):
    """[..., M, N] candidate mask: inside window, octave-compatible, valid."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=pred_uv.device)
    r = r.expand(pred_uv.shape[:-1])
    du = torch.abs(pred_uv[..., :, 0:1] - kp_xy[..., None, :, 0])
    dv = torch.abs(pred_uv[..., :, 1:2] - kp_xy[..., None, :, 1])
    m = (du <= r[..., None]) & (dv <= r[..., None])
    m = m & pred_ok[..., :, None] & kp_valid[..., None, :]
    if kp_octave is not None and pred_octave is not None:
        m = m & (torch.abs(kp_octave[..., None, :] - pred_octave[..., :, None])
                 <= octave_slack)
    return m


def rotation_consistency(ref_angle, kp_angle, match: MatchResult,
                         n_bins: int = 30, keep_bins: int = 3) -> torch.Tensor:
    """Keep matches whose angle delta falls in the `keep_bins` most
    popular histogram bins; returns the updated valid mask."""
    delta = jnp_mod(ref_angle - kp_angle[match.idx.long()], 2.0 * math.pi)
    bins = torch.remainder(
        torch.floor(delta / (2.0 * torch.pi) * n_bins).to(torch.int32), n_bins)
    hist = torch.zeros(n_bins + 1, dtype=torch.int32, device=delta.device)
    hist = hist.index_put((torch.where(match.valid, bins, n_bins).long(),),
                          torch.ones_like(bins), accumulate=True)[:n_bins]
    thresh = torch.sort(hist, descending=True).values[keep_bins - 1]
    keep = hist[bins.long()] >= torch.clamp(thresh, min=1)
    return match.valid & keep


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    n = valid.sum().to(torch.int64)
    xs = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    idx = torch.clamp((n - 1) // 2, 0, x.shape[0] - 1)
    return torch.where(n > 0, xs[idx], torch.zeros_like(xs[0]))


def mad_margin_gate(match: MatchResult, scale: float = 0.5) -> torch.Tensor:
    """MAD-normalized best-vs-second margin test for line matches
    (reference mad_margin_gate, matching.py:148), from the best and
    re-masked second distances `masked_match` already produced."""
    best = match.dist.float()
    second = torch.clamp(match.second.float(), max=float(_BIG))
    margin = torch.where(second < _BIG, second - best,
                         torch.full_like(best, 255.0))
    has = match.valid
    med = _masked_median(margin, has)
    mad = _masked_median(torch.abs(margin - med), has)
    return match.valid & (margin > scale * 1.4826 * mad)


def predict_octave(dist: torch.Tensor, max_dist: torch.Tensor,
                   scale_factor: float, n_levels: int) -> torch.Tensor:
    """Scale-band octave prediction (MapPoint::PredictScale equivalent)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1.0)
    log_sf = float(np.log(np.float32(scale_factor)))
    lv = torch.ceil(torch.log(ratio) / log_sf).to(torch.int32)
    return torch.clamp(lv, 0, n_levels - 1)


__all__ = ["MatchResult", "masked_match", "window_mask", "rotation_consistency",
           "mad_margin_gate", "predict_octave", "jnp_mod"]
