"""FAST-9/16 score + 3x3 NMS (kernel 1) and spatially uniform selection.

Counterpart of structure_slam_pointline_tpu/ops/fast.py.

`fast_score_nms` is the wrapper of CUDA kernel 1 (csrc/fast.cu), which
replaces the reference's roll-built `fast_score` (fast.py:39) and
`nms3` (fast.py:73). `fast_score_nms_plain` is its plain version and
repeats the reference's arithmetic op for op in bf16: 16 rolled
differences rounded to bf16, the sliding 9-arc min, the 3 px border
zeroed, and NMS on `score + jitter` where the jitter
((y*131 + x*31) % 251) * 1e-5 is itself a bf16 product and the sum is
rounded to bf16 (measured against XLA:CPU: no excess precision is kept,
so the jitter only separates near-zero ties). Rolls wrap at the borders;
the border zeroing hides that from the raw map but not from the NMS
input, and the kernel reproduces the wrap.

`select_keypoints_levels` stays torch ops on the device: 8 rounds of
masked argmax per 32x32 cell (argmax keeps the first index, like
jnp.argmax) and one global ranking per level by a STABLE descending
sort, so ties go to the lower index as in `lax.top_k`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.utils.indexing import stable_topk

# Bresenham circle of radius 3, (dx, dy), clockwise (same order as the
# reference; the arc windows depend on it)
_CIRCLE = np.asarray(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    np.int32,
)

ARC_LEN = 9


def fast_score_plain(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST score [H, W] in the image dtype (bf16 on the main path)."""
    h, w = img.shape
    diffs = torch.stack(
        [torch.roll(img, shifts=(int(dy), int(dx)), dims=(0, 1))
         for dx, dy in -_CIRCLE]) - img[None]

    def window_min(x):
        m2 = torch.minimum(x, torch.roll(x, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        return torch.minimum(m8, torch.roll(x, -8, 0))

    bright = window_min(diffs).amax(0)
    dark = window_min(-diffs).amax(0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    valid = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(valid, score, torch.zeros_like(score))


def nms3_plain(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima of `score` + position jitter (same dtype)."""
    h, w = score.shape
    yy = torch.arange(h, device=score.device)[:, None]
    xx = torch.arange(w, device=score.device)[None, :]
    jitter = ((yy * 131 + xx * 31) % 251).to(score.dtype) * torch.tensor(
        1e-5, dtype=score.dtype, device=score.device)
    s = torch.where(score > 0, score + jitter, score)
    pooled = F.max_pool2d(s.float()[None, None], 3, 1, 1)[0, 0]
    return torch.where(s.float() >= pooled, score, torch.zeros_like(score))


def fast_score_nms_plain(img: torch.Tensor):
    """(raw, nms) float32 score maps of a bf16 level."""
    raw = fast_score_plain(img)
    return raw.float(), nms3_plain(raw).float()


def fast_score_nms(img: torch.Tensor):
    """(raw, nms) float32 [H, W] FAST score maps of a bf16 [H, W] level.

    CPU tensor -> plain version; CUDA tensor -> kernel 1 (or raise)."""
    if img.dim() != 2:
        raise ValueError(f"fast_score_nms: expects [H, W], got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return fast_score_nms_plain(img)
    kernels.check_dtype("fast_score_nms", img, torch.bfloat16)
    kernels.check_cuda("fast_score_nms", img)
    h, w = img.shape
    raw = torch.empty((h, w), dtype=torch.float32, device=img.device)
    nms = torch.empty_like(raw)
    kernels.launch("fast_nms", kernels.ptr(img), kernels.ptr(raw),
                   kernels.ptr(nms), h, w)
    return raw, nms


def select_keypoints_levels(score_raw: list, ks: list, cell: int = 32,
                            cell_cap: int = 8, threshold: float = 20.0,
                            min_threshold: float = 7.0, border: int = 16):
    """Per-cell top-`cell_cap` then a global top-k per level, with parabola
    sub-pixel offsets from the raw map; same candidates and ranking as
    the reference's `select_keypoints_levels` (fast.py:197).

    `score_raw` = [(nms_score, raw_score)] float32 per level. Returns a
    list of (xy [k, 2], resp [k], valid [k]) per level."""
    L = len(score_raw)
    assert len(ks) == L
    cap = min(cell_cap, cell * cell)
    per_level = []
    cells_rows = []
    neg_inf = float("-inf")
    for (score, raw) in score_raw:
        score = score.float()
        h, w = score.shape
        dev = score.device
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        in_border = ((yy >= border) & (yy < h - border)
                     & (xx >= border) & (xx < w - border))
        s = torch.where(in_border & (score >= min_threshold), score,
                        torch.zeros_like(score))
        strong_bonus = torch.where(s >= threshold, 1e4, 0.0)
        s_ranked = torch.where(s > 0, s + strong_bonus,
                               torch.full_like(s, neg_inf))
        r_ = raw.float()
        xn, xp = torch.roll(r_, -1, 1), torch.roll(r_, 1, 1)
        yn, yp = torch.roll(r_, -1, 0), torch.roll(r_, 1, 0)
        offx = torch.clamp(0.5 * (xn - xp)
                           / torch.clamp(2.0 * r_ - xn - xp, min=1e-3), -0.5, 0.5)
        offy = torch.clamp(0.5 * (yn - yp)
                           / torch.clamp(2.0 * r_ - yn - yp, min=1e-3), -0.5, 0.5)
        ph = (cell - h % cell) % cell
        pw = (cell - w % cell) % cell
        sp = F.pad(s_ranked, (0, pw, 0, ph), value=neg_inf)
        ncy, ncx = (h + ph) // cell, (w + pw) // cell
        cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3) \
                  .reshape(ncy * ncx, cell * cell)
        cells_rows.append(cells)
        per_level.append((h, w, ncy, ncx, offx, offy))

    row_off = np.cumsum([0] + [c.shape[0] for c in cells_rows])
    c = torch.cat(cells_rows)
    iota = torch.arange(c.shape[1], device=c.device)[None, :]
    vals, idxs = [], []
    for _ in range(cap):
        i = torch.argmax(c, dim=1)
        vals.append(torch.gather(c, 1, i[:, None])[:, 0])
        idxs.append(i)
        c = torch.where(iota == i[:, None], torch.full_like(c, neg_inf), c)
    top_s_all = torch.stack(vals, dim=1)
    top_i_all = torch.stack(idxs, dim=1)

    flats = []
    for li, (h, w, ncy, ncx, _ox, _oy) in enumerate(per_level):
        nc = ncy * ncx
        top_s = top_s_all[row_off[li]: row_off[li] + nc]
        top_i = top_i_all[row_off[li]: row_off[li] + nc]
        rid = torch.arange(nc, device=top_s.device)[:, None]
        abs_y = (rid // ncx) * cell + top_i // cell
        abs_x = (rid % ncx) * cell + top_i % cell
        flats.append((top_s.reshape(-1), abs_y.reshape(-1), abs_x.reshape(-1)))
    width = max(f[0].shape[0] for f in flats)
    kmax = max(min(k, f[0].shape[0]) for k, f in zip(ks, flats))
    key_mat = torch.stack([
        F.pad(f[0], (0, width - f[0].shape[0]), value=neg_inf) for f in flats])
    sel_v, sel_i = stable_topk(key_mat, min(kmax, width))

    outs = []
    for li, ((flat_s, flat_y, flat_x), (h, w, _ncy, _ncx, offx, offy)) in \
            enumerate(zip(flats, per_level)):
        k = ks[li]
        kk = min(k, flat_s.shape[0], sel_i.shape[1])
        si = torch.clamp(sel_i[li, :kk], 0, flat_s.shape[0] - 1)
        sel_s = flat_s[si]
        sel_y = flat_y[si]
        sel_x = flat_x[si]
        valid = torch.isfinite(sel_v[li, :kk]) & (sel_s > 0)
        resp = torch.where(sel_s >= 1e4, sel_s - 1e4, sel_s)
        sy = torch.clamp(sel_y, 0, h - 1)
        sx = torch.clamp(sel_x, 0, w - 1)
        xy = torch.stack([sel_x.float() + offx[sy, sx],
                          sel_y.float() + offy[sy, sx]], dim=-1)
        if kk < k:
            pad = k - kk
            xy = torch.cat([xy, xy.new_zeros((pad, 2))])
            resp = torch.cat([resp, resp.new_zeros((pad,))])
            valid = torch.cat([valid, valid.new_zeros((pad,))])
        outs.append((xy, resp, valid))
    return outs


__all__ = ["fast_score_plain", "nms3_plain", "fast_score_nms_plain",
           "fast_score_nms", "select_keypoints_levels", "ARC_LEN"]
