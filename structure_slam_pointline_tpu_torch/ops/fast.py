"""FAST-9/16 score + 3x3 NMS (kernel 1) and spatially uniform selection.

Counterpart of structure_slam_pointline_tpu/ops/fast.py.

`fast_score_nms_levels` is the wrapper of CUDA kernel 1 (csrc/fast.cu)
for a frame: one launch for every pyramid level, from a ctypes level
table kept per (shapes, stream), the raw and NMS maps written as float32
views of one buffer, each view on a 16-byte boundary. `fast_score_nms` is
a one-level call of the same kernel. The kernel replaces the reference's
roll-built `fast_score` (fast.py:39) and `nms3` (fast.py:73).
`fast_score_nms_plain` is the plain version of one level (and
`fast_score_nms_levels_plain` the loop over levels); it repeats the
reference's arithmetic op for op in bf16: 16 rolled differences rounded
to bf16, the sliding 9-arc min, the 3 px border zeroed, and NMS on
`score + jitter` where the jitter ((y*131 + x*31) % 251) * 1e-5 is itself
a bf16 product and the sum is rounded to bf16 (measured against XLA:CPU:
no excess precision is kept, so the jitter only separates near-zero
ties). Rolls wrap at the borders; the border zeroing hides that from
both maps (no pixel inside the border reads a wrapped value).

`select_keypoints_levels` is the wrapper of CUDA kernel 11
(csrc/kp_select.cu, one launch: a warp per cell for the per-cell top
`cell_cap`, then each level's last block to finish selects its top k by
a radix select and writes the sub-pixel offsets). The wrapper keeps one
ctypes work description per (shapes, budgets, options, stream), with the
level tables, the candidate scratch and the per-level counters, and fills
in only the maps and the outputs on each call; with `concat` it returns
the kernel's own buffers, the levels one after another, which kernel 2's
levels entry reads. `select_keypoints_levels_plain` is its plain version:
`cell_cap` rounds of masked argmax per cell (argmax keeps the first
index, like jnp.argmax) and one global ranking per level by a STABLE
descending sort, so ties go to the lower index as in `lax.top_k`.

Both also take [B, H, W] stacks of frames per level (the data-parallel
frontend, parallel/batch_frontend.py): kernels 1 and 11's batch entries,
one launch for every level of all B frames, each frame bit-equal to its
single-frame call. Their plain versions run a stack frame by frame.
"""

from __future__ import annotations

import ctypes

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
    """(raw, nms) float32 score maps of a bf16 level (a stack frame by
    frame)."""
    if img.dim() == 3:
        outs = [fast_score_nms_plain(f) for f in img]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    raw = fast_score_plain(img)
    return raw.float(), nms3_plain(raw).float()


def fast_score_nms_levels_plain(levels: list) -> list:
    """[(raw, nms)] of each level: `fast_score_nms_plain` level by level."""
    return [fast_score_nms_plain(lv) for lv in levels]


MAX_LEVELS = 16          # the level tables of kernels 1 and 11


class _FastWork(ctypes.Structure):
    """Kernel 1's description of one call (`struct Work` in csrc/fast.cu)."""
    _fields_ = ([(n, ctypes.c_void_p * MAX_LEVELS) for n in ("img", "raw", "nms")]
                + [(n, ctypes.c_int * MAX_LEVELS) for n in ("h", "w")]
                + [(n, ctypes.c_int) for n in ("L", "B")])


# (level shapes, device, stream) -> (work with its shapes filled, the maps'
# offsets in the output buffer), one per stream like kernel 11's plans
_FAST_PLANS: dict = {}


def _fast_plan(key):
    shapes = key[0]
    lead = shapes[0][:-2]
    if not 1 <= len(shapes) <= MAX_LEVELS or any(
            len(sh) not in (2, 3) or sh[:-2] != lead or min(sh) < 1 for sh in shapes):
        raise ValueError(f"fast_score_nms_levels: expects 1 to {MAX_LEVELS} [H, W] or "
                         f"[B, H, W] levels of one leading size, got {list(shapes)}")
    B = lead[0] if lead else 1
    if B > 65535:
        raise ValueError(f"fast_score_nms_levels: {B} frames, the kernel takes 65535")
    work = _FastWork(L=len(shapes), B=B)
    for li, sh in enumerate(shapes):
        work.h[li], work.w[li] = sh[-2], sh[-1]
    # the raw and NMS map of each level, each view on a 16-byte boundary
    at = np.cumsum([0] + [-(-int(np.prod(sh)) // 4) * 4 for sh in shapes for _ in (0, 1)])
    plan = (work, [int(a) for a in at])
    _FAST_PLANS[key] = plan
    return plan


def fast_score_nms_levels(levels: list) -> list:
    """[(raw, nms)] float32 FAST score maps of bf16 levels, each [H, W], or
    each a [B, H, W] stack of one leading size (the frame's pyramid).

    CPU tensors -> plain version; CUDA tensors -> kernel 1, one launch for
    every level (and every frame of a stack: the batch entry), or raise.
    The maps are views of one new buffer, each on a 16-byte boundary."""
    if levels[0].device.type == "cpu":
        return fast_score_nms_levels_plain(levels)
    what = "fast_score_nms_levels"
    for lv in levels:
        kernels.check_dtype(what, lv, torch.bfloat16)
    dev = kernels.check_cuda(what, *levels)
    key = (tuple(tuple(lv.shape) for lv in levels), dev,
           torch.cuda.current_stream(dev).cuda_stream)
    work, at = _FAST_PLANS.get(key) or _fast_plan(key)
    buf = torch.empty(at[-1], dtype=torch.float32, device=dev)
    out = []
    for li, lv in enumerate(levels):
        n = lv.numel()
        raw = buf[at[2 * li]:at[2 * li] + n].view(lv.shape)
        nms = buf[at[2 * li + 1]:at[2 * li + 1] + n].view(lv.shape)
        work.img[li], work.raw[li], work.nms[li] = lv.data_ptr(), raw.data_ptr(), nms.data_ptr()
        out.append((raw, nms))
    kernels.launch("fast_nms_batch" if levels[0].dim() == 3 else "fast_nms",
                   ctypes.addressof(work), entry="fast_nms")
    return out


def fast_score_nms(img: torch.Tensor):
    """(raw, nms) float32 FAST score maps of a bf16 [H, W] level, or of a
    [B, H, W] stack of one level.

    CPU tensor -> plain version; CUDA tensor -> kernel 1, one launch of
    one level (its batch entry for a stack), or raise."""
    if img.dim() not in (2, 3) or img.shape[0] < 1:
        raise ValueError(f"fast_score_nms: expects [H, W] or [B, H, W], got "
                         f"{tuple(img.shape)}")
    if img.device.type == "cpu":
        return fast_score_nms_plain(img)
    return fast_score_nms_levels([img])[0]


def select_keypoints_levels_plain(score_raw: list, ks: list, cell: int = 32,
                                  cell_cap: int = 8, threshold: float = 20.0,
                                  min_threshold: float = 7.0, border: int = 16,
                                  concat: bool = False):
    """Per-cell top-`cell_cap` then a global top-k per level, with parabola
    sub-pixel offsets from the raw map; same candidates and ranking as
    the reference's `select_keypoints_levels` (fast.py:197).

    `score_raw` = [(nms_score, raw_score or None)] float32 per level (None:
    no sub-pixel offsets). Returns a list of (xy [k, 2], resp [k], valid
    [k]) per level; [B, H, W] maps are selected frame by frame, each
    level's outputs then with a leading B axis. With `concat`, the levels'
    outputs joined along the keypoint axis: (xy [K, 2], resp [K], valid
    [K]), K the sum of the budgets."""
    if concat:
        outs = select_keypoints_levels_plain(score_raw, ks, cell, cell_cap, threshold,
                                             min_threshold, border)
        return (torch.cat([o[0] for o in outs], dim=-2),
                *(torch.cat([o[q] for o in outs], dim=-1) for q in (1, 2)))
    if score_raw[0][0].dim() == 3:
        per_frame = [select_keypoints_levels_plain(
            [(s[b], r[b] if r is not None else None) for s, r in score_raw], ks, cell,
            cell_cap, threshold, min_threshold, border)
            for b in range(score_raw[0][0].shape[0])]
        return [tuple(torch.stack([f[li][q] for f in per_frame]) for q in range(3))
                for li in range(len(score_raw))]
    L = len(score_raw)
    assert len(ks) == L
    cap = min(cell_cap, cell * cell)
    per_level = []
    cells_rows = []
    neg_inf = float("-inf")
    for (score, raw) in score_raw:
        if raw is None:
            raw = torch.zeros_like(score)
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


MAX_LEVEL_CANDIDATES = 16384   # a level's cells x cap, whose keys kernel 11 holds in shared memory


class _SelWork(ctypes.Structure):
    """Kernel 11's description of one call (`struct Work` in
    csrc/kp_select.cu)."""
    _fields_ = ([(n, ctypes.c_void_p * MAX_LEVELS) for n in ("score", "raw")]
                + [(n, ctypes.c_int * MAX_LEVELS) for n in ("h", "w", "k", "out_off")]
                + [("cell_off", ctypes.c_int * (MAX_LEVELS + 1))]
                + [(n, ctypes.c_int) for n in ("L", "cell", "cap", "border", "B")]
                + [(n, ctypes.c_float) for n in ("threshold", "min_threshold")]
                + [(n, ctypes.c_void_p) for n in ("top_s", "top_i", "done", "xy", "resp",
                                                  "valid")])


# (map and raw shapes, budgets, options, device, stream) -> (work with its
# tables filled, its scratch and counters kept alive, the leading shape,
# the budgets, the output offsets); one per stream, since a call's counters
# and scratch must not be shared with a call running beside it
_SEL_PLANS: dict = {}


def _sel_plan(key, score_raw, ks, cell, cell_cap, threshold, min_threshold, border, dev):
    """The checks of a new (shapes, budgets, options, stream) and its cached
    work description: the level tables filled, the candidate scratch and
    the per-level counters (zeroed once; the kernel leaves them zero)."""
    what = "select_keypoints_levels"
    L = len(score_raw)
    if L != len(ks) or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{what}: {L} levels, {len(ks)} budgets")
    if not 1 <= cell <= 64:
        raise ValueError(f"{what}: cell {cell} outside 1..64")
    shapes, raw_shapes = key[0], key[1]
    lead = shapes[0][:-2]
    if any(sh[:-2] != lead or len(sh) not in (2, 3) or r not in (None, sh)
           for sh, r in zip(shapes, raw_shapes)):
        raise ValueError(f"{what}: expects [H, W] or [B, H, W] maps of one shape per level "
                         "and one leading size")
    cap = min(cell_cap, cell * cell)
    cell_off = np.cumsum([0] + [-(-sh[-2] // cell) * -(-sh[-1] // cell) for sh in shapes])
    if max(np.diff(cell_off)) * cap > MAX_LEVEL_CANDIDATES:
        raise ValueError(f"{what}: too many candidates per level (> {MAX_LEVEL_CANDIDATES})")
    out_off = [int(o) for o in np.cumsum([0] + list(ks))]
    B = lead[0] if lead else 1
    top_s = torch.empty((B, int(cell_off[-1]) * cap), dtype=torch.float32, device=dev)
    top_i = torch.empty((B, int(cell_off[-1]) * cap), dtype=torch.int32, device=dev)
    done = torch.zeros((B, L), dtype=torch.int32, device=dev)
    work = _SelWork(L=L, cell=cell, cap=cap, border=int(border), B=B,
                    threshold=float(threshold), min_threshold=float(min_threshold),
                    top_s=top_s.data_ptr(), top_i=top_i.data_ptr(), done=done.data_ptr())
    for li, sh in enumerate(shapes):
        work.h[li], work.w[li], work.k[li] = sh[-2], sh[-1], int(ks[li])
        work.out_off[li] = out_off[li]
    for li in range(L + 1):
        work.cell_off[li] = int(cell_off[li])
    plan = (work, (top_s, top_i, done), tuple(lead), [int(k) for k in ks], out_off)
    _SEL_PLANS[key] = plan
    return plan


def select_keypoints_levels(score_raw: list, ks: list, cell: int = 32,
                            cell_cap: int = 8, threshold: float = 20.0,
                            min_threshold: float = 7.0, border: int = 16,
                            concat: bool = False):
    """`select_keypoints_levels_plain`'s result, over [H, W] maps or [B, H,
    W] stacks (one frame per leading index). CPU tensors -> plain version;
    CUDA tensors -> kernel 11, one launch (its batch entry for stacks, all
    B frames at once), or raise. With `concat`, the kernel's own buffers
    (the levels joined along the keypoint axis, as kernel 2's levels entry
    reads them) instead of their per-level views."""
    if score_raw[0][0].device.type == "cpu":
        return select_keypoints_levels_plain(score_raw, ks, cell, cell_cap, threshold,
                                             min_threshold, border, concat)
    what = "select_keypoints_levels"
    maps = [t for pair in score_raw for t in pair if t is not None]
    if any(t.dtype != torch.float32 for t in maps):
        raise TypeError(f"{what}: expects float32 maps")
    dev = kernels.check_cuda(what, *maps)
    key = (tuple(s.shape for s, _ in score_raw),
           tuple(None if r is None else r.shape for _, r in score_raw), tuple(ks), cell,
           cell_cap, threshold, min_threshold, border, dev,
           torch.cuda.current_stream(dev).cuda_stream)
    plan = _SEL_PLANS.get(key) or _sel_plan(key, score_raw, ks, cell, cell_cap, threshold,
                                            min_threshold, border, dev)
    work, _, lead, sizes, out_off = plan
    for li, (s, r) in enumerate(score_raw):
        work.score[li] = s.data_ptr()
        work.raw[li] = r.data_ptr() if r is not None else None
    xy = torch.empty(lead + (out_off[-1], 2), dtype=torch.float32, device=dev)
    resp = torch.empty(lead + (out_off[-1],), dtype=torch.float32, device=dev)
    valid = torch.empty(lead + (out_off[-1],), dtype=torch.bool, device=dev)
    work.xy, work.resp, work.valid = xy.data_ptr(), resp.data_ptr(), valid.data_ptr()
    kernels.launch("kp_select_batch" if lead else "kp_select", ctypes.addressof(work))
    if concat:
        return xy, resp, valid
    return list(zip(xy.split_with_sizes(sizes, dim=-2), resp.split_with_sizes(sizes, dim=-1),
                    valid.split_with_sizes(sizes, dim=-1)))


def select_keypoints(score: torch.Tensor, k: int, cell: int = 32, cell_cap: int = 8,
                     threshold: float = 20.0, min_threshold: float = 7.0,
                     border: int = 16):
    """Single-level selection without sub-pixel refinement, the reference's
    `select_keypoints` (fast.py:92) with `raw=None`: one level of
    `select_keypoints_levels` without a raw map (offsets exactly 0).
    Returns (xy [k, 2], resp [k], valid [k])."""
    return select_keypoints_levels([(score, None)], [k], cell=cell,
                                   cell_cap=cell_cap, threshold=threshold,
                                   min_threshold=min_threshold, border=border)[0]


__all__ = ["fast_score_plain", "nms3_plain", "fast_score_nms_plain",
           "fast_score_nms", "fast_score_nms_levels", "fast_score_nms_levels_plain",
           "select_keypoints_levels", "select_keypoints_levels_plain",
           "select_keypoints", "ARC_LEN"]
