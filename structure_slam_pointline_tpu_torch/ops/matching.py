"""Projection- and window-guided descriptor matching on masks.

Counterpart of structure_slam_pointline_tpu/ops/matching.py. Every search
shares `masked_match`; the row reductions run in kernel 3
(`hamming.masked_best2`), and the ratio, same-level and column-unique
logic stay in torch after it, as in the reference (matching.py:62-91).
Column winners use the same float32 (dist * M + row) key and
`scatter_reduce("amin")`, so a column is claimed by exactly one row.

`fused_match` launches one entry of CUDA kernel 22 (csrc/fuse_match.cu),
which projects each row, tests its gates and window and matches it in one
pass, the searches of the projection fuses and the loop closer, without
the [B, M, N] mask `window_mask` writes for their plain versions.
The tracking round's two matches are kernel 22's tracking entries
(`track_match_points`, `track_match_lines`): the same pass plus the ratio
test, and a block per call for the gates that need every row, the
rotation histogram and the MAD margin gate; their plain versions are the
window_mask + masked_match + rotation_consistency / mad_margin_gate
sequence of the reference's `_match_points` / `_match_lines`.
`merge_walk` and `fuse_finish` launch kernel 23 (csrc/fuse_merge.cu),
which applies those searches' matches: the merge walk of either rule (the
local fuses' `fuse_merge`, the loop fuse's `loop_merge`) and the finish
both share, without the [K, P + 1] table of `fuse_finish_plain`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.ops import hamming
from structure_slam_pointline_tpu_torch.utils import camera as cam_utils
from structure_slam_pointline_tpu_torch.utils import fmath

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
    """Lower median of x over the valid entries of the last axis (0 when
    there are none), kept as a size-1 last axis."""
    n = valid.sum(-1, keepdim=True).to(torch.int64)
    xs = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))), dim=-1).values
    idx = torch.clamp((n - 1) // 2, 0, x.shape[-1] - 1)
    return torch.where(n > 0, torch.gather(xs, -1, idx), torch.zeros_like(xs[..., :1]))


def mad_margin_gate(match: MatchResult, scale: float = 0.5) -> torch.Tensor:
    """MAD-normalized best-vs-second margin test for line matches
    (reference mad_margin_gate, matching.py:148), from the best and
    re-masked second distances `masked_match` already produced; a batched
    match gates each batch row on its own median."""
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


class _MatchWork(ctypes.Structure):
    """Kernel 22's description of one call (`struct Work` in
    csrc/fuse_match.cu): sizes, scalars, then device pointers (null where
    the entry reads no such input)."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "M", "N", "P", "n_levels", "max_dist", "k",
                                             "cand")]
                + [(n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "width", "height",
                                                 "radius", "inv_log_sf")]
                + [(n, ctypes.c_void_p) for n in (
                    "a_ids", "b_ids", "present", "M_cw", "table", "pool_ids", "xyz", "dmin",
                    "dmax", "normal", "desc", "endpoints", "kf_T", "S12", "S21", "kf_xy",
                    "line_ep", "kf_valid", "kf_oct", "kf_desc", "pow_sf", "sig2", "idx",
                    "dist", "valid", "col_key", "flags")]
                + [(n, ctypes.c_float) for n in ("margin", "ratio", "inv_two_pi", "mad_scale")]
                + [("n_bins", ctypes.c_int)]
                + [(n, ctypes.c_void_p) for n in ("ref_angle", "frame_angle", "visible",
                                                  "aux")])


_MATCH_DTYPES = {"a_ids": torch.int32, "b_ids": torch.int32, "present": torch.bool,
                 "table": torch.int32, "pool_ids": torch.int32, "desc": torch.int32,
                 "kf_valid": torch.bool, "kf_oct": torch.int32, "kf_desc": torch.int32}


def fused_match(entry: str, B: int, M: int, N: int, inputs: dict, intr,
                **scalars) -> MatchResult:
    """Launch kernel 22's `entry` over B batches of M rows against N target
    features: [B, M] idx / dist / valid. `inputs` maps the Work's pointer
    fields to CUDA tensors (float32 unless listed in _MATCH_DTYPES),
    `scalars` its other int / float fields (the image `width` and
    `height` for the in-image gate, its `margin`, 2 px unless given)."""
    out = _fused(entry, B, M, N, inputs, intr, **{"margin": 2.0, **scalars})
    return MatchResult(idx=out["idx"], dist=out["dist"], valid=out["valid"])


def _fused(entry: str, B: int, M: int, N: int, inputs: dict, intr, **scalars) -> dict:
    """`fused_match`'s launch: the dict of its output tensors (the tracking
    entries' also hold `visible`)."""
    for name, t in inputs.items():
        kernels.check_dtype(f"{entry} ({name})", t, _MATCH_DTYPES.get(name, torch.float32))
    ins = {name: t.contiguous() for name, t in inputs.items()}
    dev = kernels.check_cuda(entry, *ins.values())
    if N == 0:
        raise ValueError(f"{entry}: empty column set")
    out = {"idx": torch.empty((B, M), dtype=torch.int32, device=dev),
           "dist": torch.empty((B, M), dtype=torch.int32, device=dev),
           "valid": torch.empty((B, M), dtype=torch.bool, device=dev),
           "col_key": torch.empty((B, N), dtype=torch.int32, device=dev),
           "flags": torch.empty((B, M), dtype=torch.uint8, device=dev)}
    if entry.startswith("track_"):
        out["visible"] = torch.empty((B, M), dtype=torch.bool, device=dev)
        out["aux"] = torch.empty((B, M), dtype=torch.int32, device=dev)
    work = _MatchWork(B=B, M=M, N=N, fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
                      **scalars,
                      **{k: t.data_ptr() for k, t in (*ins.items(), *out.items())})
    if B * M > 0:
        kernels.launch(entry, ctypes.addressof(work))
    return out


_POWERS: dict = {}


def sf_powers(scale_factor: float, n: int, device, step: float = 1.0) -> torch.Tensor:
    """[n] float32 sf^(step k), k = 0..n-1: torch.pow on `device`, computed
    once per device (the values the per-call powers of the tracking round
    had, now a gather)."""
    key = (float(scale_factor), int(n), float(step), str(device))
    if key not in _POWERS:
        base = torch.tensor(scale_factor, dtype=torch.float32, device=device)
        _POWERS[key] = torch.pow(base, step * torch.arange(n, dtype=torch.float32,
                                                           device=device))
    return _POWERS[key]


def track_match_points_plain(state, frame, T_cw: torch.Tensor, ids: torch.Tensor, intr, cfg,
                             radius_scale: float, check_rotation: bool = False,
                             ratio: float = 1.0):
    """The tracking round's point match (reference models/tracking.py
    `_match_points`): the local landmarks `ids` ([M], -1 padded) projected
    through T_cw and gated (depth and in-image at a 4 px margin, scale
    band, viewing angle), windowed at radius_scale sf^predicted octave
    with octave slack 1 against the frame's keypoints, matched at TH_HIGH
    with the ratio test and unique columns, then (check_rotation) the
    rotation histogram. Returns (MatchResult [M], visible [M])."""
    P = state.mp_valid.shape[0]
    ids_ok = ids >= 0
    safe_ids = torch.clamp(ids, 0, P - 1).long()
    xyz = state.mp_xyz[safe_ids]
    p_cam = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv, z = cam_utils.project(intr, p_cam)
    in_img = cam_utils.in_image(cfg.camera, uv, margin=4.0) & (z > 0.1)
    dist = torch.linalg.norm(p_cam, dim=-1)
    dist_max = state.mp_dist_max[safe_ids]
    no_band = (dist_max <= 0.0) | (dist_max >= 1e8)
    band_ok = no_band | ((dist >= state.mp_dist_min[safe_ids] * 0.8)
                         & (dist <= dist_max * 1.2))
    ray = xyz - (-T_cw[:3, :3].T @ T_cw[:3, 3])
    ray = ray / torch.clamp(torch.linalg.norm(ray, dim=-1, keepdim=True), min=1e-9)
    nrm = state.mp_normal[safe_ids]
    cos_view = torch.sum(ray * nrm, dim=-1)
    has_normal = torch.linalg.norm(nrm, dim=-1) > 0.5
    view_ok = torch.where(has_normal, cos_view > 0.5, True)
    visible = ids_ok & in_img & band_ok & view_ok
    sf, n_levels = cfg.frontend.scale_factor, cfg.frontend.n_levels
    pred_oct = predict_octave(dist, torch.where(no_band, dist, dist_max), sf, n_levels)
    radius = radius_scale * sf_powers(sf, n_levels, dist.device)[pred_oct.long()]
    allow = window_mask(uv, visible, frame.xy, frame.kp_valid, radius,
                        kp_octave=frame.octave, pred_octave=pred_oct, octave_slack=1)
    m = masked_match(state.mp_desc[safe_ids], frame.desc, allow,
                     max_dist=cfg.matching.th_high, ratio=ratio, col_octave=frame.octave)
    if check_rotation:
        m = m._replace(valid=rotation_consistency(
            state.mp_angle[safe_ids], frame.angle, m, n_bins=cfg.matching.histo_bins))
    return m, visible


def track_match_lines_plain(state, frame, T_cw: torch.Tensor, ids: torch.Tensor, intr, cfg,
                            radius: float):
    """The tracking round's line match (reference `_match_lines`): both
    endpoints in front, the projected midpoint in the image (4 px) and
    within `radius` of the frame line's, the undirected angle within 0.26
    rad (glibc atan2f), TH_HIGH, ratio 0.9, unique columns, then the MAD
    margin gate. Returns (MatchResult [M], visible [M])."""
    L = state.ml_valid.shape[0]
    ids_ok = ids >= 0
    safe_ids = torch.clamp(ids, 0, L - 1).long()
    ep = state.ml_endpoints[safe_ids]

    def proj(p):
        return cam_utils.project(intr, p @ T_cw[:3, :3].T + T_cw[:3, 3])

    uv_s, z_s = proj(ep[:, :3])
    uv_e, z_e = proj(ep[:, 3:])
    mid = 0.5 * (uv_s + uv_e)
    vis = ids_ok & (z_s > 0.1) & (z_e > 0.1) & cam_utils.in_image(
        cfg.camera, mid, margin=4.0)
    fr_mid = 0.5 * (frame.line_ep[:, 0:2] + frame.line_ep[:, 2:4])
    allow = window_mask(mid, vis, fr_mid, frame.line_valid, radius)
    seg = uv_e - uv_s
    ang_m = fmath.atan2(seg[:, 1], seg[:, 0])
    fr_ang = fmath.atan2(frame.line_ep[:, 3] - frame.line_ep[:, 1],
                         frame.line_ep[:, 2] - frame.line_ep[:, 0])
    dang = jnp_mod(ang_m[:, None] - fr_ang[None, :] + torch.pi / 2,
                   torch.pi) - torch.pi / 2
    allow = allow & (torch.abs(dang) < 0.26)
    m = masked_match(state.ml_desc[safe_ids], frame.ldesc, allow,
                     max_dist=cfg.matching.th_high, ratio=0.9)
    m = m._replace(valid=mad_margin_gate(m, scale=cfg.matching.line_mad_ratio))
    return m, vis


def _track_result(out: dict):
    return MatchResult(idx=out["idx"][0], dist=out["dist"][0],
                       valid=out["valid"][0]), out["visible"][0]


def track_match_points(state, frame, T_cw: torch.Tensor, ids: torch.Tensor, intr, cfg,
                       radius_scale: float, check_rotation: bool = False,
                       ratio: float = 1.0):
    """The tracking round's point match (`track_match_points_plain`). CPU
    tensors -> plain version; CUDA tensors -> kernel 22's
    `track_match_points` (or raise), which writes no [M, N] mask and
    uploads nothing: the sf^k table is `sf_powers`' cached one."""
    if ids.device.type == "cpu":
        return track_match_points_plain(state, frame, T_cw, ids, intr, cfg, radius_scale,
                                        check_rotation, ratio)
    sf, n_levels = cfg.frontend.scale_factor, cfg.frontend.n_levels
    log_sf = np.float32(np.log(np.float32(sf)))
    return _track_result(_fused(
        "track_match_points", 1, ids.shape[0], frame.xy.shape[0], dict(
            pool_ids=ids.to(torch.int32), kf_T=T_cw, xyz=state.mp_xyz,
            dmin=state.mp_dist_min, dmax=state.mp_dist_max, normal=state.mp_normal,
            desc=state.mp_desc, kf_xy=frame.xy, kf_valid=frame.kp_valid,
            kf_oct=frame.octave, kf_desc=frame.desc, ref_angle=state.mp_angle,
            frame_angle=frame.angle, pow_sf=sf_powers(sf, n_levels, ids.device)),
        intr, width=cfg.camera.width, height=cfg.camera.height, margin=4.0,
        P=state.mp_valid.shape[0], n_levels=n_levels, max_dist=cfg.matching.th_high,
        inv_log_sf=float(np.float32(1.0) / log_sf), radius=float(radius_scale),
        ratio=float(ratio), inv_two_pi=float(np.float32(1.0) / np.float32(2.0 * math.pi)),
        n_bins=cfg.matching.histo_bins if check_rotation else 0))


def track_match_lines(state, frame, T_cw: torch.Tensor, ids: torch.Tensor, intr, cfg,
                      radius: float):
    """The tracking round's line match (`track_match_lines_plain`). CPU
    tensors -> plain version; CUDA tensors -> kernel 22's
    `track_match_lines` (or raise), which writes no [M, N] mask."""
    if ids.device.type == "cpu":
        return track_match_lines_plain(state, frame, T_cw, ids, intr, cfg, radius)
    return _track_result(_fused(
        "track_match_lines", 1, ids.shape[0], frame.line_ep.shape[0], dict(
            pool_ids=ids.to(torch.int32), kf_T=T_cw, endpoints=state.ml_endpoints,
            desc=state.ml_desc, line_ep=frame.line_ep, kf_valid=frame.line_valid,
            kf_desc=frame.ldesc),
        intr, width=cfg.camera.width, height=cfg.camera.height, margin=4.0,
        P=state.ml_valid.shape[0], max_dist=cfg.matching.th_high, radius=float(radius),
        ratio=0.9, mad_scale=cfg.matching.line_mad_ratio * 1.4826))


class _MergeWork(ctypes.Structure):
    """Kernel 23's merge walk (`struct MergeWork` in csrc/fuse_merge.cu)."""
    _fields_ = ([(n, ctypes.c_int) for n in ("D", "M", "K", "F", "P", "loop")]
                + [(n, ctypes.c_void_p) for n in (
                    "table_in", "table", "valid_in", "valid", "redirect", "obs", "a_ids",
                    "b_ids", "present", "pool_ids", "feat", "hits", "win", "dec")])


class _FinishWork(ctypes.Structure):
    """Kernel 23's finish (`struct FinishWork` in csrc/fuse_merge.cu)."""
    _fields_ = ([(n, ctypes.c_int) for n in ("K", "F", "P", "clear_invalid")]
                + [(n, ctypes.c_void_p) for n in ("table_in", "table", "valid", "redirect",
                                                  "r1", "r2")])


def merge_walk(entry: str, table: torch.Tensor, valid: torch.Tensor, b_ids: torch.Tensor,
               feat_idx: torch.Tensor, hits: torch.Tensor, **inputs):
    """Launch kernel 23's merge walk `entry` (fuse_merge or loop_merge) over
    the D directions of b_ids / feat_idx / hits [D, M]; `inputs` are the
    rule's other arrays (obs and a_ids, or present and pool_ids). Returns
    (table, valid, redirect), new tensors."""
    i32, b8 = torch.int32, torch.bool
    typed = {"table_in": (table, i32), "valid_in": (valid, b8), "b_ids": (b_ids, i32),
             "feat": (feat_idx, i32), "hits": (hits, b8),
             **{k: (v, b8 if k == "present" else i32) for k, v in inputs.items()}}
    for name, (t, dt) in typed.items():
        kernels.check_dtype(f"{entry} ({name})", t, dt)
    ins = {name: t.contiguous() for name, (t, _) in typed.items()}
    dev = kernels.check_cuda(entry, *ins.values())
    (K, F), P = table.shape, valid.shape[0]
    D, M = hits.shape
    out = {"table": torch.empty_like(ins["table_in"]), "valid": torch.empty_like(valid),
           "redirect": torch.empty(P, dtype=i32, device=dev),
           "win": torch.empty(P, dtype=i32, device=dev),
           "dec": torch.empty(3 * M, dtype=i32, device=dev)}
    work = _MergeWork(D=D, M=M, K=K, F=F, P=P, loop=int(entry == "loop_merge"),
                      **{k: t.data_ptr() for k, t in (*ins.items(), *out.items())})
    kernels.launch(entry, ctypes.addressof(work))
    return out["table"], out["valid"], out["redirect"]


def _compose_redirect(redirect: torch.Tensor) -> torch.Tensor:
    for _ in range(3):
        redirect = redirect[redirect.long()]
    return redirect


def _dedup_row_table(tbl: torch.Tensor, cap: int) -> torch.Tensor:
    """Clear repeated landmark ids within each row, keeping the first."""
    K, F = tbl.shape
    dev = tbl.device
    rows = torch.arange(K, device=dev)[:, None].expand(K, F)
    feats = torch.arange(F, dtype=torch.int32, device=dev)[None, :].expand(K, F)
    ids = torch.where(tbl >= 0, tbl, cap).long()
    first = torch.full((K, cap + 1), F, dtype=torch.int32, device=dev)
    lin = (rows * (cap + 1) + ids).reshape(-1)
    first = first.reshape(-1).scatter_reduce(0, lin, feats.reshape(-1),
                                             reduce="amin").reshape(K, cap + 1)
    keep = (tbl >= 0) & (first[rows, ids] == feats)
    return torch.where(keep, tbl, -1)


def fuse_finish_plain(table: torch.Tensor, valid: torch.Tensor, redirect: torch.Tensor,
                      clear_invalid: bool) -> torch.Tensor:
    """The fuse's finish: redirect chains composed (three pointer jumps),
    applied to every binding, bindings to dead landmarks cleared (the
    local fuses; the loop fuse keeps them, as the reference does), then
    repeated landmark ids within a row cleared, keeping the first."""
    P = valid.shape[0]
    redirect = _compose_redirect(redirect)
    clampP = lambda t: torch.clamp(t, 0, P - 1).long()  # noqa: E731
    table = torch.where(table >= 0, redirect[clampP(table)], table)
    if clear_invalid:
        table = torch.where((table >= 0) & valid[clampP(table)], table, -1)
    return _dedup_row_table(table, P)


def fuse_finish(table: torch.Tensor, valid: torch.Tensor, redirect: torch.Tensor,
                clear_invalid: bool) -> torch.Tensor:
    """The fuse's finish. CPU tensors -> plain version; CUDA tensors ->
    kernel 23's finish (or raise), which writes no [K, P + 1] table."""
    if table.device.type == "cpu":
        return fuse_finish_plain(table, valid, redirect, clear_invalid)
    name = "fuse_finish"
    kernels.check_dtype(name, table, torch.int32)
    kernels.check_dtype(name, valid, torch.bool)
    kernels.check_dtype(name, redirect, torch.int32)
    tin, v, r = table.contiguous(), valid.contiguous(), redirect.contiguous()
    dev = kernels.check_cuda(name, tin, v, r)
    (K, F), P = table.shape, valid.shape[0]
    out = torch.empty_like(tin)
    r1, r2 = (torch.empty(P, dtype=torch.int32, device=dev) for _ in range(2))
    work = _FinishWork(K=K, F=F, P=P, clear_invalid=int(clear_invalid),
                       **{k: t.data_ptr() for k, t in (("table_in", tin), ("table", out),
                                                       ("valid", v), ("redirect", r),
                                                       ("r1", r1), ("r2", r2))})
    kernels.launch(name, ctypes.addressof(work))
    return out


__all__ = ["MatchResult", "masked_match", "window_mask", "rotation_consistency",
           "mad_margin_gate", "predict_octave", "jnp_mod", "fused_match", "merge_walk",
           "fuse_finish", "fuse_finish_plain", "sf_powers", "track_match_points",
           "track_match_points_plain", "track_match_lines", "track_match_lines_plain"]
