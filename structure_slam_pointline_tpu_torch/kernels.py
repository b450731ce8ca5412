"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface (`build/libsspl_<name>_<hash>.so`,
the hash of the source and of the shared headers in the name, so an
edited source is never served by a stale library) and loaded with
`ctypes`. All sources build in
parallel, one `nvcc` each, at the first kernel call (or by an explicit
`build_all()`); nothing is built or imported when a module is imported,
so the CPU-only tests import every module without a CUDA toolkit.

A source may export several entry points (`ENTRIES`), a source may
include the shared headers (`csrc/*.cuh`), and several kernels may share
one source (kernels 13 and 14 in `bow.cu`, 20 and 21 in `fuse3d.cu`,
kernel 10 and its eigensolver entry in `null_vector4.cu`; the sharded
form of kernel 12 and the dense solver of `csrc/dense_lu.cuh` alone in
`local_ba.cu`, and the frame-batched entries of
kernels 1, 11 and 2 in `fast.cu`, `kp_select.cu` and `orb.cu`; kernel
22's six entries `fuse_match_points`, `fuse_match_lines`, `pool_match`,
`sim3_widen_match`, `track_match_points` and `track_match_lines` in
`fuse_match.cu`, kernel 23's `fuse_merge`, `loop_merge` and `fuse_finish`
in `fuse_merge.cu`, kernel 24's `covis_row` and `covis_matrix` in
`covis.cu`, kernel 25's `pyramid` alone in `pyramid.cu`, kernel 26's
`lsd_merge` and `lsd_octave_merge` in `lsd_merge.cu`): each source is built
once, into one library, and each kernel is counted on its own; every
launch of any of them adds one to its kernel's `COUNTS[name]`, where the
wrapper launches it and nowhere else; `reset_counts()` zeroes them.
Kernels 22-26's C entries make all of a call's launches (memsets and
copies included), so each counts one per call: kernel 25's call launches
once per pyramid level, the tracking entries of kernel 22 a memset and two
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

# kernel name -> CUDA source; a source's library exports `sspl_<entry>` for
# each of the ENTRIES of its kernels (by default the kernel's own name)
SOURCES = {
    "fast_nms": "fast.cu",
    "orb_describe": "orb.cu",
    "hamming_best2": "hamming.cu",
    "pose_lm": "pose_lm.cu",
    "lsd_support": "lsd_support.cu",
    "lsd_refine": "lsd_refine.cu",
    "lbd_describe": "lbd.cu",
    "atan2_glibc": "atan2.cu",
    "obs_bits": "obs_bits.cu",
    "null_vector4": "null_vector4.cu",
    "kp_select": "kp_select.cu",
    "local_ba": "local_ba.cu",
    "bow_transform": "bow.cu",
    "bow_query": "bow.cu",
    "ransac_pnp": "pnp.cu",
    "ransac_sim3": "sim3_ransac.cu",
    "sim3_pair": "sim3_pair.cu",
    "pose_graph": "pose_graph.cu",
    "compact": "compact.cu",
    "fuse_points_3d": "fuse3d.cu",
    "fuse_lines_3d": "fuse3d.cu",
    "jacobi_eigh4": "null_vector4.cu",
    "local_ba_shard": "local_ba.cu",
    "fast_nms_batch": "fast.cu",
    "kp_select_batch": "kp_select.cu",
    "orb_describe_batch": "orb.cu",
    "dense_solve": "local_ba.cu",
    "fuse_match_points": "fuse_match.cu",
    "fuse_match_lines": "fuse_match.cu",
    "pool_match": "fuse_match.cu",
    "sim3_widen_match": "fuse_match.cu",
    "fuse_merge": "fuse_merge.cu",
    "loop_merge": "fuse_merge.cu",
    "fuse_finish": "fuse_merge.cu",
    "covis_matrix": "covis.cu",
    "covis_row": "covis.cu",
    "track_match_points": "fuse_match.cu",
    "track_match_lines": "fuse_match.cu",
    "pyramid": "pyramid.cu",
    "lsd_merge": "lsd_merge.cu",
    "lsd_octave_merge": "lsd_merge.cu",
}

# sources built with nvcc's default -fmad=true (every other one gets
# -fmad=false): kernel 10 (and its eigensolver entry) calls the CUDA math
# library's atan2f / cosf / sinf as torch's own CUDA kernels do, and rounds
# its own products and sums explicitly. Kernel 22's logf equals torch.log's
# under either setting (tools/fuse_numerics.py), so fuse_match.cu, which
# shares csrc/lines.cuh's atan2f with the -fmad=false line kernels, stays
# -fmad=false; so do kernel 26 (lsd_merge.cu: cosf / sinf equal torch.cos /
# torch.sin under either setting, the same probe) and kernel 25
# (pyramid.cu: its products must not fuse into its adds)
FMAD = {"null_vector4.cu"}

ENTRIES = {name: (name,) for name in SOURCES}
ENTRIES["obs_bits"] = ("obs_bits", "votes_from_bits")
ENTRIES["kp_select"] = ("kp_select_cells", "kp_select_rank")
ENTRIES["local_ba"] = ("ba_grid", "ba_classify", "ba_landmarks", "ba_reduce",
                       "ba_solve", "ba_backsub", "ba_edges")
ENTRIES["ransac_pnp"] = ("pnp_hypotheses", "pnp_select")
ENTRIES["ransac_sim3"] = ("sim3_hypotheses", "sim3_count", "sim3_select")
ENTRIES["pose_graph"] = ("pg_jacobians", "pg_assemble", "pg_solve", "pg_cost", "pg_decide")
ENTRIES["compact"] = ("compact_scan", "compact_gather", "compact_remap")
ENTRIES["local_ba_shard"] = ENTRIES["local_ba"]
ENTRIES["kp_select_batch"] = ("kp_select_cells_batch", "kp_select_rank_batch")

COUNTS = {name: 0 for name in SOURCES}

_LIBS: dict = {}
_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument signatures of the exported C entry points
_ARGTYPES = {
    # img, raw, nms, H, W, stream
    "fast_nms": [_P, _P, _P, _I, _I, _P],
    # img, raw, nms, B, H, W, stream
    "fast_nms_batch": [_P, _P, _P, _I, _I, _I, _P],
    # img, H, W, xy, K, tables, angle, desc, stream
    "orb_describe": [_P, _I, _I, _P, _I, _P, _P, _P, _P],
    # img, B, H, W, xy, K, tables, angle, desc, stream
    "orb_describe_batch": [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    # a, b, allow, B, M, N, batch_a, batch_b, best, best_j, second, second_j, stream
    "hamming_best2": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # T_init, pts, pts row stride, line starts, stride, line ends, stride,
    # obs_uv, pt_mask, pt_sigma2, line_obs, ln_mask, ln_sigma2, N, M, fx, fy,
    # cx, cy, rounds, iters, chi2_mono, chi2_line, delta_pt, delta_ln, lam,
    # T_out, pt_in, ln_in, cost, n_inliers, stream
    "pose_lm": [_P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                _F, _F, _F, _F, _I, _I, _F, _F, _F, _F, _F,
                _P, _P, _P, _P, _P, _P],
    # img, H, W, ds, grad_thresh, angle_tol, min_support_px, scratch, best,
    # packed, stream
    "lsd_support": [_P, _I, _I, _I, _F, _F, _F, _P, _P, _P, _P],
    # img, packed, H, W, ax, ay, K, walk_steps, iters, angle_tol, half_grad,
    # out, stream
    "lsd_refine": [_P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _F, _P, _P],
    # img, H, W, endpoints, valid, L, pairs, ts, packed, desc, stream
    "lbd_describe": [_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    # y, x, n, out, stream
    "atan2_glibc": [_P, _P, _I, _P, _P],
    # kf_kp_mp, K, F, P, out, stream
    "obs_bits": [_P, _I, _I, _I, _P, _P],
    # obs_rows, matched, kf_valid, M, KW, K, votes, stream
    "votes_from_bits": [_P, _P, _P, _I, _I, _I, _P, _P],
    # A, N, r, sweeps, out, stream
    "null_vector4": [_P, _I, _I, _I, _P, _P],
    # M, N, sweeps, vals, vecs, stream
    "jacobi_eigh4": [_P, _I, _I, _P, _P, _P],
    # xyz or endpoints, desc, valid, first_kf, rows, R, pool size, th,
    # best, has, stream
    "fuse_points_3d": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "fuse_lines_3d": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # scores, hs, ws, cell_off, L, cell, cap, threshold, min_threshold,
    # border, top_s, top_i, stream
    "kp_select_cells": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P, _P, _P],
    # raws, hs, ws, cell_off, ks, out_off, L, cell, cap, top_s, top_i,
    # xy, resp, valid, stream
    "kp_select_rank": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # the same with the number of frames B before the outputs
    "kp_select_cells_batch": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _P, _P, _P],
    "kp_select_rank_batch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # local BA: a pointer to the host-side work description (optim/local_ba.py
    # _Work), then per entry: classify's mode, edges' two output masks
    "ba_grid": [_P, _P],
    "ba_classify": [_P, _I, _P],
    "ba_landmarks": [_P, _P],
    "ba_reduce": [_P, _P],
    "ba_solve": [_P, _P],
    "ba_backsub": [_P, _P],
    "ba_edges": [_P, _P, _P, _P],
    # A_aug [n, n + 1] (overwritten), n, capacity, piv, x, stream
    "dense_solve": [_P, _I, _I, _P, _P, _P],
    # nodes, branching, depth, desc, valid, B, N, words, bow, stream
    "bow_transform": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
    # q, kf_bows, kf_valid, exclude, K, W, min_score, scores, stream
    "bow_query": [_P, _P, _P, _P, _I, _I, _F, _P, _P],
    # pts_w, uv, sets, mask, C, I, N, fx, fy, cx, cy, thresh, hyp, counts, stream
    "pnp_hypotheses": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P],
    # hyp, counts, pts_w, uv, mask, C, I, N, fx, fy, cx, cy, thresh, T_cw,
    # inliers, n_best, stream
    "pnp_select": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P, _P],
    # p1, p2, sets, I, fix_scale, scale, hyp, stream
    "sim3_hypotheses": [_P, _P, _P, _I, _I, _P, _P, _P],
    # p1, p2, mask, scale, hyp, I, N, fx, fy, cx, cy, th1, th2, counts, stream
    "sim3_count": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P],
    # p1, p2, mask, scale, hyp, counts, I, N, fx, fy, cx, cy, th1, th2, S12,
    # inliers, n_best, stream
    "sim3_select": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P],
    # S12, X1, X2, uv1, uv2, valid, sigma2_1, sigma2_2, N, fx, fy, cx, cy,
    # chi2, delta, n_first, n_second, fix_scale, S_out, inliers, n_inliers, stream
    "sim3_pair": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I,
                  _P, _P, _P, _P],
    # pose graph: a pointer to the host-side work description
    # (optim/pose_graph.py _PG), one entry per launch of an iteration
    "pg_jacobians": [_P, _P],
    "pg_assemble": [_P, _P],
    "pg_solve": [_P, _P],
    "pg_cost": [_P, _P],
    "pg_decide": [_P, _P],
    # valid, N, perm, old2new, stamp_map (or NULL), n_live, stream
    "compact_scan": [_P, _I, _P, _P, _P, _P, _P],
    # perm, N, n_fields, then host arrays of n_fields sources, destinations,
    # row bytes (int64), copy units (int32) and 64-byte fill patterns, stream
    "compact_gather": [_P, _I, _I, _P, _P, _P, _P, _P, _P],
    # n_arrays, host arrays of sources, destinations and lengths (int64),
    # table, table_len, clip, stream
    "compact_remap": [_I, _P, _P, _P, _P, _I, _I, _P],
    # kernels 22-26: a pointer to the host-side work description
    # (ops/matching.py _MatchWork / _MergeWork / _FinishWork,
    # world/map_store.py _CovisWork, ops/pyramid.py _PyrWork, ops/lsd.py
    # _LsdWork)
    **{e: [_P, _P] for e in ("fuse_match_points", "fuse_match_lines", "pool_match",
                             "sim3_widen_match", "fuse_merge", "loop_merge", "fuse_finish",
                             "covis_matrix", "covis_row", "track_match_points",
                             "track_match_lines", "pyramid", "lsd_merge",
                             "lsd_octave_merge")},
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(source: str) -> str:
    """The library of one source; the hash covers the source, the shared
    headers (csrc/*.cuh) and the -fmad choice."""
    h = hashlib.sha1(b"fmad" if source in FMAD else b"")
    for path in [os.path.join(_CSRC, source)] + sorted(
            os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libsspl_{stem}_{h.hexdigest()[:10]}.so")


def _nvcc_cmd(source: str, out: str) -> list[str]:
    fmad = "-fmad=true" if source in FMAD else "-fmad=false"
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", fmad, "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, os.path.join(_CSRC, source)]


def build_all(names=None) -> dict:
    """Compile the library of every named kernel's source (default: all)
    that is missing, all `nvcc` processes started together; returns
    {source: ptxas report} for the ones built."""
    sources = sorted({SOURCES[n] for n in (names or SOURCES)})
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for source in sources:
        out = _lib_path(source)
        if os.path.exists(out):
            continue
        tmp = out + f".tmp{os.getpid()}"
        procs[source] = (subprocess.Popen(
            _nvcc_cmd(source, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    errors = []
    for source, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{source}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[source] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def lib(name: str):
    """The loaded library of one kernel's source (built on first use)."""
    source = SOURCES[name]
    handle = _LIBS.get(source)
    if handle is not None:
        return handle
    with _LOCK:
        if source not in _LIBS:
            out = _lib_path(source)
            if not os.path.exists(out):
                build_all([name])
            h = ctypes.CDLL(out)
            for kernel in (k for k, src in SOURCES.items() if src == source):
                for entry in ENTRIES[kernel]:
                    fn = getattr(h, f"sspl_{entry}")
                    fn.argtypes = _ARGTYPES[entry]
                    fn.restype = ctypes.c_int
            _LIBS[source] = h
    return _LIBS[source]


def launch(name: str, *args, entry: str | None = None) -> None:
    """Call `sspl_<entry>` (default: the kernel's name) of kernel `name` on
    PyTorch's current stream; raise if the launch failed (the C side
    returns cudaGetLastError() after the launch)."""
    entry = entry or name
    if entry not in ENTRIES[name]:
        raise ValueError(f"kernel {name} exports no entry point {entry}")
    fn = getattr(lib(name), f"sspl_{entry}")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} ({entry}) failed to launch: error {err}")
    COUNTS[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    return dev


def check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expects {dtype}, got {t.dtype}")


__all__ = ["SOURCES", "ENTRIES", "COUNTS", "BUILD_DIR", "reset_counts", "build_all",
           "lib", "launch", "ptr", "check_cuda", "check_dtype"]
