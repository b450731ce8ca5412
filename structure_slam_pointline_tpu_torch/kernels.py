"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface (`build/libsspl_<name>_<hash>.so`,
the hash of the source in the name, so an edited source is never served
by a stale library) and loaded with `ctypes`. All sources build in
parallel, one `nvcc` each, at the first kernel call (or by an explicit
`build_all()`); nothing is built or imported when a module is imported,
so the CPU-only tests import every module without a CUDA toolkit.

A wrapper adds one to `COUNTS[name]` where it launches its kernel and
nowhere else; `reset_counts()` zeroes them.
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

# kernel name -> CUDA source; a library exports `sspl_<name>`
SOURCES = {
    "fast_nms": "fast.cu",
    "orb_describe": "orb.cu",
    "hamming_best2": "hamming.cu",
    "pose_lm": "pose_lm.cu",
}

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
    # img, H, W, xy, K, tables, angle, desc, stream
    "orb_describe": [_P, _I, _I, _P, _I, _P, _P, _P, _P],
    # a, b, allow, B, M, N, batch_a, batch_b, best, best_j, second, second_j, stream
    "hamming_best2": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # T_init, X, obs_uv, pt_mask, pt_info, line_obs, ln_mask, ln_info, N, M,
    # fx, fy, cx, cy, rounds, iters, chi2_mono, chi2_line, delta_pt,
    # delta_ln, lam, T_out, pt_in, ln_in, cost, stream
    "pose_lm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                _F, _F, _F, _F, _I, _I, _F, _F, _F, _F, _F,
                _P, _P, _P, _P, _P],
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:10]
    return src, os.path.join(BUILD_DIR, f"libsspl_{name}_{digest}.so")


def _nvcc_cmd(src: str, out: str) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, src]


def build_all(names=None) -> dict:
    """Compile every kernel library that is missing, all `nvcc` processes
    started together; returns {name: ptxas report} for the ones built."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = out + f".tmp{os.getpid()}"
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def lib(name: str):
    """The loaded library of one kernel (built on first use)."""
    handle = _LIBS.get(name)
    if handle is not None:
        return handle
    with _LOCK:
        if name not in _LIBS:
            _, out = _lib_path(name)
            if not os.path.exists(out):
                build_all([name])
            h = ctypes.CDLL(out)
            fn = getattr(h, f"sspl_{name}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _LIBS[name] = h
    return _LIBS[name]


def launch(name: str, *args) -> None:
    """Call `sspl_<name>` on PyTorch's current stream; raise if the launch
    failed (the C side returns cudaGetLastError() after the launch)."""
    fn = getattr(lib(name), f"sspl_{name}")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
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


__all__ = ["SOURCES", "COUNTS", "BUILD_DIR", "reset_counts", "build_all",
           "lib", "launch", "ptr", "check_cuda", "check_dtype"]
