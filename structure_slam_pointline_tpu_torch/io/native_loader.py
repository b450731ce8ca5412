"""ctypes binding of the repo's native image loader (native/sspl_io.cc).

Counterpart of structure_slam_pointline_tpu/io/native_loader.py, kept
apart so the port imports nothing of the JAX package. The native side
decodes PNG / PNM to float32 grayscale and runs an N-slot prefetching
ring on its own threads, so decoding overlaps the device pipeline. The
library (`native/libsspl_io.so`, git-ignored) is built with `make -C
native` at first use; where that fails the loader falls back to PIL, and
`get_lib()` (None) and `PrefetchingLoader.decoder` ("pil") say so.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from structure_slam_pointline_tpu_torch.io.datasets import load_image_grayscale

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsspl_io.so")
_LOCK_PATH = os.path.join(_REPO_ROOT, "build", "native_make.lock")

MAX_PIXELS = 4096 * 3072

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    """`make -C native` under a file lock (several processes may ask)."""
    os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
    with open(_LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            except (OSError, subprocess.CalledProcessError):
                return False
    return os.path.exists(_LIB_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built if missing; None if it cannot be built
    (the loaders then decode with PIL)."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.sspl_load_image.restype = ctypes.c_int
    lib.sspl_load_image.argtypes = [ctypes.c_char_p, fp, ctypes.c_int, ip, ip]
    lib.sspl_prefetch_start.restype = ctypes.c_void_p
    lib.sspl_prefetch_start.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    lib.sspl_prefetch_next.restype = ctypes.c_int
    lib.sspl_prefetch_next.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, ip, ip]
    lib.sspl_prefetch_stop.restype = None
    lib.sspl_prefetch_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _decoded(buf: np.ndarray, w: ctypes.c_int, h: ctypes.c_int) -> np.ndarray:
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def load_image(path: str) -> np.ndarray:
    """float32 [H, W] grayscale in [0, 255], native decoder (PIL fallback)."""
    lib = get_lib()
    if lib is None:
        return load_image_grayscale(path)
    buf = np.empty(MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.sspl_load_image(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             MAX_PIXELS, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return _decoded(buf, w, h)


class PrefetchingLoader:
    """Order-preserving frame stream: yields (index, [H, W] float32),
    decoded ahead on `n_threads` native threads into a ring of `ring`
    slots."""

    def __init__(self, paths: List[str], n_threads: int = 2, ring: int = 8):
        self.paths = paths
        self._handle = None
        self._lib = get_lib()
        self.decoder = "pil" if self._lib is None else "native"
        if self._lib is not None:
            self._paths_keepalive = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
            self._handle = self._lib.sspl_prefetch_start(self._paths_keepalive, len(paths),
                                                         n_threads, ring)

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        if self._handle is None:
            for i, p in enumerate(self.paths):
                yield i, load_image_grayscale(p)
            return
        buf = np.empty(MAX_PIXELS, np.float32)
        w, h = ctypes.c_int(), ctypes.c_int()
        while True:
            rc = self._lib.sspl_prefetch_next(
                self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), MAX_PIXELS,
                ctypes.byref(w), ctypes.byref(h))
            if rc == -1:
                return
            if rc < 0:
                raise IOError(f"native decode failed ({rc})")
            yield rc, _decoded(buf, w, h)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.sspl_prefetch_stop(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


__all__ = ["MAX_PIXELS", "get_lib", "load_image", "PrefetchingLoader"]
