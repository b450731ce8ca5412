"""Image pyramid + Gaussian blur in bfloat16.

Counterpart of structure_slam_pointline_tpu/ops/pyramid.py. Two parity
points, both checked against the JAX package on the CPU:

- Levels come from `jax.image.resize(..., "bilinear")`, which ANTIALIASES
  when it downscales (triangle kernel stretched by 1/scale) and resizes
  each level from the previous one. `_resize_weights` rebuilds the same
  per-axis weight matrices (float32, then cast to bf16 like the
  reference), and `resize_bilinear` contracts rows first, rounding to
  bf16 after each contraction, which is the order XLA takes.
- `blur` sums 7 rolled taps one after another in bf16, with the tap
  weights themselves rounded to bf16 (a Python-float weight times a bf16
  array is a bf16 product in JAX). Rolls wrap at the borders.

The pyramid functions also take a [B, H, W] stack of frames (the
data-parallel frontend): each frame's resize is its own 2D matmul, as a
single frame's is, so the BLAS picks the same product and the levels are
bit-equal to the frame's own (a batched product may block its float32
sums otherwise); the blur's rolls, products and sums run over the whole
stack at once (elementwise: bit-equal).

Those bodies are the plain versions (`*_plain`). The public functions
are the wrappers of kernel 25 (csrc/pyramid.cu): a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. One launch
writes every level and blurred plane of a call, for all frames of a
stack at once, level after level with a grid barrier between them, from
weight tables (`_taps`, the non-zero run of each output index's bf16
weights) uploaded once per device and shape list, with each level's
resize tile (`_tile`: 32 x 32 unless a source window would pass the
kernel's 64 x 64) and each tile row's and column's source window
(`_spans`); the blur's 7 weights go in as arguments.
`resize_bilinear` and `blur` alone launch the kernel's one-op forms.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels


def level_shapes(height: int, width: int, n_levels: int,
                 scale_factor: float) -> List[Tuple[int, int]]:
    """Static (H, W) per level (level 0 = full resolution)."""
    shapes = []
    for lv in range(n_levels):
        s = scale_factor ** lv
        shapes.append((max(int(round(height / s)), 32),
                       max(int(round(width / s)), 32)))
    return shapes


def level_scales(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor ** lv for lv in range(n_levels)], np.float32)


def gaussian_kernel1d(sigma: float, radius: int = 3) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """[m, n] float32 antialiased triangle weights of jax.image.resize
    (scale = n/m, translation 0)."""
    f32 = np.float32
    # jax.image.resize takes scale = n / m as a Python float and inverts it
    # in double precision before the float32 ops see it
    inv = f32(1.0 / (n / m))
    kernel_scale = max(inv, f32(1.0))
    sample = ((np.arange(n, dtype=f32) + f32(0.5)) * inv - f32(0.5)).astype(f32)
    x = (np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _bf16_weights(m: int, n: int, device) -> torch.Tensor:
    w = torch.from_numpy(_resize_weights(m, n)).to(torch.bfloat16)
    return w.to(device=device, dtype=torch.float32)


def resize_bilinear_plain(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """bf16 [H, W] -> bf16 `shape`, rows contracted first (a [B, H, W]
    stack frame by frame)."""
    if img.dim() == 3:
        return torch.stack([resize_bilinear_plain(f, shape) for f in img])
    h, w = img.shape
    wr = _bf16_weights(h, shape[0], img.device)      # [H, h']
    wc = _bf16_weights(w, shape[1], img.device)      # [W, w']
    rows = (wr.T @ img.float()).to(torch.bfloat16)   # [h', W]
    return (rows.float() @ wc).to(torch.bfloat16)


def blur_plain(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable 7-tap Gaussian via rolled adds over the last two axes
    ([H, W] or a [B, H, W] stack), every op rounded to the image dtype
    (bf16 on the main path)."""
    k = gaussian_kernel1d(sigma, radius)
    wts = [torch.tensor(float(w), dtype=img.dtype, device=img.device) for w in k]
    x = torch.zeros_like(img)
    for i, w in enumerate(wts):
        x = x + w * torch.roll(img, i - radius, dims=-2)
    y = torch.zeros_like(img)
    for i, w in enumerate(wts):
        y = y + w * torch.roll(x, i - radius, dims=-1)
    return y


def build_pyramid_plain(img: torch.Tensor, n_levels: int = 8,
                        scale_factor: float = 1.2) -> List[torch.Tensor]:
    """Grayscale [H, W] (or a [B, H, W] stack) -> list of per-level images,
    each resized from the previous one."""
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_bilinear_plain(levels[-1], shapes[lv]))
    return levels


def build_blurred_pyramid_plain(img: torch.Tensor, n_levels: int = 8,
                                scale_factor: float = 1.2, sigma: float = 2.0):
    levels = build_pyramid_plain(img, n_levels, scale_factor)
    return levels, [blur_plain(lv, sigma) for lv in levels]


# ---- kernel 25 (csrc/pyramid.cu) ----

MAX_LEVELS = 16
MAX_SPANS = 640          # resize tile rows and columns of a call, at most
TAPS = 8                 # resize taps per output index the kernel takes
_ENTRY = 2 + TAPS        # (first, count, weights) per output index
TILE = 32                # a resize tile's outputs per axis, at most
SRC = 64                 # its source window per axis, at most


class _PyrWork(ctypes.Structure):
    """Kernel 25's description of one call (`struct Work` in
    csrc/pyramid.cu)."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "n_levels", "first", "blur")]
                + [(n, ctypes.c_int * MAX_LEVELS) for n in ("H", "W", "row_tab", "col_tab", "tr",
                                                            "tc", "row_span", "col_span")]
                + [(n, ctypes.c_void_p * MAX_LEVELS) for n in ("level", "out", "blurred")]
                + [("tab", ctypes.c_void_p), ("taps", ctypes.c_float * 7),
                   ("trace", ctypes.c_void_p), ("span", ctypes.c_short * (2 * MAX_SPANS))])


@functools.lru_cache(maxsize=None)
def _taps(m: int, n: int) -> np.ndarray:
    """[n, 2 + TAPS] float32: per output index of an m -> n resize, the
    first source index, the count and the bf16-rounded weights of its
    contiguous run of non-zero taps."""
    w = torch.from_numpy(_resize_weights(m, n)).to(torch.bfloat16).float().numpy()
    out = np.zeros((n, _ENTRY), np.float32)
    for j in range(n):
        nz = np.flatnonzero(w[:, j])
        if nz.size == 0:
            continue
        lo, cnt = int(nz[0]), int(nz[-1] - nz[0] + 1)
        if cnt > TAPS:
            raise ValueError(f"pyramid: {m} -> {n} needs {cnt} taps, the kernel takes {TAPS}")
        out[j, 0], out[j, 1] = lo, cnt
        out[j, 2:2 + cnt] = w[lo:lo + cnt, j]
    return out


def _spans(m: int, n: int, size: int) -> list:
    """(first source index, count) of the source window of each tile of
    `size` consecutive outputs of an m -> n resize ((0, 0) for a tile
    with no tap)."""
    t = _taps(m, n)
    out = []
    for i in range(0, n, size):
        run = t[i:i + size]
        run = run[run[:, 1] > 0]
        lo = int(run[:, 0].min()) if len(run) else 0
        out.append((lo, int((run[:, 0] + run[:, 1]).max()) - lo if len(run) else 0))
    return out


@functools.lru_cache(maxsize=None)
def _tile(m: int, n: int) -> int:
    """The largest of 32, 16, 8, ... outputs of an m -> n resize whose
    every tile's source window spans at most SRC."""
    size = TILE
    while size > 1 and max(c for _, c in _spans(m, n, size)) > SRC:
        size //= 2
    return size


_TABLES: dict = {}


def _table(shapes: tuple, device) -> tuple:
    """(device table, {field: per-level ints of _PyrWork}, the tiles'
    source windows) of the resizes between consecutive `shapes`: the taps
    uploaded once per device and shape list, each level's entries, resize
    tile and first window in the lists."""
    key = (str(device), shapes)
    if key not in _TABLES:
        parts, spans, n = [], [], 0
        ints = {f: [0] * MAX_LEVELS for f in ("row_tab", "col_tab", "tr", "tc", "row_span",
                                               "col_span")}
        for lv in range(1, len(shapes)):
            for axis, ax in ((0, "row"), (1, "col")):
                m_, n_ = shapes[lv - 1][axis], shapes[lv][axis]
                t, size = _taps(m_, n_), _tile(m_, n_)
                ints[f"{ax}_tab"][lv], ints["tr" if axis == 0 else "tc"][lv] = n, size
                ints[f"{ax}_span"][lv] = len(spans)
                spans += _spans(m_, n_, size)
                parts.append(t)
                n += t.shape[0]
        if len(spans) > MAX_SPANS or max((a + c for a, c in spans), default=0) > 32767:
            raise ValueError(f"pyramid: {len(spans)} resize tile windows up to "
                             f"{max((a + c for a, c in spans), default=0)}, the kernel takes "
                             f"{MAX_SPANS} up to 32767 (int16)")
        tab = np.concatenate(parts) if parts else np.zeros((1, _ENTRY), np.float32)
        _TABLES[key] = (torch.from_numpy(tab).to(device), ints,
                        [v for sp in spans for v in sp])
    return _TABLES[key]


@functools.lru_cache(maxsize=None)
def _blur_taps(sigma: float, radius: int) -> tuple:
    """The 7 tap weights as the bf16 values `blur_plain` multiplies by."""
    k = torch.from_numpy(gaussian_kernel1d(sigma, radius)).to(torch.bfloat16).float()
    return tuple(float(v) for v in k)


def _launch(img: torch.Tensor, shapes: list, first: int, blur: bool, sigma: float,
            trace: torch.Tensor | None = None):
    """Kernel 25 over levels first..len(shapes)-1 of `img` ([H, W] or a
    [B, H, W] stack, bf16, level first - 1 or level 0): the new levels and,
    with `blur`, the blurred planes (level 0's too when first is 0), all
    views of one new buffer, each starting on a 16-byte boundary. `trace`
    (int64 [2 MAX_LEVELS + 2]) is for a build with -DSSPL_PYR_TRACE
    (tools/kernel_ab.py)."""
    name = "pyramid"
    kernels.check_dtype(name, img, torch.bfloat16)
    if img.dim() not in (2, 3) or len(shapes) > MAX_LEVELS:
        raise ValueError(f"{name}: expects [H, W] or [B, H, W] and at most {MAX_LEVELS} "
                         f"levels, got {tuple(img.shape)}, {len(shapes)} levels")
    img = img.contiguous()
    dev = kernels.check_cuda(name, img)
    lead = tuple(img.shape[:-2])
    B = int(np.prod(lead)) if lead else 1
    shapes = tuple(tuple(int(v) for v in s) for s in shapes)
    tab, ints, spans = _table(shapes, dev)
    sizes = [(lv, "out", shapes[lv]) for lv in range(max(first, 1), len(shapes))]
    if blur:
        sizes += [(lv, "blurred", shapes[lv]) for lv in range(first, len(shapes))]
    at = np.cumsum([0] + [-(-B * h * w // 8) * 8 for _, _, (h, w) in sizes])
    buf = torch.empty(int(at[-1]), dtype=torch.bfloat16, device=dev)
    planes = {}
    for (lv, kind, (h, w)), o in zip(sizes, at):
        planes[kind, lv] = buf[o:o + B * h * w].view(lead + (h, w))
    work = _PyrWork(B=B, n_levels=len(shapes), first=first, blur=int(blur), tab=tab.data_ptr(),
                    taps=(ctypes.c_float * 7)(*(_blur_taps(float(sigma), 3) if blur else ())),
                    **{f: (ctypes.c_int * MAX_LEVELS)(*v) for f, v in ints.items()})
    work.span[:len(spans)] = spans
    for lv, (h, w) in enumerate(shapes):
        work.H[lv], work.W[lv] = h, w
        if ("out", lv) in planes:
            work.out[lv] = work.level[lv] = planes["out", lv].data_ptr()
        if ("blurred", lv) in planes:
            work.blurred[lv] = planes["blurred", lv].data_ptr()
    work.level[0] = img.data_ptr()
    if trace is not None:
        work.trace = trace.data_ptr()
    kernels.launch(name, ctypes.addressof(work))
    return planes


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """bf16 [H, W] (or a [B, H, W] stack) -> bf16 `shape`. CPU tensor ->
    plain version; CUDA tensor -> kernel 25's resize alone (or raise)."""
    if img.device.type == "cpu":
        return resize_bilinear_plain(img, shape)
    return _launch(img, [tuple(img.shape[-2:]), tuple(shape)], 1, False, 0.0)["out", 1]


def blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """The 7-tap blur of a bf16 [H, W] (or [B, H, W]) image. CPU tensor ->
    plain version; CUDA tensor -> kernel 25's blur alone (or raise)."""
    if img.device.type == "cpu":
        return blur_plain(img, sigma, radius)
    if radius != 3:
        raise ValueError(f"blur: kernel 25 takes radius 3, got {radius}")
    return _launch(img, [tuple(img.shape[-2:])], 0, True, sigma)["blurred", 0]


def build_pyramid(img: torch.Tensor, n_levels: int = 8,
                  scale_factor: float = 1.2) -> List[torch.Tensor]:
    """Grayscale bf16 [H, W] (or a [B, H, W] stack) -> list of per-level
    images. CPU tensor -> plain version; CUDA tensor -> kernel 25 (or
    raise)."""
    if img.device.type == "cpu":
        return build_pyramid_plain(img, n_levels, scale_factor)
    shapes = level_shapes(*img.shape[-2:], n_levels, scale_factor)
    planes = _launch(img, shapes, 1, False, 0.0)
    return [img] + [planes["out", lv] for lv in range(1, n_levels)]


def build_blurred_pyramid(img: torch.Tensor, n_levels: int = 8,
                          scale_factor: float = 1.2, sigma: float = 2.0):
    """(levels, blurred levels) of a grayscale bf16 [H, W] image or a
    [B, H, W] stack. CPU tensor -> plain version; CUDA tensor -> kernel 25
    (or raise): one launch for every level of all frames, level 0 blurred
    only."""
    if img.device.type == "cpu":
        return build_blurred_pyramid_plain(img, n_levels, scale_factor, sigma)
    shapes = level_shapes(*img.shape[-2:], n_levels, scale_factor)
    planes = _launch(img, shapes, 0, True, sigma)
    return ([img] + [planes["out", lv] for lv in range(1, n_levels)],
            [planes["blurred", lv] for lv in range(n_levels)])


__all__ = ["level_shapes", "level_scales", "blur", "blur_plain", "resize_bilinear",
           "resize_bilinear_plain", "build_pyramid", "build_pyramid_plain",
           "build_blurred_pyramid", "build_blurred_pyramid_plain"]
