"""Pool compaction: reclaim the slots of culled landmarks and keyframes.

Counterpart of structure_slam_pointline_tpu/world/compact.py. The map
allocates slots with monotone bump cursors and culling only clears
validity bits, so on long sequences (881-1509 frames in the reference's
own validation runs) the cursors reach the pool capacities long before
the live counts do. Each pass renumbers the live entries of one pool to
its front, keeping their id order (id order is time order, which the
recency windows rely on), refills the dead slots with their init values
and rewrites every reference:

- `compact_points` / `compact_lines` -> (state, n_live): the mp_* / ml_*
  fields follow the survivor permutation; the [K, F] / [K, LF] edge grid
  maps through old -> new, a reference to a culled slot becoming -1.
- `compact_keyframes` -> (state, n_live, perm): the kf_* fields follow,
  a dead keyframe's pose becomes the identity; landmark first / last
  stamps map through clip(cumsum(valid) - 1, 0, K - 1), so a culled
  keyframe maps to its nearest surviving predecessor (and one before the
  first survivor to new id 0, the reference's documented prefix quirk);
  `mp_obs_bits` is rebuilt from the gathered edge grid (kernel 9).
  `perm` is the [K] new -> old table, -1 padded.

CPU tensors take the plain versions (`*_plain`: a nonzero, a gather and a
where per field); CUDA tensors launch kernel 19 (csrc/compact.cu: a
one-block scan, one gather launch over the pool's fields, one remap
launch; a strided field is made contiguous first) or raise. `n_live`
stays on the device: the caller reads it once per pass, as the
reference's `int(n_mp_j)` does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.world.map_store import MapState, compute_obs_bits

EYE = "eye"   # fill of a dead keyframe's pose

# pool -> [(field, fill of a dead slot)], in the reference's order
POINT_FIELDS = [("mp_xyz", 0), ("mp_valid", False), ("mp_desc", 0), ("mp_normal", 0),
                ("mp_angle", 0), ("mp_dist_min", 0), ("mp_dist_max", 1e9),
                ("mp_first_kf", -1), ("mp_last_kf", -1), ("mp_visible", 0), ("mp_found", 0),
                ("mp_desc_ring", 0), ("mp_ring_n", 0), ("mp_obs_bits", 0)]
LINE_FIELDS = [("ml_endpoints", 0), ("ml_valid", False), ("ml_desc", 0), ("ml_first_kf", -1),
               ("ml_last_kf", -1), ("ml_visible", 0), ("ml_found", 0), ("ml_desc_ring", 0),
               ("ml_ring_n", 0)]
KEYFRAME_FIELDS = [("kf_T_cw", EYE), ("kf_valid", False), ("kf_frame_id", -1), ("kf_xy", 0),
                   ("kf_desc", 0), ("kf_octave", 0), ("kf_angle", 0), ("kf_kp_valid", False),
                   ("kf_kp_mp", -1), ("kf_line2d", 0), ("kf_line_ep", 0), ("kf_ldesc", 0),
                   ("kf_loctave", 0), ("kf_line_valid", False), ("kf_line_ml", -1)]
STAMPS = ("mp_first_kf", "mp_last_kf", "ml_first_kf", "ml_last_kf")


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #
def _fill_value(a: torch.Tensor, fill) -> torch.Tensor:
    if fill == EYE:
        return torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.tensor(fill, dtype=a.dtype, device=a.device)


def _survivors_plain(valid: torch.Tensor):
    """(perm [N] new -> old, -1 padded; old2new [N], -1 for dead slots),
    survivors in id order."""
    N = valid.shape[0]
    ids = torch.nonzero(valid).flatten()
    perm = torch.full((N,), -1, dtype=torch.int32, device=valid.device)
    perm[: ids.numel()] = ids.to(torch.int32)
    old2new = torch.full((N,), -1, dtype=torch.int32, device=valid.device)
    old2new[ids] = torch.arange(ids.numel(), dtype=torch.int32, device=valid.device)
    return perm, old2new


def _gather_plain(a: torch.Tensor, perm: torch.Tensor, fill) -> torch.Tensor:
    live = (perm >= 0).reshape((-1,) + (1,) * (a.ndim - 1))
    return torch.where(live, a[perm.clamp(min=0).long()], _fill_value(a, fill))


def _remap_plain(a: torch.Tensor, table: torch.Tensor, clip: bool) -> torch.Tensor:
    """a < 0 stays; else table[a], a value past the table -> -1 (or, with
    `clip`, the table's last entry)."""
    n = table.shape[0]
    out = table[a.clamp(0, n - 1).long()]
    if not clip:
        out = torch.where(a >= n, torch.full_like(out, -1), out)
    return torch.where(a >= 0, out, a)


def _stamp_map_plain(valid: torch.Tensor) -> torch.Tensor:
    K = valid.shape[0]
    return (torch.cumsum(valid.to(torch.int32), 0) - 1).clamp(0, K - 1).to(torch.int32)


def compact_points_plain(state: MapState):
    perm, old2new = _survivors_plain(state.mp_valid)
    st = state._replace(**{f: _gather_plain(getattr(state, f), perm, fill)
                           for f, fill in POINT_FIELDS},
                        kf_kp_mp=_remap_plain(state.kf_kp_mp, old2new, clip=False))
    return st, (perm >= 0).sum().to(torch.int32)


def compact_lines_plain(state: MapState):
    perm, old2new = _survivors_plain(state.ml_valid)
    st = state._replace(**{f: _gather_plain(getattr(state, f), perm, fill)
                           for f, fill in LINE_FIELDS},
                        kf_line_ml=_remap_plain(state.kf_line_ml, old2new, clip=False))
    return st, (perm >= 0).sum().to(torch.int32)


def compact_keyframes_plain(state: MapState):
    perm, _ = _survivors_plain(state.kf_valid)
    stamp_map = _stamp_map_plain(state.kf_valid)
    st = state._replace(**{f: _gather_plain(getattr(state, f), perm, fill)
                           for f, fill in KEYFRAME_FIELDS},
                        **{f: _remap_plain(getattr(state, f), stamp_map, clip=True)
                           for f in STAMPS})
    st = st._replace(mp_obs_bits=compute_obs_bits(st))
    return st, (perm >= 0).sum().to(torch.int32), perm


# --------------------------------------------------------------------- #
# kernel 19
# --------------------------------------------------------------------- #
_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}
_PAT = 64


def _pattern(a: torch.Tensor, fill) -> bytes:
    """64 bytes whose byte b % 64 is byte b of a dead row."""
    if fill == EYE:
        word = np.eye(a.shape[-1], dtype=_NP_DTYPE[a.dtype]).tobytes()
    else:
        word = np.array(fill, dtype=_NP_DTYPE[a.dtype]).tobytes()
    row_bytes = a[0].numel() * a.element_size()
    if _PAT % len(word) or row_bytes % len(word):
        raise ValueError(f"compact: fill of {len(word)} bytes does not tile a "
                         f"{row_bytes}-byte row")
    return word * (_PAT // len(word))


def _unit(row_bytes: int, *tensors: torch.Tensor) -> int:
    for u in (16, 8, 4):
        if row_bytes % u == 0 and all(t.data_ptr() % u == 0 for t in tensors):
            return u
    return 1


def _scan(valid: torch.Tensor, stamps: bool):
    kernels.check_dtype("compact", valid, torch.bool)
    valid = valid.contiguous()
    N = valid.shape[0]
    dev = valid.device
    perm = torch.empty(N, dtype=torch.int32, device=dev)
    old2new = torch.empty(N, dtype=torch.int32, device=dev)
    stamp_map = torch.empty(N, dtype=torch.int32, device=dev) if stamps else None
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    kernels.launch("compact", kernels.ptr(valid), N, kernels.ptr(perm), kernels.ptr(old2new),
                   kernels.ptr(stamp_map) if stamps else None, kernels.ptr(n_live),
                   entry="compact_scan")
    return perm, old2new, stamp_map, n_live[0]


def _gather(state: MapState, perm: torch.Tensor, fields) -> dict:
    N = perm.shape[0]
    srcs, outs, rows, units, pats = [], [], [], [], b""
    for f, fill in fields:
        a = getattr(state, f).contiguous()
        if a.shape[0] != N or a.dtype not in _NP_DTYPE:
            raise ValueError(f"compact: field {f} {tuple(a.shape)} {a.dtype} against {N} slots")
        out = torch.empty_like(a)
        row_bytes = a[0].numel() * a.element_size()
        srcs.append(a)
        outs.append(out)
        rows.append(row_bytes)
        units.append(_unit(row_bytes, a, out))
        pats += _pattern(a, fill)
    kernels.check_cuda("compact", perm, *srcs, *outs)
    n = len(fields)
    kernels.launch("compact", kernels.ptr(perm), N, n,
                   (ctypes.c_void_p * n)(*(t.data_ptr() for t in srcs)),
                   (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs)),
                   (ctypes.c_longlong * n)(*rows), (ctypes.c_int * n)(*units),
                   (ctypes.c_ubyte * len(pats)).from_buffer_copy(pats), entry="compact_gather")
    return {f: out for (f, _), out in zip(fields, outs)}


def _remap(arrays, table: torch.Tensor, clip: bool):
    arrays = [a.contiguous() for a in arrays]
    for a in arrays:
        kernels.check_dtype("compact", a, torch.int32)
    kernels.check_cuda("compact", table, *arrays)
    outs = [torch.empty_like(a) for a in arrays]
    n = len(arrays)
    kernels.launch("compact", n, (ctypes.c_void_p * n)(*(a.data_ptr() for a in arrays)),
                   (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs)),
                   (ctypes.c_longlong * n)(*(a.numel() for a in arrays)),
                   kernels.ptr(table), table.shape[0], int(clip), entry="compact_remap")
    return outs


def compact_points(state: MapState):
    """(state, n_live) with live map points renumbered to the front. CPU
    tensors -> plain version; CUDA tensors -> kernel 19 (or raise)."""
    if state.mp_valid.device.type == "cpu":
        return compact_points_plain(state)
    perm, old2new, _, n_live = _scan(state.mp_valid, stamps=False)
    out = _gather(state, perm, POINT_FIELDS)
    (out["kf_kp_mp"],) = _remap([state.kf_kp_mp], old2new, clip=False)
    return state._replace(**out), n_live


def compact_lines(state: MapState):
    """(state, n_live) with live map lines renumbered to the front."""
    if state.ml_valid.device.type == "cpu":
        return compact_lines_plain(state)
    perm, old2new, _, n_live = _scan(state.ml_valid, stamps=False)
    out = _gather(state, perm, LINE_FIELDS)
    (out["kf_line_ml"],) = _remap([state.kf_line_ml], old2new, clip=False)
    return state._replace(**out), n_live


def compact_keyframes(state: MapState):
    """(state, n_live, perm) with live keyframes renumbered to the front;
    `perm` [K] is the new -> old table (-1 padded), for host-side indexes
    (the loop closer's BoW rows) to follow."""
    if state.kf_valid.device.type == "cpu":
        return compact_keyframes_plain(state)
    perm, _, stamp_map, n_live = _scan(state.kf_valid, stamps=True)
    out = _gather(state, perm, KEYFRAME_FIELDS)
    out.update(zip(STAMPS, _remap([getattr(state, f) for f in STAMPS], stamp_map, clip=True)))
    st = state._replace(**out)
    return st._replace(mp_obs_bits=compute_obs_bits(st)), n_live, perm


__all__ = ["compact_points", "compact_lines", "compact_keyframes", "compact_points_plain",
           "compact_lines_plain", "compact_keyframes_plain"]
