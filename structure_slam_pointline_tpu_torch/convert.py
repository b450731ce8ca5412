"""State converters between numpy dicts and the port's tensor tuples.

A map, carry or frame built by the JAX package can be fetched to numpy
(`jax.device_get(x)._asdict()` on the caller's side; this module never
imports JAX) and handed to the port, and back. Field names and shapes
are the reference's (world/map_store.py MapState, models/pipeline.py
SLAMCarry, models/tracking.py LocalSets and Frame). The reference's
uint32 words (descriptors, observer bitmasks) are stored here as int32
bit patterns: the conversion is a numpy view, lossless both ways.

The loop closer's state crosses too: a vocabulary (the reference's
per-level [B^l, B, 8] uint32 centres, kept uint32 on the host), its BoW
index (`kf_bows` [K, W], `kf_words` {k: [F] int32}), and the rest of its
host state (loop edges, consistency groups, the vocabulary-lifecycle
counters, the number of corrections and the state of its numpy
generator, which draws verify's RANSAC sets). A pose-graph problem
crosses as a dict of its fields.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_slam_pointline_tpu_torch.models import pipeline
from structure_slam_pointline_tpu_torch.models.loop_closing import LoopCloser
from structure_slam_pointline_tpu_torch.models.tracking import Frame, LocalSets
from structure_slam_pointline_tpu_torch.ops.bow import Vocabulary
from structure_slam_pointline_tpu_torch.optim.pose_graph import PoseGraphProblem
from structure_slam_pointline_tpu_torch.world.map_store import MapState

_CARRY_SCALARS = {"n_kf": int, "n_mp": int, "n_ml": int, "frames_since_kf": int,
                  "inliers_at_kf": int, "ok": bool, "recover_hold": int}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor, uint32: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def _tuple_from_numpy(cls, d: dict, device):
    return cls(**{f: _to_tensor(d[f], device) for f in cls._fields})


def _tuple_to_numpy(x, like_uint32: set) -> dict:
    return {f: _to_numpy(getattr(x, f), f in like_uint32) for f in x._fields}


_MAP_U32 = {"kf_desc", "kf_ldesc", "mp_desc", "mp_desc_ring", "mp_obs_bits",
            "ml_desc", "ml_desc_ring"}
_FRAME_U32 = {"desc", "ldesc"}


def map_state_from_numpy(d: dict, device) -> MapState:
    """{MapState field: array} (uint32 descriptor words) -> MapState."""
    return _tuple_from_numpy(MapState, d, device)


def map_state_to_numpy(state: MapState) -> dict:
    return _tuple_to_numpy(state, _MAP_U32)


def local_sets_from_numpy(d: dict, device) -> LocalSets:
    return _tuple_from_numpy(LocalSets, d, device)


def local_sets_to_numpy(sets: LocalSets) -> dict:
    return _tuple_to_numpy(sets, set())


def carry_from_numpy(d: dict, device) -> pipeline.SLAMCarry:
    """{SLAMCarry field: value}; `state` and `local_sets` are themselves
    dicts of arrays, scalars become Python ints / bools."""
    kw = {f: conv(np.asarray(d[f])) for f, conv in _CARRY_SCALARS.items()}
    return pipeline.SLAMCarry(
        state=map_state_from_numpy(d["state"], device),
        T_last=_to_tensor(np.asarray(d["T_last"], np.float32), device),
        velocity=_to_tensor(np.asarray(d["velocity"], np.float32), device),
        local_sets=local_sets_from_numpy(d["local_sets"], device), **kw)


def carry_to_numpy(carry: pipeline.SLAMCarry) -> dict:
    out = {f: np.asarray(getattr(carry, f)) for f in _CARRY_SCALARS}
    out.update(state=map_state_to_numpy(carry.state),
               T_last=carry.T_last.cpu().numpy(),
               velocity=carry.velocity.cpu().numpy(),
               local_sets=local_sets_to_numpy(carry.local_sets))
    return out


def frame_from_numpy(d: dict, device) -> Frame:
    return _tuple_from_numpy(Frame, d, device)


def frame_to_numpy(frame: Frame) -> dict:
    return _tuple_to_numpy(frame, _FRAME_U32)


def vocabulary_from_numpy(centers, branching: int, depth: int) -> Vocabulary:
    """Per-level centre arrays [B^l, B, 8] (uint32, or their int32 bit
    patterns) -> the port's Vocabulary."""
    return Vocabulary(centers=tuple(np.ascontiguousarray(np.asarray(c).view(np.uint32))
                                    for c in centers), branching=int(branching),
                      depth=int(depth))


def bow_index_from_numpy(lc: LoopCloser, voc: Vocabulary, kf_bows, kf_words: dict,
                         device) -> LoopCloser:
    """Load a trained vocabulary and BoW index into a port LoopCloser."""
    lc.voc = voc
    lc.kf_bows = torch.from_numpy(np.array(kf_bows, np.float32)).to(device)
    lc.kf_words = {int(k): np.asarray(w, np.int32) for k, w in kf_words.items()}
    return lc


def loop_closer_state(lc) -> dict:
    """The host state of a loop closer, either package's (the attribute
    names are the reference's), as plain Python and numpy values."""
    return {"loop_edges": [(int(a), int(b), np.array(S, np.float32))
                           for a, b, S in lc.loop_edges],
            "consistent_groups": [(sorted(int(x) for x in g), int(n))
                                  for g, n in lc._consistent_groups],
            "descs_at_train": int(lc._descs_at_train), "descs_seen": int(lc._descs_seen),
            "n_corrections": int(lc.n_corrections), "min_gap": int(lc.min_gap),
            "consistency_th": int(lc.consistency_th),
            "rng_state": lc.rng.bit_generator.state}


def load_loop_closer_state(lc: LoopCloser, d: dict) -> LoopCloser:
    """Set a port LoopCloser's host state from `loop_closer_state(...)`."""
    lc.loop_edges = [(int(a), int(b), np.array(S, np.float32)) for a, b, S in d["loop_edges"]]
    lc._consistent_groups = [(set(int(x) for x in g), int(n))
                             for g, n in d["consistent_groups"]]
    lc._descs_at_train = int(d["descs_at_train"])
    lc._descs_seen = int(d["descs_seen"])
    lc.n_corrections = int(d["n_corrections"])
    lc.min_gap = int(d["min_gap"])
    lc.consistency_th = int(d["consistency_th"])
    lc.rng.bit_generator.state = d["rng_state"]
    return lc


def pose_graph_problem_from_numpy(d: dict, device) -> PoseGraphProblem:
    return _tuple_from_numpy(PoseGraphProblem, d, device)


__all__ = ["map_state_from_numpy", "map_state_to_numpy", "local_sets_from_numpy",
           "local_sets_to_numpy", "carry_from_numpy", "carry_to_numpy",
           "frame_from_numpy", "frame_to_numpy", "vocabulary_from_numpy",
           "bow_index_from_numpy", "loop_closer_state", "load_loop_closer_state",
           "pose_graph_problem_from_numpy"]
