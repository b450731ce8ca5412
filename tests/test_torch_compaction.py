"""Pool compaction parity: the port's three passes (world/compact.py, kernel
19's plain versions on the CPU), the loop closer's remap and keyframe
cursor, and `SLAMSystem.maybe_compact` against the JAX reference on the
same numpy inputs, and the port through the reference's long-run test's
tiny pools.

Every comparison is exact: a pass is gathers, table lookups and integer
counts (kf_T_cw's identity fill and the float fields are copies), so
every field, `perm`, the live counts, the cursors, the counters and the
local sets must be equal.

The tiny-pools item (the reference's tests/test_compaction.py:96-128
pools: 16 keyframes, 2048 points, 128 lines, a keyframe every <= 3
frames, its room scene and circle) runs the port alone at the helpers'
320x240 size and 512 keypoints, past the first keyframe compaction and
three keyframes further, with the reference test's assertions scaled to
the frames run. At that size the point and line cursors stay below their
triggers within the reference's 60 frames (points 1277 of 1536, lines 67
of 96 on this scene), so the points and lines passes are held to JAX
from a carried state here and fire on the card in chip_smoke's run B.
"""

import numpy as np
import torch

from structure_slam_pointline_tpu.models import loop_closing as jlc
from structure_slam_pointline_tpu.models import system as jsys
from structure_slam_pointline_tpu.world import compact as jcompact
from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.config import KeyframeConfig as TKf
from structure_slam_pointline_tpu_torch.config import MapConfig as TMap
from structure_slam_pointline_tpu_torch.io import synthetic as tsyn
from structure_slam_pointline_tpu_torch.models import system as tsys
from structure_slam_pointline_tpu_torch.models.loop_closing import LoopCloser
from structure_slam_pointline_tpu_torch.world import compact as tcompact

from torch_port_helpers import (MAP, assert_tuple_close, configs, jax_carry, port_boot,
                                to_numpy_dict)

TINY = dict(max_keyframes=16, max_points=2048, max_lines=128)


def _seeded_map(seed: int, prefix_cull: bool) -> dict:
    """A MapState (numpy, the reference's layout) at the helpers' small
    capacities with every field random: random validity masks, edge grids
    holding live, culled (dangling) and -1 references, stamps on live and
    culled keyframes and -1; with `prefix_cull` the first keyframes are
    culled, so stamps there map to new id 0 (the reference's prefix quirk)."""
    jc, _ = configs()
    g = np.random.default_rng(seed)
    d = to_numpy_dict(jms.init_map(jc))
    K, P, L = (d[f].shape[0] for f in ("kf_valid", "mp_valid", "ml_valid"))
    for f, a in d.items():
        if a.dtype == np.bool_:
            d[f] = g.uniform(size=a.shape) < 0.6
        elif a.dtype == np.uint32:
            d[f] = g.integers(0, 2 ** 32, a.shape, dtype=np.uint64).astype(np.uint32)
        elif a.dtype.kind == "f":
            d[f] = g.normal(size=a.shape).astype(a.dtype)
        else:
            d[f] = g.integers(-1, 50, a.shape).astype(a.dtype)
    d["kf_kp_mp"] = g.integers(-1, P, d["kf_kp_mp"].shape).astype(np.int32)
    d["kf_line_ml"] = g.integers(-1, L, d["kf_line_ml"].shape).astype(np.int32)
    for f, n in (("mp_first_kf", P), ("mp_last_kf", P), ("ml_first_kf", L), ("ml_last_kf", L)):
        d[f] = g.integers(-1, K, n).astype(np.int32)
    if prefix_cull:
        d["kf_valid"][:3] = False
        d["kf_valid"][3] = True
    return d


def _jstate(d):
    import jax.numpy as jnp

    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_passes_match_jax():
    for seed, prefix in ((61, False), (62, True)):
        d = _seeded_map(seed, prefix)
        st = convert.map_state_from_numpy(d, "cpu")
        for name in ("compact_points", "compact_lines", "compact_keyframes"):
            ref = getattr(jcompact, name)(_jstate(d))
            out = getattr(tcompact, name)(st)
            assert_tuple_close(to_numpy_dict(ref[0]), out[0])
            assert int(out[1]) == int(ref[1]), (name, seed)
            if name == "compact_keyframes":
                np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
        if prefix:   # a stamp on a culled prefix keyframe maps to new id 0
            first = np.asarray(d["mp_first_kf"])
            np.testing.assert_array_equal(
                tcompact.compact_keyframes(st)[0].mp_first_kf.numpy()[(first >= 0) & (first < 3)],
                0)


def test_remap_kf_cursor_and_loop_closer():
    """`_remap_kf_cursor` on the reference test's permutation and seeded
    cursors; `remap_keyframes` on a loop closer carrying BoW rows, words,
    loop edges and consistency groups."""
    g = np.random.default_rng(63)
    K = 16
    perm = np.full(K, -1, np.int32)
    perm[:8] = [0, 1, 3, 4, 6, 7, 8, 9]
    for cursor in [0, 2, 6, 10, *g.integers(0, 16, 6)]:
        assert tsys._remap_kf_cursor(perm, int(cursor)) == jsys._remap_kf_cursor(perm, int(cursor))
    jc, tc = configs()
    W = 64
    bows = g.uniform(size=(K, W)).astype(np.float32)
    words = {k: g.integers(0, W, 8).astype(np.int32) for k in (0, 2, 3, 6, 9)}
    edges = [(9, 1, g.normal(size=(4, 4)).astype(np.float32)), (5, 0, np.eye(4, dtype=np.float32))]
    groups = [({1, 2, 3}, 2), ({5}, 1), ({6, 8, 9}, 3)]
    ref = jlc.LoopCloser(jc, None)
    port = LoopCloser(tc, None)
    ref.kf_bows, port.kf_bows = bows.copy(), torch.from_numpy(bows.copy())
    for lc in (ref, port):
        lc.kf_words = {k: v.copy() for k, v in words.items()}
        lc.loop_edges = [(a, b, S.copy()) for a, b, S in edges]
        lc._consistent_groups = [(set(s), n) for s, n in groups]
        lc.remap_keyframes(perm)
    np.testing.assert_array_equal(port.kf_bows.numpy(), ref.kf_bows)
    assert sorted(port.kf_words) == sorted(ref.kf_words)
    for k in ref.kf_words:
        np.testing.assert_array_equal(port.kf_words[k], ref.kf_words[k])
    assert [(a, b) for a, b, _ in port.loop_edges] == [(a, b) for a, b, _ in ref.loop_edges]
    assert port._consistent_groups == ref._consistent_groups


def _pushed_carry() -> dict:
    """The port's bootstrap carry (numpy) with keyframe 1 cloned into slots
    2-24, a seeded cull of keyframes, points and lines, a few live lines,
    and the cursors pushed past all three triggers (K - 8 of 32
    keyframes, 0.75 of 4096 points and of 256 lines)."""
    d = port_boot()["carry"]
    st = {k: v.copy() for k, v in d["state"].items()}
    g = np.random.default_rng(64)
    n_kf = MAP["max_keyframes"] - 7
    for f, a in st.items():
        if f.startswith("kf_") and f not in ("kf_valid", "kf_frame_id"):
            a[2:n_kf] = a[1]
    st["kf_valid"][:n_kf] = True
    st["kf_valid"][2:n_kf] &= g.uniform(size=n_kf - 2) < 0.6
    st["kf_frame_id"][2:n_kf] = np.arange(2, n_kf) * 3
    st["mp_valid"] &= g.uniform(size=st["mp_valid"].shape) < 0.5
    st["mp_last_kf"] = np.where(st["mp_valid"], g.integers(0, n_kf, st["mp_valid"].shape),
                                st["mp_last_kf"]).astype(np.int32)
    L = st["ml_valid"].shape[0]
    st["ml_valid"][: 3 * L // 4 + 8] = g.uniform(size=3 * L // 4 + 8) < 0.4
    st["ml_last_kf"] = np.where(st["ml_valid"], g.integers(0, n_kf, L), -1).astype(np.int32)
    st["kf_line_ml"][:n_kf] = g.integers(-1, 3 * L // 4, st["kf_line_ml"][:n_kf].shape)
    out = dict(d, state=st, n_kf=n_kf, n_mp=3 * MAP["max_points"] // 4 + 10,
               n_ml=3 * L // 4 + 8)
    return out


def test_maybe_compact_matches_jax():
    """From one carried state, the port's and the reference's
    `maybe_compact` fire all three passes and leave the same map, carry
    cursors, counters, loop-closing cursor and local sets."""
    jc, tc = configs()
    d = _pushed_carry()
    ref = jsys.SLAMSystem(jc)
    port = tsys.SLAMSystem(tc, device="cpu")
    ref.carry = jax_carry(d)
    port.carry = convert.carry_from_numpy(d, "cpu")
    for s in (ref, port):
        s.map = s.carry.state
        s.sync_cursors()
        s._lc_processed_kf = 20
        s._lm_base = [1, 2, 3, 4]
        s.maybe_compact()
    assert dict(port.metrics.counters) == dict(ref.metrics.counters) == {
        "compact_points": 1, "compact_lines": 1, "compact_keyframes": 1}
    assert (port.cur.n_kf, port.cur.n_mp, port.cur.n_ml) == (
        ref.cur.n_kf, ref.cur.n_mp, ref.cur.n_ml)
    assert (port.carry.n_kf, port.carry.n_mp, port.carry.n_ml) == (
        int(ref.carry.n_kf), int(ref.carry.n_mp), int(ref.carry.n_ml))
    assert port._lc_processed_kf == ref._lc_processed_kf
    assert port._lm_base is None and ref._lm_base is None
    assert_tuple_close(to_numpy_dict(ref.carry.state), port.carry.state)
    assert_tuple_close(to_numpy_dict(ref.carry.local_sets), port.carry.local_sets)
    assert port.map is port.carry.state


def test_tracking_survives_tiny_pools():
    """The reference's long-run scenario through the port alone: tracking
    goes on across repeated keyframe compactions (stale landmark ids in
    the carry would lose it frames later)."""
    _, tc = configs(lines=True)
    cfg = tc.replace(map=TMap(**{**MAP, **TINY}), keyframe=TKf(max_frames=3))
    cam = tc.camera
    scene = tsyn.make_room_scene(n_points=300, n_lines=12, seed=3)
    poses = tsyn.circular_trajectory(60, radius=0.5)
    slam = tsys.SLAMSystem(cfg, device="cpu")
    j, after = 0, -1
    while after < 3 and j < 60:
        slam.track(tsyn.render(scene, poses[j], cam, noise=2.0, seed=j), j)
        if after < 0 and slam.metrics.counters.get("compact_keyframes", 0):
            after = 0
        elif after >= 0 and slam.log[-1].is_keyframe:
            after += 1
        j += 1
    assert slam.carry is not None and after == 3, (j, dict(slam.metrics.counters))
    traj = slam.trajectory()
    ids = sorted(traj)
    assert len(ids) >= j - 10
    est = np.stack([np.linalg.inv(traj[k]) for k in ids])
    ate = tsyn.ate_rmse(est, poses[ids])
    assert ate < 0.05, ate
    assert slam.metrics.counters["compact_keyframes"] >= 1
    slam.sync_cursors()
    assert slam.cur.n_kf <= 16 and slam.cur.n_mp <= 2048 and slam.cur.n_ml <= 128

