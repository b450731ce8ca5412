"""Relocalization parity: the port's BoW vocabulary and index (kernels 13
and 14), RANSAC PnP (kernel 15), `relocalize`, `track_reference_keyframe`
and the system's lost-frame ladder against the JAX reference, on the same
numpy inputs, at the test sizes of torch_port_helpers (320x240).

Tolerances and why:
- vocabulary centres, words and BoW vectors exactly equal (host numpy
  training copied line for line; integer histograms and one IEEE
  division);
- database scores within 1e-6 (the L1 sum runs in kernel 14's order, XLA
  in its own) with the same candidate list;
- PnP: on every hypothesis whose DLT null vector JAX's SVD returned with
  det(P[:, :3]) > 0, R within 1e-3 and t within 1e-2 and the inlier rows
  equal (the two packages' float32 SVDs round differently, most on
  near-degenerate six-point samples); the port normalizes the null vector
  to det > 0 (ops/pnp.py), so on the other hypotheses it departs from JAX
  by design;
- relocalized poses within 1e-4 (one pose solve chain in float32);
- the slice as a whole: the same tracked / lost flags and recovered frame,
  poses within 1e-3 (tests/test_torch_slice.py's bound).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from structure_slam_pointline_tpu import config as jcfg_mod
from structure_slam_pointline_tpu.io import synthetic
from structure_slam_pointline_tpu.models import relocalization as jrel
from structure_slam_pointline_tpu.models.loop_closing import LoopCloser as JLoopCloser
from structure_slam_pointline_tpu.models.system import SLAMSystem as JSystem
from structure_slam_pointline_tpu.models.tracking import Frame as JFrame
from structure_slam_pointline_tpu.ops import bow as jbow
from structure_slam_pointline_tpu.ops import pnp as jpnp
from structure_slam_pointline_tpu.world.map_store import MapCursors as JCursors
from structure_slam_pointline_tpu.world.map_store import MapState as JMapState
from structure_slam_pointline_tpu_torch import config as tcfg_mod
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import pipeline as tpipe
from structure_slam_pointline_tpu_torch.models import relocalization as trel
from structure_slam_pointline_tpu_torch.models.loop_closing import LoopCloser as TLoopCloser
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem as TSystem
from structure_slam_pointline_tpu_torch.models.system import TrackingState as TState
from structure_slam_pointline_tpu_torch.ops import bow as tbow
from structure_slam_pointline_tpu_torch.ops import pnp as tpnp
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.world.map_store import MapCursors as TCursors

from test_bow_pnp import clustered_descs
from torch_port_helpers import CAM, configs, disk_cached, jax_carry, jax_intr, port_boot


@functools.lru_cache(maxsize=None)
def _vocabularies():
    """The same clustered descriptors through both trainers (B 8, depth 4)."""
    d = clustered_descs(3000, seed=2)
    return jbow.train_vocabulary(d, 8, 4, seed=3), tbow.train_vocabulary(d, 8, 4, seed=3)


def test_train_vocabulary_centres_equal():
    vj, vt = _vocabularies()
    assert (vt.branching, vt.depth, vt.n_words) == (8, 4, 4096)
    for lvl, (a, b) in enumerate(zip(vj.centers, vt.centers)):
        assert b.dtype == np.uint32 and b.shape == (8 ** lvl, 8, 8)
        np.testing.assert_array_equal(b, np.asarray(a))
    conv = convert.vocabulary_from_numpy([np.asarray(c) for c in vj.centers], 8, 4)
    assert all(np.array_equal(a, b) for a, b in zip(conv.centers, vt.centers))


def _frame_descs():
    """A real frame's descriptors (the port's bootstrap, the next frame)
    with its own invalid slots, and three more slots made invalid."""
    f = port_boot()["frame"]
    valid = f["kp_valid"].copy()
    valid[[0, 7, 100]] = False
    return f["desc"], valid


def test_transform_words_and_bow_exact():
    vj, vt = _vocabularies()
    desc, valid = _frame_descs()
    assert not valid.all()
    wj, bj = jbow.transform(vj, jnp.asarray(desc), jnp.asarray(valid))
    wt, bt = tbow.transform(vt, torch.from_numpy(desc.view(np.int32)), torch.from_numpy(valid))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert (wt.numpy()[~valid] == -1).all()
    np.testing.assert_array_equal(bt.numpy().view(np.int32), np.asarray(bj).view(np.int32))
    # batched: the frame and a shifted copy in one call
    desc2 = np.stack([desc, np.roll(desc, 5, axis=0)])
    valid2 = np.stack([valid, np.roll(valid, 5)])
    wb, bb = tbow.transform(vt, torch.from_numpy(desc2.view(np.int32)), torch.from_numpy(valid2))
    for i in range(2):
        w1, b1 = jbow.transform(vj, jnp.asarray(desc2[i]), jnp.asarray(valid2[i]))
        np.testing.assert_array_equal(wb[i].numpy(), np.asarray(w1))
        np.testing.assert_array_equal(bb[i].numpy(), np.asarray(b1))


def _policy(scores):
    """The reference's candidate list (relocalization.py:94-105)."""
    best = scores.max()
    return [int(c) for c in np.argsort(scores)[::-1]
            if scores[c] >= 0.75 * best][:trel.MAX_CANDIDATES]


def test_query_database_scores_and_candidates():
    vj, vt = _vocabularies()
    desc, valid = _frame_descs()
    g = np.random.default_rng(4)
    # 40 keyframe rows: noisy re-observations of the frame (every third
    # descriptor's bits flipped, at a rate that grows with the row), three
    # rows left zero (never indexed: score exactly 0.5, below the cut),
    # some invalid; the candidates' scores lie > 1e-5 apart, so the order
    # is decided at the scores' agreement
    sets = []
    for k in range(40):
        d = desc.copy()
        bits = np.unpackbits(d.view(np.uint8), axis=1)
        flip = g.uniform(size=bits.shape) < (0.01 + 0.01 * k)
        bits[::3] ^= flip[::3].astype(np.uint8)
        sets.append(np.packbits(bits, axis=1).view(np.uint32))
    kf_bows = np.stack([np.asarray(jbow.transform(vj, jnp.asarray(s), jnp.asarray(valid))[1])
                        for s in sets])
    kf_bows[[5, 17, 33]] = 0.0
    kf_valid = g.uniform(size=40) > 0.15
    _, bq = jbow.transform(vj, jnp.asarray(desc), jnp.asarray(valid))
    for min_score in (0.0, 0.6):
        sj = np.asarray(jbow.query_database(bq, jnp.asarray(kf_bows), jnp.asarray(kf_valid),
                                            min_score))
        st = tbow.query_database(torch.from_numpy(np.array(bq)), torch.from_numpy(kf_bows),
                                 torch.from_numpy(kf_valid), min_score).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(st < 0, sj < 0)
    cands = _policy(sj)
    assert len(cands) > 3 and np.diff(np.sort(sj[cands])).min() > 1e-5
    assert _policy(st) == cands
    assert not set(cands) & {5, 17, 33}


def _pnp_problem():
    """test_bow_pnp's PnP problem (pose, 0.5 px noise) at N 200 with 30%
    outliers, and 256 fixed six-point sample sets."""
    from structure_slam_pointline_tpu.utils import lie

    cam = jcfg_mod.CameraConfig(fy=480.0)
    g = np.random.default_rng(1)
    n = 200
    pts = np.stack([g.uniform(-2, 2, n), g.uniform(-1.5, 1.5, n), g.uniform(3, 8, n)],
                   1).astype(np.float32)
    T = np.asarray(lie.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.3, -0.1, 0.15], jnp.float32)))
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([pc[:, 0] / pc[:, 2] * cam.fx + cam.cx,
                   pc[:, 1] / pc[:, 2] * cam.fy + cam.cy], 1) + g.normal(0, 0.5, (n, 2))
    uv[:60] += g.uniform(20, 60, (60, 2)) * g.choice([-1, 1], (60, 2))
    sets = np.stack([g.choice(n, 6, replace=False) for _ in range(256)]).astype(np.int32)
    return cam, pts, uv.astype(np.float32), np.ones(n, bool), sets, T


def test_ransac_pnp_hypotheses():
    from structure_slam_pointline_tpu.utils.camera import Intrinsics as JIntr

    cam, pts, uv, mask, sets, T_gt = _pnp_problem()
    ji = JIntr.from_config(cam)
    ti = Intrinsics.from_config(tcfg_mod.CameraConfig(fy=480.0))
    one = jax.jit(jax.vmap(lambda s: jpnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(uv),
                                                     jnp.asarray(mask), s[None], ji)))
    per = one(jnp.asarray(sets))               # JAX, one hypothesis at a time
    full = jpnp.ransac_pnp(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(mask),
                           jnp.asarray(sets), ji)
    out = tpnp.ransac_pnp(torch.from_numpy(pts)[None], torch.from_numpy(uv),
                          torch.from_numpy(mask)[None], torch.from_numpy(sets)[None], ti)
    out = tpnp.PnPResult(*(v[0] for v in out))  # the one candidate
    # JAX's own null-vector signs, from the same DLT systems
    A, _ = tpnp.dlt_systems(torch.from_numpy(pts)[None], torch.from_numpy(uv),
                            torch.from_numpy(sets)[None], ti)
    _, _, vt = jnp.linalg.svd(jnp.asarray(A[0].numpy()))
    det_j = np.linalg.det(np.asarray(vt[:, -1]).reshape(-1, 3, 4)[:, :, :3])
    pos = det_j > 0
    assert 0.3 < pos.mean() < 0.7               # both signs occur in the reference
    hyp = out.hyp.numpy()
    Tj = np.asarray(per.T_cw)
    np.testing.assert_allclose(hyp[pos, :, :3], Tj[pos, :3, :3], atol=1e-3, rtol=0)
    np.testing.assert_allclose(hyp[pos, :, 3], Tj[pos, :3, 3], atol=1e-2, rtol=0)
    ok_t = tpnp.inlier_masks_plain(out.hyp[None], torch.from_numpy(pts)[None],
                                   torch.from_numpy(uv), torch.from_numpy(mask)[None], ti)[0]
    np.testing.assert_array_equal(ok_t.numpy()[pos], np.asarray(per.inliers)[pos])
    np.testing.assert_array_equal(out.counts.numpy()[pos], np.asarray(per.n_inliers)[pos])
    # every hypothesis orthonormal; a reflection only where the cheirality
    # step flipped R (majority of the six points behind the camera)
    R = hyp[:, :, :3].astype(np.float64)
    np.testing.assert_allclose(R.transpose(0, 2, 1) @ R, np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    X = pts[sets].astype(np.float64)
    z_unflipped = -(np.einsum("ij,inj->in", R[:, 2], X) + hyp[:, None, 2, 3])
    refl = np.linalg.det(R) < 0
    assert (np.sign(z_unflipped[refl]).sum(1) < 0).all()
    # the best hypothesis: the port keeps every hypothesis JAX solved with
    # det > 0, so it finds at least JAX's count; JAX's winner is one of them
    jb = int(np.argmax(np.asarray(per.n_inliers)))
    assert pos[jb] and int(full.n_inliers) == int(np.asarray(per.n_inliers)[jb])
    np.testing.assert_allclose(hyp[jb], np.asarray(full.T_cw)[:3], atol=1e-3)
    assert bool(out.success) and bool(full.success)
    assert int(out.n_inliers) >= int(full.n_inliers)
    assert np.abs(out.T_cw.numpy()[:3, 3] - T_gt[:3, 3]).max() < 0.15
    assert not out.inliers.numpy()[:60].sum() > 8


# ---------------------------------------------------------------------- #
# relocalize / track_reference_keyframe on the port's bootstrapped map


@functools.lru_cache(maxsize=None)
def _reloc_inputs():
    """The bootstrapped map (two keyframes), its vocabulary and index
    trained by the JAX loop closer and carried into the port, and query
    frames, built by the port's frontend (bit-exact to the reference's)
    and handed to both: keyframe 0's pose re-rendered with another noise
    seed (a revisit) and the next frame (for the reference-keyframe
    rung)."""
    jc, tc = configs()
    boot = port_boot()
    d = boot["carry"]
    n_kf = int(d["n_kf"])
    jstate = JMapState(**{k: jnp.asarray(v) for k, v in d["state"].items()})
    intr_j = jax_intr(jc)
    lc_j = JLoopCloser(jc, intr_j)
    assert lc_j.ensure_vocabulary(jstate, n_kf)
    tstate = convert.map_state_from_numpy(d["state"], "cpu")
    intr_t = Intrinsics.from_config(tc.camera)
    lc_t = convert.bow_index_from_numpy(
        TLoopCloser(tc, intr_t),
        convert.vocabulary_from_numpy([np.asarray(c) for c in lc_j.voc.centers], 8, 4),
        lc_j.kf_bows, lc_j.kf_words, "cpu")
    cam = jcfg_mod.CameraConfig(**CAM)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose0 = synthetic.circular_trajectory(120, radius=0.5)[0]
    img = synthetic.render(scene, pose0, cam, noise=2.0, seed=4321)
    revisit = convert.frame_to_numpy(tpipe.build_frame_device(torch.from_numpy(img), intr_t, tc))
    return dict(jc=jc, tc=tc, n_kf=n_kf, jstate=jstate, tstate=tstate, lc_j=lc_j, lc_t=lc_t,
                intr_j=intr_j, intr_t=intr_t, d=d, revisit=revisit, next_frame=boot["frame"])


def _tframe(d):
    """A frame as numpy (uint32 descriptor words) -> (port Frame, JAX Frame)."""
    return convert.frame_from_numpy(d, "cpu"), JFrame(**{k: jnp.asarray(v) for k, v in d.items()})


def test_index_matches_reference_and_own_training():
    r = _reloc_inputs()
    own = TLoopCloser(r["tc"], r["intr_t"])
    assert own.ensure_vocabulary(r["tstate"], r["n_kf"])
    np.testing.assert_array_equal(own.kf_bows.numpy(), np.asarray(r["lc_j"].kf_bows))
    assert sorted(own.kf_words) == sorted(r["lc_j"].kf_words)
    for k, w in r["lc_j"].kf_words.items():
        np.testing.assert_array_equal(own.kf_words[k], w)


@contextlib.contextmanager
def _recorded_candidates(mod, state):
    """Records each `relocalize` call's candidate keyframe ids, in order:
    the keyframes whose descriptor rows its BoW matching receives (padding
    rows carry no node id)."""
    calls, fn = [], mod._bow_match_candidates
    kf_desc = np.asarray(state.kf_desc).view(np.uint32)

    def spy(frame, desc_k, node_k, *rest):
        dk, nk = np.asarray(desc_k).view(np.uint32), np.asarray(node_k)
        ids = []
        for c in range(dk.shape[0]):
            if (nk[c] >= 0).any():
                (k,) = np.nonzero((kf_desc == dk[c]).all(axis=(1, 2)))[0][:1]
                ids.append(int(k))
        calls.append(ids)
        return fn(frame, desc_k, node_k, *rest)
    mod._bow_match_candidates = spy
    try:
        yield calls
    finally:
        mod._bow_match_candidates = fn


def test_relocalize_recovers_and_rejects():
    r = _reloc_inputs()
    tf, jf = _tframe(r["revisit"])
    Tj = jrel.relocalize(r["jstate"], r["n_kf"], jf, r["lc_j"], r["intr_j"], r["jc"],
                         np.random.default_rng(7))
    Tt = trel.relocalize(r["tstate"], r["n_kf"], tf, r["lc_t"], r["intr_t"], r["tc"],
                         np.random.default_rng(7))
    assert Tj is not None and Tt is not None
    np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    # wide: no 0.75 x best cut; the same candidate list, the same pose
    lists = {}
    for name, mod, state, f, lc, intr, cfg in (
            ("jax", jrel, r["jstate"], jf, r["lc_j"], r["intr_j"], r["jc"]),
            ("torch", trel, r["tstate"], tf, r["lc_t"], r["intr_t"], r["tc"])):
        with _recorded_candidates(mod, state) as cands:
            T = mod.relocalize(state, r["n_kf"], f, lc, intr, cfg, np.random.default_rng(7),
                               wide=True)
        assert T is not None, name
        lists[name] = (cands, np.asarray(T))
    assert lists["torch"][0] == lists["jax"][0] and len(lists["jax"][0]) == 1
    assert len(lists["jax"][0][0]) == r["n_kf"], lists["jax"][0]
    np.testing.assert_allclose(lists["torch"][1], lists["jax"][1], atol=1e-4)
    # an unknown place: random descriptors at random pixels
    g = np.random.default_rng(3)
    F = tf.xy.shape[0]
    unk = dict(r["revisit"])
    unk.update(xy=g.uniform(0, 300, (F, 2)).astype(np.float32),
               desc=g.integers(0, 2 ** 32, (F, 8), dtype=np.uint32),
               kp_valid=np.ones(F, bool))
    tu, ju = _tframe(unk)
    assert jrel.relocalize(r["jstate"], r["n_kf"], ju, r["lc_j"], r["intr_j"], r["jc"],
                           np.random.default_rng(7)) is None
    assert trel.relocalize(r["tstate"], r["n_kf"], tu, r["lc_t"], r["intr_t"], r["tc"],
                           np.random.default_rng(7)) is None


def test_track_reference_keyframe_recovers_and_rejects():
    r = _reloc_inputs()
    tf, jf = _tframe(r["next_frame"])
    T_last = np.asarray(r["d"]["T_last"], np.float32)
    Tj = jrel.track_reference_keyframe(r["jstate"], r["n_kf"], jf, r["lc_j"], T_last,
                                       r["intr_j"], r["jc"])
    Tt = trel.track_reference_keyframe(r["tstate"], r["n_kf"], tf, r["lc_t"], T_last,
                                       r["intr_t"], r["tc"])
    assert Tj is not None and Tt is not None
    np.testing.assert_allclose(Tt, np.asarray(Tj), atol=1e-4)
    # the frame's descriptors scrambled: too few BoW matches in both
    g = np.random.default_rng(5)
    unk = dict(r["next_frame"])
    unk["desc"] = g.integers(0, 2 ** 32, unk["desc"].shape, dtype=np.uint32)
    tu, ju = _tframe(unk)
    assert jrel.track_reference_keyframe(r["jstate"], r["n_kf"], ju, r["lc_j"], T_last,
                                         r["intr_j"], r["jc"]) is None
    assert trel.track_reference_keyframe(r["tstate"], r["n_kf"], tu, r["lc_t"], T_last,
                                         r["intr_t"], r["tc"]) is None


# ---------------------------------------------------------------------- #
# the slice as a whole

N_NORMAL = 24          # frames rendered before the blackout
TELEPORT = range(4, 10)  # mapped poses the camera jumps back to


def _scenario():
    """48-frame circle of radius 0.8 on the bench scene: frames 0-23, three
    pure-noise frames, then re-renders (other noise seeds) of poses 4-9."""
    cam = jcfg_mod.CameraConfig(**CAM)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(48, radius=0.8)
    imgs = synthetic.render_sequence(scene, poses[:N_NORMAL + 3], cam, noise=2.0)
    g = np.random.default_rng(0)
    tele = np.stack([synthetic.render(scene, poses[k], cam, noise=2.0, seed=1000 + k)
                     for k in TELEPORT])
    seq = np.concatenate([imgs, tele])
    seq[N_NORMAL:N_NORMAL + 3] = g.uniform(0, 255, seq[N_NORMAL:N_NORMAL + 3].shape)
    gt = np.concatenate([poses[:N_NORMAL + 3], poses[list(TELEPORT)]])
    return seq.astype(np.float32), gt


def _result(slam, T, ok, i0, gt):
    ids = np.nonzero(ok)[0]
    est = np.linalg.inv(T[ids])
    return dict(T=T, ok=ok, i0=i0, ate=synthetic.ate_rmse(est, gt[i0 + ids]),
                counters=dict(slam.metrics.counters))


@disk_cached
def _slice_runs():
    """The port bootstraps on the scenario (points only, test config);
    its carry goes to a fresh SLAMSystem of each package, which then runs
    the rest of the sequence through `track_sequence`: the port frame by
    frame, the reference on its per-frame path (`_step_with_recovery`;
    the sequence is shorter than its scan chunk)."""
    jc, tc = configs()
    seq, gt = _scenario()
    boot = TSystem(tc, device="cpu")
    i0 = 0
    while boot.carry is None:
        boot.track(seq[i0], i0)
        i0 += 1
    d = convert.carry_to_numpy(boot.carry)
    cur = (boot.cur.n_kf, boot.cur.n_mp, boot.cur.n_ml)

    port = TSystem(tc, device="cpu")
    port.carry = convert.carry_from_numpy(d, "cpu")
    port.map, port.cur, port.state = port.carry.state, TCursors(*cur), TState.OK
    port.last_T = np.asarray(d["T_last"], np.float32)
    out_t = _result(port, *port.track_sequence(seq[i0:], i0)[:2], i0, gt)

    ref = JSystem(jc)
    assert len(seq) - i0 < ref.SCAN_CHUNK
    ref.carry = jax_carry(d)
    ref.map, ref.cur = ref.carry.state, JCursors(*cur)
    ref.state = type(ref.state).OK
    ref.last_T = np.asarray(d["T_last"], np.float32)
    out_j = _result(ref, *ref.track_sequence(seq[i0:], i0)[:2], i0, gt)
    return out_j, out_t


def test_slice_blackout_and_teleport():
    """Noise frames are lost in both; the first teleport frame is lost to
    tracking and recovered by BoW + PnP (the reference-keyframe rung
    fails there) in both; the rest of the teleport tracks again."""
    ref, out = _slice_runs()
    i0 = out["i0"]
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    noise = np.arange(N_NORMAL, N_NORMAL + 3) - i0
    assert not out["ok"][noise].any()
    assert out["ok"][noise[-1] + 1:].all() and out["ok"][:noise[0]].all()
    c = out["counters"]
    assert c["reloc_attempts"] == 4 and c["reloc_success"] == 1
    assert c.get("reloc_ref_kf", 0) == ref["counters"].get("reloc_ref_kf", 0) == 0
    assert c["frames_lost"] == ref["counters"]["frames_lost"] == 4
    np.testing.assert_allclose(out["T"][out["ok"]], ref["T"][ref["ok"]], atol=1e-3)
    assert ref["ate"] < 0.08 and out["ate"] < 0.08
