"""Local mapping + local BA parity, each function alone, on the map the
port bootstrapped (`port_boot`): the next frame is tracked and inserted
as keyframe 2, then triangulated against the covisible neighbours, fused,
the BA window gathered, bundle-adjusted, written back and culled. Each
stage's port function and its JAX counterpart get the same input: the
port's output of the stage before, itself held to JAX in that stage's
test. So every test runs one JAX function, and tests in parallel workers
never wait on one another's reference chain. create_new_points alone
runs on the JAX system's own bootstrap, tracked and inserted by JAX, as
it always has: on the port's bootstrap one low-parallax point (a 5-sweep
float32 Jacobi triangulation) lands 1.2e-4 from JAX's, past this file's
1e-4.

Integer fields (edge grid, validity, slots, cursors, counts) must be
equal; floats within 1e-4 except after the 20-iteration local BA, whose
poses and points are held to 1e-3 (float32 normal equations and a 96x96
dense solve summed in another order, amplified by the solve's
conditioning).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from structure_slam_pointline_tpu.models import local_mapping as jlm
from structure_slam_pointline_tpu.models import pipeline as jpipe
from structure_slam_pointline_tpu.models import tracking as jtrk
from structure_slam_pointline_tpu.optim import local_ba as jba
from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import local_mapping as tlm
from structure_slam_pointline_tpu_torch.models import pipeline as tpipe
from structure_slam_pointline_tpu_torch.optim import local_ba as tba
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.utils.indexing import stable_topk
from structure_slam_pointline_tpu_torch.world import map_store as tms

from torch_port_helpers import (assert_tuple_close, configs, jax_intr, jax_tuple, port_boot,
                                sequence, to_numpy_dict)


def _j(d):
    """A fresh JAX MapState from a numpy dict (the reference's map
    transitions donate their input buffers)."""
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _state(d):
    return convert.map_state_from_numpy(d, "cpu")


def _np(st):
    return convert.map_state_to_numpy(st)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Every stage's input, as numpy: the bootstrapped map, the next frame
    and its tracking result, then the port's stage outputs."""
    boot = port_boot()
    _, tc = configs()
    intr = Intrinsics.from_config(tc.camera)
    c = boot["carry"]
    k, n_mp, i = int(c["n_kf"]), int(c["n_mp"]), boot["i"]
    S = {"k": k, "n_mp": n_mp, "frame_id": i, "frame": boot["frame"], "tr": boot["tr"],
         "st0": c["state"]}
    tr = {f: torch.from_numpy(np.array(v)) for f, v in boot["tr"].items()}
    st1 = tlm.insert_keyframe(_state(S["st0"]), k, i, tr["T_cw"],
                              convert.frame_from_numpy(S["frame"], "cpu"), tr["feat_mp"],
                              tr["line_ml"], tc)
    covis = tms.covisibility_weights(st1, k)
    top_w, top_n = stable_topk(covis, 4)
    nbs = torch.where(top_w > 0, top_n, torch.clamp(k - 1 - torch.arange(4), min=0))
    st2 = tlm.create_new_points(st1, k, nbs, n_mp, intr, tc).state
    st3 = tlm.fuse_projected_points(st2, k, nbs, intr, tc)
    prob, _, local_kf, local_mp, _, _ = tpipe._gather_ba_problem_device(st3, k + 1, tc, k, covis)
    ba = tba.bundle_adjust(prob, intr, tc.optim)
    cw, ci = stable_topk(covis, 32)
    S.update(st1=_np(st1), covis=covis.numpy(), nbs=nbs.numpy(), st2=_np(st2), st3=_np(st3),
             prob={f: v.numpy() for f, v in prob._asdict().items()},
             local_kf=local_kf.numpy(), local_mp=local_mp.numpy(),
             ba={f: getattr(ba, f).numpy() for f in ("kf_T_cw", "mp_xyz", "edge_inlier",
                                                     "cost")},
             cand=torch.where(cw > 0, ci, -1).numpy())
    return S


def _setup():
    jc, tc = configs()
    return _inputs(), jc, tc, jax_intr(jc), Intrinsics.from_config(tc.camera)


def test_insert_keyframe():
    S, jc, tc, jintr, intr = _setup()
    jtr = jax_tuple(jtrk.TrackResult, S["tr"])
    ref = jlm.insert_keyframe(_j(S["st0"]), jnp.asarray(S["k"]), jnp.asarray(S["frame_id"]),
                              jtr.T_cw, jax_tuple(jtrk.Frame, S["frame"]), jtr.feat_mp,
                              jtr.line_ml, jc)
    tr = {f: torch.from_numpy(np.array(v)) for f, v in S["tr"].items()}
    out = tlm.insert_keyframe(_state(S["st0"]), S["k"], S["frame_id"], tr["T_cw"],
                              convert.frame_from_numpy(S["frame"], "cpu"), tr["feat_mp"],
                              tr["line_ml"], tc)
    assert_tuple_close(to_numpy_dict(ref), out, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_keyframe_input():
    """The JAX system bootstrapped on the small sequence, its next frame
    built, tracked and inserted as a keyframe by JAX, and the covisible
    neighbours, as numpy (the input of create_new_points)."""
    from structure_slam_pointline_tpu.models.system import SLAMSystem

    jc, _ = configs()
    imgs, _ = sequence()
    slam = SLAMSystem(jc)
    i = 0
    while slam.carry is None:
        slam.track(imgs[i], i)
        i += 1
    c, intr = slam.carry, slam.intr
    frame = jpipe.build_frame_jit(jnp.asarray(imgs[i]), intr, jc)
    tr = jtrk.track_step(c.state, frame, c.velocity @ c.T_last, jnp.asarray(0), intr, jc,
                         n_kf=c.n_kf, local_sets=c.local_sets)
    k = int(c.n_kf)
    st1 = jlm.insert_keyframe(c.state, jnp.asarray(k), jnp.asarray(i), tr.T_cw, frame,
                              tr.feat_mp, tr.line_ml, jc)
    covis = jms.covisibility_weights(st1, k)
    top_w, top_n = jax.lax.top_k(covis, 4)
    nbs = jnp.where(top_w > 0, top_n, jnp.maximum(k - 1 - jnp.arange(4), 0))
    return {"st1": to_numpy_dict(st1), "k": k, "nbs": np.asarray(nbs), "n_mp": int(c.n_mp)}


def test_create_new_points():
    _, jc, tc, jintr, intr = _setup()
    S = _jax_keyframe_input()
    ref = jlm.create_new_points(_j(S["st1"]), jnp.asarray(S["k"]), jnp.asarray(S["nbs"]),
                                jnp.asarray(S["n_mp"]), jintr, jc)
    out = tlm.create_new_points(_state(S["st1"]), S["k"], torch.from_numpy(S["nbs"]),
                                S["n_mp"], intr, tc)
    assert int(out.n_new) == int(ref.n_new) > 10
    assert_tuple_close(to_numpy_dict(ref.state), out.state, atol=1e-4)


def _seeded_duplicates(S, tc, intr):
    """The fuse's input with duplicates seeded as chip_smoke.seed_duplicates
    seeds them (copies of live landmarks in free slots), here exact copies
    bound in keyframe rows so that the point fuse meets them. A landmark X
    that the new keyframe matches in directions 0 and 1 is replaced there
    by its copy X1 and in direction 0's target by its copy X2 (X also
    bound in a spare row, so it stays the most observed): direction 0
    merges X2 into X1, direction 1 X1 into X, a chain X2 -> X1 -> X. Two
    other landmarks C1, C2 matched in direction 0 (rows r1 < r2) are
    replaced in its target by one copy Y: the direction writes Y's
    redirect twice, and the last write (C2) wins. Returns (state dict,
    (X, X1, X2), (Y, C1, C2), (r1, r2))."""
    d = {key: v.copy() for key, v in S["st2"].items()}
    k, tab = S["k"], d["kf_kp_mp"]
    st = _state(S["st2"])
    a, b, present = tlm._fuse_directions(st, k, torch.from_numpy(S["nbs"]))
    m = tlm.fuse_match_points_plain(st, a, b, present, intr, tc)
    v, idx = m.valid.numpy(), m.idx.numpy()
    obs = tms.point_obs_counts(st).numpy()
    b0, b1 = int(b[0]), int(b[1])

    def co(di, bi, r):   # direction di matches row r to its own landmark in bi
        return v[di, r] and tab[k, r] >= 0 and tab[bi, idx[di, r]] == tab[k, r]

    rows = [r for r in range(tab.shape[1]) if co(0, b0, r) and obs[tab[k, r]] == 3]
    chain = next(r for r in rows if co(1, b1, r))
    r1, r2 = [r for r in rows if r != chain][:2]
    P = d["mp_valid"].shape[0]
    X, X1, X2, Y = tab[k, chain], P - 1, P - 2, P - 3
    C1, C2 = tab[k, r1], tab[k, r2]
    for dst, src in ((X1, X), (X2, X), (Y, C1)):
        for key in [key for key in d if key.startswith("mp_")]:
            d[key][dst] = d[key][src]
    tab[k, chain], tab[b0, idx[0, chain]] = X1, X2
    tab[-1, 0] = X
    tab[b0, idx[0, r1]] = tab[b0, idx[0, r2]] = Y
    return d, (X, X1, X2), (Y, C1, C2), (r1, r2)


def test_fuse_projected_points():
    """The port against JAX on the fuse's input, then on a copy with
    seeded duplicates whose merges chain and collide (_seeded_duplicates):
    there the edge grid and the validity equal."""
    S, jc, tc, jintr, intr = _setup()
    ref = jlm.fuse_projected_points(_j(S["st2"]), jnp.asarray(S["k"]), jnp.asarray(S["nbs"]),
                                    jintr, jc)
    out = tlm.fuse_projected_points(_state(S["st2"]), S["k"], torch.from_numpy(S["nbs"]),
                                    intr, tc)
    assert_tuple_close(to_numpy_dict(ref), out, atol=1e-4)
    d, (X, X1, X2), (Y, C1, C2), (r1, r2) = _seeded_duplicates(S, tc, intr)
    st = _state(d)
    nbs = torch.from_numpy(S["nbs"])
    a, b, present = tlm._fuse_directions(st, S["k"], nbs)
    m = tlm.fuse_match_points_plain(st, a, b, present, intr, tc)
    _, _, redirect = tlm.fuse_merge_plain(st.kf_kp_mp, st.mp_valid, tms.point_obs_counts(st),
                                          a, b, m.idx, m.valid)
    assert (int(redirect[X2]), int(redirect[X1])) == (X1, X)         # the chain
    assert bool(m.valid[0, r1]) and bool(m.valid[0, r2]) and C1 != C2
    assert int(redirect[Y]) == C2                                     # the last write
    ref = jlm.fuse_projected_points(_j(d), jnp.asarray(S["k"]), jnp.asarray(S["nbs"]), jintr,
                                    jc)
    out = tlm.fuse_projected_points(st, S["k"], nbs, intr, tc)
    np.testing.assert_array_equal(out.kf_kp_mp.numpy(), np.asarray(ref.kf_kp_mp))
    np.testing.assert_array_equal(out.mp_valid.numpy(), np.asarray(ref.mp_valid))
    assert not out.mp_valid[[X1, X2, Y]].any()


def test_gather_ba_problem():
    S, jc, tc, jintr, intr = _setup()
    prob_r, _, local_kf_r, local_mp_r, _, _ = jpipe._gather_ba_problem_device(
        _j(S["st3"]), jnp.asarray(S["k"] + 1), jc, jnp.asarray(S["k"]), jnp.asarray(S["covis"]))
    prob, lines, local_kf, local_mp, local_ln, _ = tpipe._gather_ba_problem_device(
        _state(S["st3"]), S["k"] + 1, tc, S["k"], torch.from_numpy(S["covis"]))
    assert lines is None and local_ln is None
    np.testing.assert_array_equal(local_kf.numpy(), np.asarray(local_kf_r))
    np.testing.assert_array_equal(local_mp.numpy(), np.asarray(local_mp_r))
    assert_tuple_close(to_numpy_dict(prob_r), prob, atol=0.0)


def test_bundle_adjust():
    S, jc, tc, jintr, intr = _setup()
    ref = jba.bundle_adjust(jax_tuple(jba.BAProblem, S["prob"]), jintr, jc.optim)
    out = tba.bundle_adjust(tba.BAProblem(**{f: torch.from_numpy(v)
                                             for f, v in S["prob"].items()}), intr, tc.optim)
    np.testing.assert_array_equal(out.edge_inlier.numpy(), np.asarray(ref.edge_inlier))
    np.testing.assert_allclose(out.kf_T_cw.numpy(), np.asarray(ref.kf_T_cw), atol=1e-3)
    np.testing.assert_allclose(out.mp_xyz.numpy(), np.asarray(ref.mp_xyz), atol=1e-3)


def test_apply_ba_result_and_culls():
    S, jc, tc, jintr, intr = _setup()
    k1 = S["k"] + 1
    st4_r = to_numpy_dict(jlm.apply_ba_result(_j(S["st3"]), jnp.asarray(S["local_kf"]),
                                              jnp.asarray(S["local_mp"]),
                                              jax_tuple(jba.BAResult, S["ba"])))
    obs_r = jms.point_obs_counts(_j(st4_r))
    st5_r = to_numpy_dict(jlm.cull_points(_j(st4_r), jnp.asarray(k1), jc, obs=obs_r))
    st6_r = to_numpy_dict(jlm.cull_keyframes(_j(st5_r), jnp.asarray(k1), jc, obs=obs_r,
                                             cand_ids=jnp.asarray(S["cand"])))
    ba = tba.BAResult(**{f: torch.from_numpy(v) for f, v in S["ba"].items()})
    st4 = tlm.apply_ba_result(_state(S["st3"]), torch.from_numpy(S["local_kf"]),
                              torch.from_numpy(S["local_mp"]), ba)
    assert_tuple_close(st4_r, st4, atol=0.0)
    obs = tlm.point_obs_counts(st4)
    st5 = tlm.cull_points(st4, k1, tc, obs=obs)
    assert_tuple_close(st5_r, st5, atol=0.0)
    st6 = tlm.cull_keyframes(st5, k1, tc, obs=obs, cand_ids=torch.from_numpy(S["cand"]))
    assert_tuple_close(st6_r, st6, atol=0.0)


def _padded_ba_problem():
    """A synthetic BA problem with every kind of padding the windows carry:
    8 camera slots on a 0.6 m baseline looking at 64 points and 8 lines
    (slots 6 and 7 invalid, slot 6 still holding point and line edges; slot
    0 fixed), 10 valid points and one valid line without an edge, 8
    invalid points observed from slot 1, one invalid line; 0.5 px noise,
    and poses and landmarks moved off their true values."""
    from structure_slam_pointline_tpu_torch.utils import lie

    g = np.random.default_rng(7)
    _, tc = configs()
    intr = Intrinsics.from_config(tc.camera)
    KL, PL, LL = 8, 64, 8
    Xw = np.stack([g.uniform(-1.2, 1.2, PL), g.uniform(-0.8, 0.8, PL),
                   g.uniform(3.0, 6.0, PL)], 1).astype(np.float32)
    Ls = np.stack([g.uniform(-1, 1, LL), g.uniform(-0.6, -0.2, LL), g.uniform(3.5, 5, LL)], 1)
    Le = Ls + np.stack([g.uniform(-0.5, 0.5, LL), g.uniform(0.5, 0.9, LL),
                        g.uniform(-0.3, 0.3, LL)], 1)
    T = np.tile(np.eye(4, dtype=np.float32), (KL, 1, 1))
    T[:, 0, 3] = np.linspace(-0.3, 0.3, KL)

    def proj(k, X):
        c = X @ T[k, :3, :3].T + T[k, :3, 3]
        return np.stack([intr.fx * c[:, 0] / c[:, 2] + intr.cx,
                         intr.fy * c[:, 1] / c[:, 2] + intr.cy], 1)

    seen = np.r_[0:48, 56:64]                       # 48-55: valid, no edge
    obs_uv = np.zeros((KL, PL, 2), np.float32)
    edge_mp = np.full((KL, PL), -1, np.int32)
    lines_seen = np.r_[0:6, 7]                      # 6: valid, no edge
    obs_l = np.zeros((KL, LL, 3), np.float32)
    edge_ln = np.full((KL, LL), -1, np.int32)
    for k in range(KL - 1):                         # slot 7: no edge at all
        pts = seen if k == 1 else seen[:48]
        obs_uv[k, :len(pts)] = proj(k, Xw[pts]) + g.normal(0, 0.5, (len(pts), 2))
        edge_mp[k, :len(pts)] = pts
        a, b = proj(k, Ls[lines_seen]), proj(k, Le[lines_seen])
        a, b = (np.concatenate([p + g.normal(0, 0.5, p.shape), np.ones((len(p), 1))], 1)
                for p in (a, b))
        ln = np.cross(a, b)
        obs_l[k, :len(lines_seen)] = ln / np.hypot(ln[:, :1], ln[:, 1:2])
        edge_ln[k, :len(lines_seen)] = lines_seen
    xi = np.concatenate([g.normal(0, 0.01, (KL, 3)), g.normal(0, 0.03, (KL, 3))], 1)
    T0 = (lie.se3_exp(torch.from_numpy(xi.astype(np.float32))).numpy() @ T).astype(np.float32)
    T0[0] = T[0]
    kf_valid = np.arange(KL) < 6
    prob = tba.BAProblem(
        kf_T_cw=torch.from_numpy(T0), kf_free=torch.from_numpy(np.arange(KL) > 0),
        kf_valid=torch.from_numpy(kf_valid), obs_uv=torch.from_numpy(obs_uv),
        obs_sigma2=torch.ones(KL, PL), edge_mp=torch.from_numpy(edge_mp),
        edge_valid=torch.from_numpy(edge_mp >= 0),
        mp_xyz=torch.from_numpy((Xw + g.normal(0, 0.05, Xw.shape)).astype(np.float32)),
        mp_valid=torch.from_numpy(np.arange(PL) < 56))
    move = lambda X: torch.from_numpy((X + g.normal(0, 0.05, X.shape)).astype(np.float32))  # noqa: E731
    lines = tba.BALineProblem(
        ln_start=move(Ls), ln_end=move(Le), ln_valid=torch.from_numpy(np.arange(LL) < 7),
        obs_l=torch.from_numpy(obs_l), obs_sigma2=torch.ones(KL, LL),
        edge_ln=torch.from_numpy(edge_ln), edge_valid=torch.from_numpy(edge_ln >= 0))
    return prob, lines, intr, tc


def test_bundle_adjust_plain_drops_only_padding():
    """`bundle_adjust_plain` solves the problem without its invalid
    keyframes and edgeless landmarks; on a padded problem it must give what
    the dense schedule gives on every row and column (the path it
    replaced): inlier masks equal, poses and points within 1e-5 and line
    endpoints within 5e-5 (the same float32 arithmetic, only the sums'
    blocking over the dropped zeros differs; measured 7e-6 and 1.7e-5: an
    endpoint is held weakly along its line), padding returned unchanged.
    Dropping the invalid slot's line edges instead moves the result by 0.5."""
    prob, lines, intr, tc = _padded_ba_problem()
    for ln in (None, lines):
        out = tba.bundle_adjust_plain(prob, intr, tc.optim, lines=ln)
        ref = tba._bundle_adjust_dense(prob, intr, tc.optim, lines=ln)
        fields = ["kf_T_cw", "mp_xyz"] + (["ln_start", "ln_end"] if ln is not None else [])
        masks = ["edge_inlier"] + (["line_inlier"] if ln is not None else [])
        for f in masks:
            np.testing.assert_array_equal(getattr(out, f).numpy(), getattr(ref, f).numpy(),
                                          err_msg=f)
        for f in fields:
            np.testing.assert_allclose(getattr(out, f).numpy(), getattr(ref, f).numpy(),
                                       atol=5e-5 if f.startswith("ln") else 1e-5, rtol=0,
                                       err_msg=f)
        assert out.edge_inlier[:6, :48].float().mean() > 0.9
        assert not out.edge_inlier[6:].any() and not out.edge_inlier[1, 48:].any()
        assert np.abs(out.kf_T_cw.numpy()[1:6] - prob.kf_T_cw.numpy()[1:6]).max() > 1e-3
        np.testing.assert_array_equal(out.kf_T_cw.numpy()[[0, 6, 7]],
                                      prob.kf_T_cw.numpy()[[0, 6, 7]])
        np.testing.assert_array_equal(out.mp_xyz.numpy()[48:], prob.mp_xyz.numpy()[48:])
        if ln is not None:
            assert out.line_inlier[6, :6].any()     # the invalid slot's line edges count
            np.testing.assert_array_equal(out.ln_start.numpy()[6:], lines.ln_start.numpy()[6:])


def _flip(desc: np.ndarray, n: int, g) -> np.ndarray:
    """A uint32 [8] descriptor with n distinct bits flipped."""
    bits = np.unpackbits(desc.view(np.uint8), bitorder="little")
    bits[g.choice(256, n, replace=False)] ^= 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _fuse3d_both(d, n_kf, kind):
    jc, tc = configs()
    jfn = getattr(jlm, f"fuse_duplicate_{kind}_3d")
    tfn = getattr(tlm, f"fuse_duplicate_{kind}_3d")
    ref = to_numpy_dict(jfn(_j(d), jnp.asarray(n_kf - 1), jnp.asarray(n_kf), jax_intr(jc), jc))
    out = _np(tfn(_state(d), n_kf - 1, n_kf, Intrinsics.from_config(tc.camera), tc))
    for f in ref:
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f"{kind}: {f}")
    return out


def test_fuse_duplicate_3d():
    """`fuse_duplicate_points_3d` / `fuse_duplicate_lines_3d` (no caller in
    either package) on the port's bootstrapped map carried into both
    packages, with duplicates seeded at clear margins from every gate
    (distance within a fifth of the 1% / 2% radius or beyond 3x it;
    descriptors 4-10 bits from the original against th_low 50 / th_high
    100, or 150 bits away; lines 0-3 degrees or 10 degrees off parallel;
    overlap 80% or none): the whole map state equal, the expected merges
    and bindings. The reference's tests/test_fusion.py:63-99 case is
    replayed: two landmarks 4 cm apart at 5 m on repeating structure, the
    same descriptor, over-merge in both."""
    boot = port_boot()
    base = {k: np.array(v) for k, v in boot["carry"]["state"].items()}
    n_mp = int(boot["carry"]["n_mp"])
    n_kf = 4                                 # recent: first seen at keyframe >= 2
    g = np.random.default_rng(21)

    # points: originals first seen at keyframes 0-1, duplicates at 3
    d = {k: v.copy() for k, v in base.items()}
    orig = np.nonzero(d["mp_valid"])[0][::7][:10]
    assert len(orig) == 10 and (d["mp_first_kf"][orig] < 2).all()
    # (offset as a share of the distance, descriptor bits flipped, merges)
    cases = [(0.002, 4, True), (0.001, 10, True), (0.0005, 0, True), (0.002, 6, True),
             (0.03, 0, False), (0.05, 4, False), (0.001, 150, False), (0.002, 120, False)]
    slot = n_mp
    want = {}
    for o, (share, bits, merges) in zip(orig, cases):
        x = d["mp_xyz"][o]
        step = g.normal(size=3)
        d["mp_xyz"][slot] = x + step / np.linalg.norm(step) * share * np.linalg.norm(x)
        d["mp_desc"][slot] = _flip(d["mp_desc"][o], bits, g)
        d["mp_valid"][slot], d["mp_first_kf"][slot] = True, 3
        want[slot] = o if merges else None
        slot += 1
    # a tie: two older copies of orig[8] with the same descriptor distance;
    # the first index wins (jnp.argmin)
    tie = orig[8]
    for s2 in (slot, slot + 1):
        d["mp_xyz"][s2] = d["mp_xyz"][tie] * np.float32(1.0003)
        d["mp_desc"][s2] = d["mp_desc"][tie]
        d["mp_valid"][s2], d["mp_first_kf"][s2] = True, 1
    d["mp_xyz"][slot + 2] = d["mp_xyz"][tie] * np.float32(0.9997)
    d["mp_desc"][slot + 2] = _flip(d["mp_desc"][tie], 3, g)
    d["mp_valid"][slot + 2], d["mp_first_kf"][slot + 2] = True, 3
    d["mp_desc"][tie] = _flip(d["mp_desc"][tie], 40, g)      # farther than the copies
    want[slot + 2] = slot
    # bind every seeded recent point in keyframe 1's free feature slots
    free = np.nonzero(d["kf_kp_mp"][1] < 0)[0]
    for f, s in zip(free, want):
        d["kf_kp_mp"][1, f] = s
    out = _fuse3d_both(d, n_kf, "points")
    for (f, s) in zip(free, want):
        if want[s] is None:
            assert out["mp_valid"][s] and out["kf_kp_mp"][1, f] == s, s
        else:
            assert not out["mp_valid"][s] and out["kf_kp_mp"][1, f] == want[s], s
    assert out["mp_valid"].sum() == d["mp_valid"].sum() - 5

    # lines: originals at keyframe 0, 1 m long, 3-5 m away
    d = {k: v.copy() for k, v in base.items()}
    K, LF = d["kf_line_ml"].shape
    n_orig = 8
    for i in range(n_orig):
        c = np.array([g.uniform(-1, 1), g.uniform(-1, 1), g.uniform(3, 5)], np.float32)
        u = g.normal(size=3)
        u /= np.linalg.norm(u)
        d["ml_endpoints"][i] = np.concatenate([c - 0.5 * u, c + 0.5 * u])
        d["ml_desc"][i] = g.integers(0, 2 ** 32, 8, dtype=np.uint32)
        d["ml_valid"][i], d["ml_first_kf"][i] = True, 0

    def shifted(i, perp_share, along, turn_deg, bits):
        s, e = d["ml_endpoints"][i, :3].astype(np.float64), d["ml_endpoints"][i, 3:]
        u = (e - s) / np.linalg.norm(e - s)
        n = np.cross(u, [0.0, 0.0, 1.0])
        n /= np.linalg.norm(n)
        w = np.cross(u, n)
        a = np.deg2rad(turn_deg)
        u2 = np.cos(a) * u + np.sin(a) * w
        mid = 0.5 * (s + e) + perp_share * np.linalg.norm(0.5 * (s + e)) * n + along * u
        return (np.concatenate([mid - 0.4 * u2, mid + 0.4 * u2]).astype(np.float32),
                _flip(d["ml_desc"][i], bits, g))

    # (original, perpendicular share, along (m), turn (deg), bits, merges)
    lcases = [(0, 0.002, 0.05, 0.0, 10, True), (1, 0.001, -0.1, 3.0, 40, True),
              (2, 0.003, 0.0, 1.0, 0, True), (3, 0.06, 0.0, 0.0, 5, False),
              (4, 0.001, 1.5, 0.0, 5, False), (5, 0.001, 0.0, 10.0, 5, False),
              (6, 0.001, 0.0, 0.0, 150, False)]
    want = {}
    for j, (i, perp, along, turn, bits, merges) in enumerate(lcases):
        s = n_orig + j
        d["ml_endpoints"][s], d["ml_desc"][s] = shifted(i, perp, along, turn, bits)
        d["ml_valid"][s], d["ml_first_kf"][s] = True, 3
        d["kf_line_ml"][1, j] = s
        want[s] = i if merges else None
    out = _fuse3d_both(d, n_kf, "lines")
    for j, (s, w) in enumerate(want.items()):
        assert out["ml_valid"][s] == (w is None), s
        assert out["kf_line_ml"][1, j] == (s if w is None else w), s

    # tests/test_fusion.py:63-99: repeating fronto-parallel structure
    d = {k: v.copy() for k, v in base.items()}
    d["mp_valid"][:] = False
    desc = g.integers(0, 2 ** 32, 8, dtype=np.uint32)
    d["mp_xyz"][0], d["mp_xyz"][1] = [1.00, 1.0, 5.0], [1.04, 1.0, 5.0]
    d["mp_valid"][:2] = True
    d["mp_desc"][0] = d["mp_desc"][1] = desc
    d["mp_first_kf"][0], d["mp_first_kf"][1] = 0, 3
    d["kf_kp_mp"][:] = -1
    d["kf_kp_mp"][0, 5], d["kf_kp_mp"][0, 6], d["kf_kp_mp"][3, 7] = 0, 1, 1
    out = _fuse3d_both(d, 4, "points")
    assert out["mp_valid"][0] and not out["mp_valid"][1]
    assert out["kf_kp_mp"][0, 6] == 0 and out["kf_kp_mp"][3, 7] == 0
