"""Loop-closing parity: the port's Sim(3) maps, Sim(3) RANSAC (kernel 16),
the Sim(3) pair refinement (kernel 17), the essential-graph optimization
(kernel 18), the covisibility matrix, detect / verify / correct, global BA
(kernel 12 at the tiled 16-keyframe shape) and the system's loop reaction
against the JAX reference, on the same numpy inputs.

The map is the reference's own synthetic loop (tests/test_loop_closing.py
`build_loop_map`: 24 keyframes on a circle, drift from keyframe 6, the
second half observing cloned landmarks) at the full default capacities.
One JAX run of the system's reaction `_run_loop_closing(23)` (after
detect at 21 and 22, consistency threshold 2) is recorded method by
method; the whole-slice item runs the port's reaction from the same
state and holds its verify and correct calls, and then its end, to the
recorded ones. Detect and global BA have references of their own, so no
item waits on another's. The small checks share two items (the Sim(3)
maps with the three kernels' functions; the covisibility matrix with
detect), each check a function of its own that a failure's traceback
names: pytest-xdist's `--dist load` hands out chunks whose sizes follow
the number of items collected, and past 230 items the suite's two
longest reference tests land on one worker, which runs the whole suite
past its time limit.

Tolerances and why:
- Sim(3) exp / log / inverse / apply within 1e-5 (float32; sin / cos / exp / log
  of two libraries differ in the last bit); the pose-graph residual's
  forward-mode Jacobians within 2e-5 of jax.jacfwd's (the same chain
  rule, rounded in another order);
- Sim(3) RANSAC: per hypothesis s, R and t within 1e-4 (float32
  eigenvectors of two LAPACK builds), counts equal, the same chosen
  hypothesis and `success`;
- the pair refinement: S12 within 1e-4, inlier masks and counts equal;
- the pose graph: S within 1e-4 on every vertex (25 damped LM steps of
  float32 dense solves);
- the covisibility matrix exactly equal (integer counts);
- detect: scores within 1e-6 of the reference's numpy sums (kernel 14
  sums in its own order), no score within 1e-6 of a cut, the same
  candidate lists;
- verify: the same number of pool matches, S within 1e-4;
- correct: poses within 1e-4, landmarks within 1e-4 (a landmark moves
  by its reference keyframe's correction), mp_valid and kf_kp_mp equal
  (the fuse's integer decisions);
- global BA (on the map with its landmarks perturbed, as
  tests/test_global_ba.py does): poses within 1e-3 and landmarks within
  1e-3 (local BA's own bound, tests/test_torch_local_mapping.py), edge
  tables equal;
- the slice: the same counters, poses within 1e-3, mp_valid equal,
  T_last within 1e-3, velocity I.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.models import loop_closing as jlc
from structure_slam_pointline_tpu.models import tracking as jtrk
from structure_slam_pointline_tpu.models.system import SLAMSystem as JSystem
from structure_slam_pointline_tpu.optim import global_ba as jgba
from structure_slam_pointline_tpu.optim import pose_graph as jpg
from structure_slam_pointline_tpu.optim import sim3_solver as jsim3
from structure_slam_pointline_tpu.utils import lie as jlie
from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu_torch import config as tcfg_mod
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import loop_closing as tlc
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem as TSystem
from structure_slam_pointline_tpu_torch.optim import global_ba as tgba
from structure_slam_pointline_tpu_torch.optim import pose_graph as tpg
from structure_slam_pointline_tpu_torch.optim import sim3_solver as tsim3
from structure_slam_pointline_tpu_torch.utils import lie as tlie
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics
from structure_slam_pointline_tpu_torch.world import map_store as tms

from tests.test_loop_closing import CFG as JCFG
from tests.test_loop_closing import INTR as JINTR
from tests.test_loop_closing import build_loop_map
from torch_port_helpers import disk_cached, to_numpy_dict

TCFG = tcfg_mod.SLAMConfig(camera=tcfg_mod.CameraConfig(fy=480.0))
TINTR = Intrinsics.from_config(TCFG.camera)
CPU = torch.device("cpu")
LOOP_K = 23
# the reference's Sim(3) maps compiled once: op-by-op they cost seconds
_jexp = jax.jit(jlie.sim3_exp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tstate(d):
    return convert.map_state_from_numpy(d, CPU)


def _snapshot(state):
    """A port MapState as numpy copies (later steps may write in place)."""
    return {k: np.array(v) for k, v in convert.map_state_to_numpy(state).items()}


def _jstate(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


# the two heaviest items first: pytest-xdist hands items out in file order

def test_run_loop_closing_slice():
    """The system's reaction as a whole, `_run_loop_closing(23)` after
    detect at 21 and 22: detect, verify, correct, global BA at 64
    keyframes and the carry update, from the carried-in map, carry and
    loop-closer state. The reaction's own verify and correct calls are
    held to the reference's recorded ones on the way (their inputs are the
    reference's: the same map, candidate and generator state)."""
    m, rec = loop_map(), jax_reaction()
    n_kf = m["n_kf"]
    slam = TSystem(TCFG, device="cpu")
    slam.carry = convert.carry_from_numpy(_carry_dict(m["state"], n_kf), CPU)
    slam.map = slam.carry.state
    slam.sync_cursors()
    lc = slam._get_loop_closer()
    lc.consistency_th = 2
    for k in (21, 22):
        lc.detect(slam.map, n_kf, k)
    got = {}
    verify, correct = lc.verify, lc.correct

    def record_verify(state, k, cand):
        got["verify"] = verify(state, k, cand)
        got["rng_after_verify"] = convert.loop_closer_state(lc)["rng_state"]
        return got["verify"]

    def record_correct(state, n, k, cand, S):
        got["correct_in"] = (k, cand, _snapshot(state))
        out = correct(state, n, k, cand, S)
        got["correct"] = _snapshot(out)
        return out

    lc.verify, lc.correct = record_verify, record_correct
    slam._run_loop_closing(LOOP_K)
    c = dict(slam.metrics.counters)
    ref_c = rec["counters"]
    assert {k: c.get(k, 0) for k in ref_c} == ref_c and ref_c.get("loop_corrected") == 1

    # verify: the same pool matches, S within 1e-4, the generator
    # advanced as the reference's
    out = got["verify"]
    assert out is not None and rec["verify_out"] is not None
    assert (LOOP_K, rec["verify_in"]["cand"]) == (rec["verify_in"]["k"],
                                                  rec["correct_in"]["cand"])
    assert out[1] == rec["verify_out"][1]
    np.testing.assert_allclose(out[0], rec["verify_out"][0], atol=1e-4, rtol=0)
    assert got["rng_after_verify"] == rec["correct_in"]["lc"]["rng_state"]

    # correct: from the reference's state, poses and landmarks within 1e-4,
    # the fuse's integer decisions equal
    k, cand, st_in = got["correct_in"]
    assert (k, cand) == (rec["correct_in"]["k"], rec["correct_in"]["cand"])
    for f, v in rec["correct_in"]["state"].items():
        np.testing.assert_array_equal(st_in[f], v, err_msg=f)
    ref, st = rec["correct_out"], got["correct"]
    for f in ("kf_T_cw", "mp_xyz", "ml_endpoints"):
        np.testing.assert_allclose(st[f], ref[f], atol=1e-4, rtol=0, err_msg=f)
    np.testing.assert_array_equal(st["mp_valid"], ref["mp_valid"])
    np.testing.assert_array_equal(st["kf_kp_mp"], ref["kf_kp_mp"])
    assert ref["mp_valid"].sum() < st_in["mp_valid"].sum() - 20   # the fuse merged
    assert len(lc.loop_edges) == 1 and lc.n_corrections == 1

    # the reaction's end: global BA and the carry update
    ref = rec["carry"]
    np.testing.assert_allclose(slam.map.kf_T_cw.numpy(), ref["state"]["kf_T_cw"], atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(slam.map.mp_valid.numpy(), ref["state"]["mp_valid"])
    np.testing.assert_allclose(slam.carry.T_last.numpy(), ref["T_last"], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(slam.carry.velocity.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(slam.last_T, ref["T_last"], atol=1e-3, rtol=0)
    assert convert.loop_closer_state(lc)["loop_edges"][0][:2] == \
        tuple(rec["lc_after"]["loop_edges"][0][:2])


def _perturbed_map():
    """The loop map with its landmarks moved by N(0, 0.03) (seed 0), so
    that BA has residuals to remove (tests/test_global_ba.py:34-39)."""
    st = dict(loop_map()["state"])
    g = np.random.default_rng(0)
    st["mp_xyz"] = st["mp_xyz"] + g.normal(0, 0.03, st["mp_xyz"].shape).astype(np.float32)
    return st


@disk_cached
def jax_gba16():
    out = jgba.global_bundle_adjust(_jstate(_perturbed_map()), loop_map()["n_kf"], JINTR, JCFG,
                                    max_kf=16)
    return to_numpy_dict(out)


def test_global_ba_tiled_matches():
    """max_kf = 16 over 24 keyframes: two tiles (the second anchored by an
    8-keyframe frontier), two sweeps."""
    st = _perturbed_map()
    ref = jax_gba16()
    out = tgba.global_bundle_adjust(_tstate(st), loop_map()["n_kf"], TINTR, TCFG, max_kf=16)
    assert np.abs(ref["mp_xyz"] - st["mp_xyz"]).max() > 1e-2
    np.testing.assert_allclose(out.kf_T_cw.numpy(), ref["kf_T_cw"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(out.mp_xyz.numpy(), ref["mp_xyz"], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(out.kf_kp_mp.numpy(), ref["kf_kp_mp"])


# ---------------------------------------------------------------------------
# Sim(3) maps and the three kernels' functions on small inputs
# ---------------------------------------------------------------------------

def _check_sim3_exp_log_inverse(branch):
    scale = {"generic": (0.4, 0.3), "small_sigma": (0.4, 1e-7), "small_theta": (1e-6, 0.3),
             "both_small": (1e-6, 1e-7)}[branch]
    g = np.random.default_rng(1)
    xi = np.concatenate([g.normal(0, scale[0], (64, 3)), g.normal(0, 0.5, (64, 3)),
                         g.normal(0, scale[1], (64, 1))], 1).astype(np.float32)
    S_j = np.asarray(_jexp(jnp.asarray(xi)))
    np.testing.assert_allclose(tlie.sim3_exp(_t(xi)).numpy(), S_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlie.sim3_log(_t(S_j)).numpy(),
                               np.asarray(jax.jit(jlie.sim3_log)(jnp.asarray(S_j))), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tlie.sim3_inverse(_t(S_j)).numpy(),
                               np.asarray(jax.jit(jlie.sim3_inverse)(jnp.asarray(S_j))),
                               atol=1e-5, rtol=0)
    X = g.normal(0, 2, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(tlie.sim3_apply(_t(S_j), _t(X)).numpy(),
                               np.asarray(jax.jit(jlie.sim3_apply)(jnp.asarray(S_j),
                                                                   jnp.asarray(X))),
                               atol=1e-5, rtol=0)


def _check_pose_graph_jacobians():
    g = np.random.default_rng(2)
    E = 8
    draw = lambda s: np.asarray(_jexp(jnp.asarray(  # noqa: E731
        g.normal(0, s, (E, 7)).astype(np.float32))))
    S_i, S_j = draw(0.5), draw(0.5)
    S_m = (S_j @ np.linalg.inv(S_i) @ draw(0.01)).astype(np.float32)
    S_m[0] = S_j[0] @ np.linalg.inv(S_i[0])          # a near-perfect edge too

    def one(a, b, m):
        def r_of(x, y):
            return jpg._edge_residual(jlie.sim3_exp(x) @ a, jlie.sim3_exp(y) @ b, m)
        z = jnp.zeros(7)
        return r_of(z, z), jax.jacfwd(r_of, 0)(z, z), jax.jacfwd(r_of, 1)(z, z)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(S_i), jnp.asarray(S_j), jnp.asarray(S_m))
    prob = tpg.PoseGraphProblem(
        S_cw=_t(np.concatenate([S_i, S_j])), kf_valid=torch.ones(2 * E, dtype=torch.bool),
        kf_fixed=torch.zeros(2 * E, dtype=torch.bool),
        edge_i=torch.arange(E, dtype=torch.int32), edge_j=torch.arange(E, 2 * E, dtype=torch.int32),
        edge_Sji=_t(S_m), edge_valid=torch.ones(E, dtype=torch.bool), edge_weight=torch.ones(E))
    out = tpg.edge_jacobians(prob.S_cw, prob)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5, rtol=0)


def _sim3_outlier_set():
    """tests/test_sim3_posegraph.py:35-54: 80 pairs, 20 outliers, 64 sets."""
    g = np.random.default_rng(2)
    n = 80
    p2 = np.stack([g.uniform(-2, 2, n), g.uniform(-2, 2, n), g.uniform(3, 7, n)],
                  1).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.1, 0.08])))
    p1 = 1.2 * p2 @ R_gt.T + np.array([0.3, 0.1, -0.4], np.float32)
    p1[:20] += g.uniform(1, 3, (20, 3)) * g.choice([-1, 1], (20, 3))
    sets = np.stack([g.choice(np.arange(20, n), 3, replace=False) for _ in range(64)])
    # a few sets with outliers in them, so the counts spread
    sets[::8, 0] = np.arange(8)
    return p1.astype(np.float32), p2, sets


def _check_ransac_sim3():
    p1, p2, sets = _sim3_outlier_set()
    mask = np.ones(len(p1), bool)
    mask[5] = False
    s_j, R_j, t_j = jsim3.horn_sim3(jnp.asarray(p1[sets]), jnp.asarray(p2[sets]))
    rj = jsim3.ransac_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                           jnp.asarray(sets), JINTR)
    rt = tsim3.ransac_sim3(_t(p1), _t(p2), _t(mask), _t(sets), TINTR)
    np.testing.assert_allclose(rt.scale.numpy(), np.asarray(s_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.hyp[..., :3].numpy(), np.asarray(R_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(rt.hyp[..., 3].numpy(), np.asarray(t_j), atol=1e-4, rtol=0)
    # per-hypothesis counts through the reference's own scoring
    ok_j = []
    for i in range(len(sets)):
        one = jsim3.ransac_sim3(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                                jnp.asarray(sets[i:i + 1]), JINTR)
        ok_j.append(int(one.n_inliers))
    np.testing.assert_array_equal(rt.counts.numpy(), np.asarray(ok_j))
    assert len(set(ok_j)) >= 2
    assert bool(rt.success) == bool(rj.success) and int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.S12.numpy(), np.asarray(rj.S12), atol=1e-4, rtol=0)


def _check_optimize_sim3_pair():
    """tests/test_loop_closing.py:283-340: 120 pairs, 30 planted wrong
    matches, a perturbed initial Sim(3)."""
    g = np.random.default_rng(4)
    N = 120
    X2 = np.stack([g.uniform(-2, 2, N), g.uniform(-1.5, 1.5, N),
                   g.uniform(3, 8, N)], 1).astype(np.float32)
    xi = np.array([0.03, -0.05, 0.02, 0.2, -0.1, 0.15, np.log(1.12)], np.float32)
    S_true = np.asarray(_jexp(jnp.asarray(xi)))
    X1 = X2 @ S_true[:3, :3].T + S_true[:3, 3]

    def proj(p):
        return np.stack([p[:, 0] / p[:, 2] * JINTR.fx + JINTR.cx,
                         p[:, 1] / p[:, 2] * JINTR.fy + JINTR.cy], -1)

    uv1, uv2 = proj(X1).astype(np.float32), proj(X2).astype(np.float32)
    bad = g.choice(N, 30, replace=False)
    perm = np.roll(bad, 7)
    X2_o, uv2_o = X2.copy(), uv2.copy()
    X2_o[bad] = X2[perm]
    uv2_o[bad] = uv2[perm]
    dxi = np.array([0.02, -0.01, 0.015, 0.05, 0.05, -0.05, 0.02], np.float32)
    S0 = (np.asarray(_jexp(jnp.asarray(dxi))) @ S_true).astype(np.float32)
    sig1 = np.ones(N, np.float32)
    sig2 = np.full(N, 1.44, np.float32)
    valid = np.ones(N, bool)
    valid[3] = False
    args = [S0, X1.astype(np.float32), X2_o, uv1, uv2_o, valid, sig1, sig2]
    rj = jpg.optimize_sim3_pair(*[jnp.asarray(a) for a in args], JINTR.fx, JINTR.fy, JINTR.cx,
                                JINTR.cy)
    rt = tpg.optimize_sim3_pair(*[_t(a) for a in args], TINTR.fx, TINTR.fy, TINTR.cx,
                                TINTR.cy)
    np.testing.assert_allclose(rt.S12.numpy(), np.asarray(rj.S12), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) and not rt.inliers.numpy()[bad].any()


def _check_optimize_pose_graph():
    """tests/test_sim3_posegraph.py:56-113: a drifted 20-vertex ring with
    one loop edge (here of weight 5); also a fixed second vertex and an
    invalid chain edge (the same shapes, so the reference's compiled
    program is shared with that test)."""
    K = 20
    g = np.random.default_rng(3)
    S_gt = np.stack([np.asarray(_jexp(jnp.asarray(np.array(
        [0.0, 0.0, 2 * np.pi * k / K, np.cos(2 * np.pi * k / K), np.sin(2 * np.pi * k / K),
         0.0, 0.0], np.float32)))) for k in range(K)])
    S_init = S_gt.copy()
    drift = np.eye(4, dtype=np.float32)
    for k in range(1, K):
        noise = np.asarray(_jexp(jnp.asarray(np.concatenate([
            g.normal(0, 0.01, 3), g.normal(0, 0.02, 3), g.normal(0, 0.01, 1)]).astype(
                np.float32))))
        drift = noise @ drift
        S_init[k] = drift @ S_gt[k]
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    S_meas = np.stack([S_gt[j] @ np.linalg.inv(S_gt[i]) for i, j in zip(ei, ej)])
    E = len(ei)
    d = dict(S_cw=S_init.astype(np.float32), kf_valid=np.ones(K, bool),
             kf_fixed=np.arange(K) < 2, edge_i=np.asarray(ei, np.int32),
             edge_j=np.asarray(ej, np.int32), edge_Sji=S_meas.astype(np.float32),
             edge_valid=np.arange(E) != 9,
             edge_weight=np.where(np.arange(E) == E - 1, 5.0, 1.0).astype(np.float32))
    S_j = np.asarray(jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in d.items()}), n_iters=25,
        lam_init=1e-16))
    S_t = tpg.optimize_pose_graph(convert.pose_graph_problem_from_numpy(d, CPU), n_iters=25,
                                  lam_init=1e-16).numpy()
    assert np.abs(S_j - S_init).max() > 1e-2     # the solve moved the vertices
    np.testing.assert_allclose(S_t, S_j, atol=1e-4, rtol=0)


def test_sim3_maps_and_kernel_functions():
    """The Sim(3) maps on all four branches, the pose-graph residual's
    Jacobians, and the functions of kernels 16, 17 and 18 on the
    reference tests' small problems (one item: see the module docstring)."""
    for branch in ("generic", "small_sigma", "small_theta", "both_small"):
        _check_sim3_exp_log_inverse(branch)
    _check_pose_graph_jacobians()
    _check_ransac_sim3()
    _check_optimize_sim3_pair()
    _check_optimize_pose_graph()


# ---------------------------------------------------------------------------
# the loop closer on the reference's synthetic loop
# ---------------------------------------------------------------------------

@disk_cached
def loop_map():
    state, n_kf, T_gt = build_loop_map()
    return {"state": to_numpy_dict(state), "n_kf": int(n_kf), "T_gt": T_gt}


def _carry_dict(state_np, n_kf):
    """A carry around the loop map: T_last a small step past keyframe 23,
    a non-identity velocity, the local sets of the reference."""
    T_last = state_np["kf_T_cw"][n_kf - 1].copy()
    T_last[:3, 3] += np.array([0.01, 0.0, -0.02], np.float32)
    vel = np.eye(4, dtype=np.float32)
    vel[0, 3] = 0.01
    sets = jtrk.compute_local_sets(_jstate(state_np), n_kf, JCFG.map.local_window_kf,
                                   JCFG.map.local_points_cap, JCFG.map.local_lines_cap)
    return dict(state=state_np, T_last=T_last, velocity=vel, n_kf=n_kf,
                n_mp=int(state_np["mp_valid"].sum()), n_ml=0, frames_since_kf=0,
                inliers_at_kf=0, ok=True, recover_hold=0, local_sets=to_numpy_dict(sets))


@disk_cached
def jax_reaction():
    """The reference system's `_run_loop_closing(23)` after detect at 21
    and 22, each loop-closer call recorded: `verify`'s keyframe and
    candidate, the state and the loop closer's host state before
    `correct`, both calls' outputs; then the reaction's counters and
    carry."""
    from torch_port_helpers import jax_carry

    m = loop_map()
    n_kf = m["n_kf"]
    # the reference tests' own configuration (tests/test_loop_closing.py),
    # so the compiled programs are shared with them; the reaction does not
    # read `enable_loop_closing`
    slam = JSystem(JCFG)
    slam.carry = jax_carry(_carry_dict(m["state"], n_kf))
    slam.map = slam.carry.state
    slam.sync_cursors()
    lc = slam._get_loop_closer()
    lc.consistency_th = 2
    rec = {}
    for k in (21, 22):
        lc.detect(slam.map, n_kf, k)
    orig = {n: getattr(lc, n) for n in ("verify", "correct")}

    def verify(state, k, cand):
        rec["verify_in"] = dict(k=k, cand=cand)
        out = orig["verify"](state, k, cand)
        rec["verify_out"] = None if out is None else (np.asarray(out[0]), int(out[1]))
        return out

    def correct(state, n, k, cand, S):
        rec["correct_in"] = dict(state=to_numpy_dict(state), k=k, cand=cand,
                                 lc=convert.loop_closer_state(lc))
        out = orig["correct"](state, n, k, cand, S)
        rec["correct_out"] = to_numpy_dict(out)
        return out

    lc.verify, lc.correct = verify, correct
    slam._run_loop_closing(LOOP_K)
    rec["counters"] = dict(slam.metrics.counters)
    rec["carry"] = to_numpy_dict(slam.carry)
    rec["lc_after"] = convert.loop_closer_state(lc)
    return rec


def _check_covisibility_matrix():
    st = loop_map()["state"]
    C_j = np.asarray(jms.covisibility_matrix(_jstate(st)))
    C_t = tms.covisibility_matrix(_tstate(st)).numpy()
    assert C_t.dtype == np.int32 and (C_j >= TCFG.map.covis_threshold).sum() > 0
    np.testing.assert_array_equal(C_t, C_j)


@disk_cached
def jax_detect():
    """The reference loop closer's candidate lists at keyframes 21-23
    (consistency threshold 2), its own vocabulary trained on the way."""
    m = loop_map()
    lc = jlc.LoopCloser(JCFG, JINTR)
    lc.consistency_th = 2
    st = _jstate(m["state"])
    return {k: [(c.kf_id, c.score) for c in lc.detect(st, m["n_kf"], k)]
            for k in (21, 22, LOOP_K)}


def _check_detect_candidates():
    """The port's own loop closer, vocabulary trained from scratch, over
    keyframes 21-23: the reference's candidate lists and scores."""
    m, ref = loop_map(), jax_detect()
    state = _tstate(m["state"])
    lc = tlc.LoopCloser(TCFG, TINTR, seed=0)
    lc.consistency_th = 2
    C = tms.covisibility_matrix(state).numpy()
    for k in (21, 22, LOOP_K):
        got = lc.detect(state, m["n_kf"], k)
        # the reference's masks and cuts on its own numpy scores: no
        # eligible score lies within 1e-6 of the floor or of the cut
        raw = 1.0 - 0.5 * np.abs(lc.kf_bows.numpy() - lc.kf_bows.numpy()[k]).sum(1)
        nbs = C[k] >= TCFG.map.covis_threshold
        floor = raw[nbs].min() if nbs.any() else 0.0
        eligible = np.ones(len(raw), bool)
        eligible[nbs] = False
        eligible[max(k - lc.min_gap, 0):] = False
        eligible &= state.kf_valid.numpy()
        assert np.abs(raw[eligible] - floor).min() > 1e-6
        ok = eligible & (raw >= floor)
        if ok.any():
            cut = max(floor, 0.75 * raw[ok].max())
            assert np.abs(raw[ok] - cut).min() > 1e-6 or raw[ok].max() == cut
        assert [c.kf_id for c in got] == [c for c, _ in ref[k]], k
        np.testing.assert_allclose([c.score for c in got], [s for _, s in ref[k]],
                                   atol=1e-6, rtol=0)
    assert ref[LOOP_K], "the reference found no loop candidate at keyframe 23"


def test_covisibility_and_detect():
    """The covisibility matrix exactly, then detect's candidate lists."""
    _check_covisibility_matrix()
    _check_detect_candidates()


def test_track_and_track_sequence_with_loop_closing():
    """`enable_loop_closing=True` runs through both entry points on the
    CPU, from the port's small bootstrap: `track()` hands the newest
    keyframe to the loop closer, `track_sequence()` every keyframe since
    its cursor, as the reference's two paths do."""
    from structure_slam_pointline_tpu_torch.models.system import TrackingState

    from torch_port_helpers import configs, port_boot, sequence

    _, tc = configs()
    boot = port_boot()
    slam = TSystem(tc.replace(enable_loop_closing=True), device="cpu")
    slam.carry = convert.carry_from_numpy(boot["carry"], CPU)
    slam.map = slam.carry.state
    slam.sync_cursors()
    slam.state = TrackingState.OK
    slam.last_T = slam.carry.T_last.numpy()
    calls = []
    run = slam._run_loop_closing

    def record(k=None):
        calls.append((k, slam.cur.n_kf))
        run(k)

    slam._run_loop_closing = record
    imgs, _ = sequence()
    i = boot["i"]
    for j in range(i, i + 3):
        slam.track(imgs[j], j)
    n_track = len(calls)
    _, ok, _, is_kf = slam.track_sequence(imgs[i + 3:i + 9], i + 3)
    assert ok.all() and n_track >= 1 and all(k is None for k, _ in calls[:n_track])
    assert is_kf.any() and len(calls) > n_track
    assert [k for k, _ in calls[n_track:]] == list(range(calls[n_track][0], slam.cur.n_kf))
    assert slam._lc_processed_kf == slam.cur.n_kf
    lc = slam._get_loop_closer()
    assert lc.voc is not None and all(k in lc.kf_words for k in range(2, slam.cur.n_kf))
