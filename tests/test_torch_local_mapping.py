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


def test_fuse_projected_points():
    S, jc, tc, jintr, intr = _setup()
    ref = jlm.fuse_projected_points(_j(S["st2"]), jnp.asarray(S["k"]), jnp.asarray(S["nbs"]),
                                    jintr, jc)
    out = tlm.fuse_projected_points(_state(S["st2"]), S["k"], torch.from_numpy(S["nbs"]),
                                    intr, tc)
    assert_tuple_close(to_numpy_dict(ref), out, atol=1e-4)


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
