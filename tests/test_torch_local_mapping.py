"""Local mapping + local BA parity, each function alone: the JAX reference
runs the keyframe pipeline by hand on the map its system bootstrapped
(track the next frame, insert it as keyframe 2, triangulate against the
covisible neighbours, fuse, gather the BA window, bundle-adjust, write
back, cull), and every port function gets the JAX function's own input
state (through convert.py) and is held to its output.

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

from torch_port_helpers import assert_tuple_close, configs, jax_system, sequence, to_numpy_dict


def _j(d):
    """A fresh JAX MapState from a numpy dict (the reference's map
    transitions donate their input buffers)."""
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _chain():
    """Stage inputs/outputs of the JAX keyframe pipeline, as numpy."""
    slam, i = jax_system()
    jc, tc = configs()
    imgs, _ = sequence()
    intr = slam.intr
    c = slam.carry
    frame = jpipe.build_frame_jit(jnp.asarray(imgs[i]), intr, jc)
    tr = jtrk.track_step(c.state, frame, c.velocity @ c.T_last, jnp.asarray(0), intr, jc,
                         n_kf=c.n_kf, local_sets=c.local_sets)
    k = int(c.n_kf)
    n_mp = int(c.n_mp)
    S = {"frame": to_numpy_dict(frame), "tr": to_numpy_dict(tr), "k": k, "n_mp": n_mp,
         "frame_id": i}
    S["st0"] = to_numpy_dict(c.state)
    st1 = jlm.insert_keyframe(_j(S["st0"]), jnp.asarray(k), jnp.asarray(i), tr.T_cw, frame,
                              tr.feat_mp, tr.line_ml, jc)
    S["st1"] = to_numpy_dict(st1)
    covis = jms.covisibility_weights(_j(S["st1"]), k)
    S["covis"] = np.asarray(covis)
    top_w, top_n = jax.lax.top_k(covis, 4)
    nbs = jnp.where(top_w > 0, top_n, jnp.maximum(k - 1 - jnp.arange(4), 0))
    S["nbs"] = np.asarray(nbs)
    out = jlm.create_new_points(_j(S["st1"]), jnp.asarray(k), nbs, jnp.asarray(n_mp),
                                intr, jc)
    S["st2"], S["n_new"] = to_numpy_dict(out.state), int(out.n_new)
    st3 = jlm.fuse_projected_points(_j(S["st2"]), jnp.asarray(k), nbs, intr, jc)
    S["st3"] = to_numpy_dict(st3)
    prob, _, local_kf, local_mp, _, drop = jpipe._gather_ba_problem_device(
        _j(S["st3"]), jnp.asarray(k + 1), jc, jnp.asarray(k), covis)
    S["prob"], S["local_kf"], S["local_mp"] = (to_numpy_dict(prob), np.asarray(local_kf),
                                               np.asarray(local_mp))
    ba = jba.bundle_adjust(prob, intr, jc.optim)
    S["ba"] = {f: np.asarray(getattr(ba, f)) for f in ("kf_T_cw", "mp_xyz",
                                                       "edge_inlier", "cost")}
    st4 = jlm.apply_ba_result(_j(S["st3"]), local_kf, local_mp, ba)
    S["st4"] = to_numpy_dict(st4)
    obs = jms.point_obs_counts(_j(S["st4"]))
    st5 = jlm.cull_points(_j(S["st4"]), jnp.asarray(k + 1), jc, obs=obs)
    cw, ci = jax.lax.top_k(covis, 32)
    cand = jnp.where(cw > 0, ci, -1)
    S["cand"] = np.asarray(cand)
    S["st5"] = to_numpy_dict(st5)
    st6 = jlm.cull_keyframes(_j(S["st5"]), jnp.asarray(k + 1), jc, obs=obs, cand_ids=cand)
    S["st6"] = to_numpy_dict(st6)
    return S, jc, tc


def _state(d):
    return convert.map_state_from_numpy(d, "cpu")


def _intr(tc):
    return Intrinsics.from_config(tc.camera)


def test_insert_keyframe():
    S, jc, tc = _chain()
    tr = _t(S["tr"])
    out = tlm.insert_keyframe(_state(S["st0"]), S["k"], S["frame_id"], tr["T_cw"],
                              convert.frame_from_numpy(S["frame"], "cpu"), tr["feat_mp"],
                              tr["line_ml"], tc)
    assert_tuple_close(S["st1"], out, atol=1e-4)


def test_create_new_points():
    S, jc, tc = _chain()
    out = tlm.create_new_points(_state(S["st1"]), S["k"], torch.from_numpy(np.array(S["nbs"])),
                                S["n_mp"], _intr(tc), tc)
    assert int(out.n_new) == S["n_new"] > 10
    assert_tuple_close(S["st2"], out.state, atol=1e-4)


def test_fuse_projected_points():
    S, jc, tc = _chain()
    out = tlm.fuse_projected_points(_state(S["st2"]), S["k"], torch.from_numpy(np.array(S["nbs"])),
                                    _intr(tc), tc)
    assert_tuple_close(S["st3"], out, atol=1e-4)


def test_gather_ba_problem():
    S, jc, tc = _chain()
    st3 = _state(S["st3"])
    prob, local_kf, local_mp, _ = tpipe._gather_ba_problem_device(
        st3, S["k"] + 1, tc, S["k"], torch.from_numpy(np.array(S["covis"])))
    np.testing.assert_array_equal(local_kf.numpy(), S["local_kf"])
    np.testing.assert_array_equal(local_mp.numpy(), S["local_mp"])
    assert_tuple_close(S["prob"], prob, atol=0.0)


def test_bundle_adjust():
    S, jc, tc = _chain()
    prob = tba.BAProblem(**_t(S["prob"]))
    out = tba.bundle_adjust(prob, _intr(tc), tc.optim)
    np.testing.assert_array_equal(out.edge_inlier.numpy(), S["ba"]["edge_inlier"])
    np.testing.assert_allclose(out.kf_T_cw.numpy(), S["ba"]["kf_T_cw"], atol=1e-3)
    np.testing.assert_allclose(out.mp_xyz.numpy(), S["ba"]["mp_xyz"], atol=1e-3)


def test_apply_ba_result_and_culls():
    S, jc, tc = _chain()
    ba = tba.BAResult(**_t(S["ba"]))
    st4 = tlm.apply_ba_result(_state(S["st3"]), torch.from_numpy(np.array(S["local_kf"])),
                              torch.from_numpy(np.array(S["local_mp"])), ba)
    assert_tuple_close(S["st4"], st4, atol=0.0)
    st4 = _state(S["st4"])
    obs = tlm.point_obs_counts(st4)
    st5 = tlm.cull_points(st4, S["k"] + 1, tc, obs=obs)
    assert_tuple_close(S["st5"], st5, atol=0.0)
    st6 = tlm.cull_keyframes(st5, S["k"] + 1, tc, obs=obs,
                             cand_ids=torch.from_numpy(np.array(S["cand"])))
    assert_tuple_close(S["st6"], st6, atol=0.0)
