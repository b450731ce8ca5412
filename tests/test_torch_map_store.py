"""Map store + state converter parity: the map store's functions of both
packages on the map the port bootstrapped (the same state handed to both
through convert.py), and lossless numpy round trips of MapState (a
JAX-made one, and every field's dtype against JAX's), SLAMCarry /
LocalSets and Frame. (test_torch_line_mapping.py round-trips a JAX
system's own carry and frame, lines included.) All outputs here are
integers or bits and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.world import map_store as tms

from torch_port_helpers import assert_tuple_close, configs, port_boot, to_numpy_dict


def _vote_inputs(P: int):
    g = np.random.default_rng(2)
    rows = g.integers(0, 400, 256)
    matched = g.uniform(size=256) < 0.5
    return rows, matched, g.uniform(size=P) < 0.3


def _maps():
    """(numpy state dict, JAX MapState, port MapState) of the same map."""
    jd = port_boot()["carry"]["state"]
    return (jd, jms.MapState(**{k: jnp.asarray(v) for k, v in jd.items()}),
            convert.map_state_from_numpy(jd, "cpu"))


def test_init_map_matches_reference():
    jc, tc = configs()
    assert_tuple_close(to_numpy_dict(jms.init_map(jc)), tms.init_map(tc, "cpu"))


def test_converter_round_trips():
    jc, tc = configs()
    jinit = to_numpy_dict(jms.init_map(jc))
    back = convert.map_state_to_numpy(convert.map_state_from_numpy(jinit, "cpu"))
    for k, v in jinit.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    boot = port_boot()
    for k, v in boot["carry"]["state"].items():
        assert v.dtype == jinit[k].dtype, k
    cd = boot["carry"]
    cback = convert.carry_to_numpy(convert.carry_from_numpy(cd, "cpu"))
    for k in ("T_last", "velocity", "n_kf", "n_mp", "ok", "inliers_at_kf"):
        np.testing.assert_array_equal(np.asarray(cback[k]), np.asarray(cd[k]), err_msg=k)
    for k, v in cd["state"].items():
        np.testing.assert_array_equal(cback["state"][k], v, err_msg=k)
    for k, v in cd["local_sets"].items():
        np.testing.assert_array_equal(cback["local_sets"][k], v, err_msg=k)
    fd = boot["frame"]
    fback = convert.frame_to_numpy(convert.frame_from_numpy(fd, "cpu"))
    for k, v in fd.items():
        np.testing.assert_array_equal(fback[k], v, err_msg=k)


def test_counts_covisibility_and_obs_bits():
    """Counts, covisibility rows and observer bits on the bootstrapped map;
    then the covisibility matrix and rows on a copy with a repeated id and
    a dead bound landmark."""
    _, j, t = _maps()
    np.testing.assert_array_equal(tms.point_obs_counts(t).numpy(),
                                  np.asarray(jms.point_obs_counts(j)))
    np.testing.assert_array_equal(tms.line_obs_counts(t).numpy(),
                                  np.asarray(jms.line_obs_counts(j)))
    for k in (0, 1, 5):
        np.testing.assert_array_equal(tms.covisibility_weights(t, k).numpy(),
                                      np.asarray(jms.covisibility_weights(j, k)))
    bits = tms.compute_obs_bits(t)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(jms.compute_obs_bits(j)))
    # a repeated id in keyframe 1's row (the matrix counts the landmark
    # once, the row counts both features) and a bound landmark marked dead
    # (both count it, as the reference does)
    jd = port_boot()["carry"]["state"]
    d = {k: v.copy() for k, v in jd.items()}
    bound = np.nonzero(d["kf_kp_mp"][1] >= 0)[0]
    d["kf_kp_mp"][1, bound[1]] = d["kf_kp_mp"][1, bound[0]]
    d["mp_valid"][d["kf_kp_mp"][0][d["kf_kp_mp"][0] >= 0][0]] = False
    j2 = jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    t2 = convert.map_state_from_numpy(d, "cpu")
    np.testing.assert_array_equal(tms.covisibility_matrix(t2).numpy(),
                                  np.asarray(jms.covisibility_matrix(j2)))
    for k in (0, 1):
        np.testing.assert_array_equal(tms.covisibility_weights(t2, k).numpy(),
                                      np.asarray(jms.covisibility_weights(j2, k)))


def test_votes():
    jd, j, t = _maps()
    rows, matched, m = _vote_inputs(jd["mp_valid"].shape[0])
    ref = jms.votes_from_bits(jnp.asarray(jd["mp_obs_bits"][rows]), jnp.asarray(matched),
                              jnp.asarray(jd["kf_valid"]))
    np.testing.assert_array_equal(
        tms.votes_from_bits(t.mp_obs_bits[torch.from_numpy(rows)],
                            torch.from_numpy(matched), t.kf_valid).numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tms.kf_match_votes(t, torch.from_numpy(m)).numpy(),
                                  np.asarray(jms.kf_match_votes(j, jnp.asarray(m))))


def test_obs_bits_add_semantics_with_duplicates():
    """The reference scatter-ADDS 2^(k mod 32): a (keyframe, landmark) pair
    bound twice carries into the next bit (mod 2^32), which an OR would
    not. The plain version keeps the add, as kernel 9 does."""
    jc, tc = configs()
    j0 = jms.init_map(jc)
    K, F = j0.kf_kp_mp.shape
    P = j0.mp_valid.shape[0]
    g = np.random.default_rng(4)
    grid = g.integers(-1, P, (K, F)).astype(np.int32)
    grid[1, :6] = grid[1, 6:12]             # duplicated pairs in keyframe 1
    grid[31 % K, :3] = 5                    # the top bit of a word, three times
    ref = np.asarray(jms.compute_obs_bits(j0._replace(kf_kp_mp=jnp.asarray(grid))))
    t0 = tms.init_map(tc, "cpu")
    out = tms.compute_obs_bits_plain(t0._replace(kf_kp_mp=torch.from_numpy(grid)))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)
    ored = np.zeros_like(ref)
    for k in range(K):
        for e in grid[k][grid[k] >= 0]:
            ored[e, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    assert (ored != ref).any()
