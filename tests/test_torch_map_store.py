"""Map store + state converter parity: the port's MapState functions on a
map the JAX reference bootstrapped (handed over through convert.py), and
lossless numpy round trips of MapState, SLAMCarry / LocalSets and Frame.
All outputs here are integers or bits and must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from structure_slam_pointline_tpu.models import pipeline as jpipe
from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.world import map_store as tms

from torch_port_helpers import assert_tuple_close, configs, jax_system, to_numpy_dict


@functools.lru_cache(maxsize=None)
def _maps():
    slam, _ = jax_system()
    jd = to_numpy_dict(slam.map)
    return slam, jd, convert.map_state_from_numpy(jd, "cpu")


def test_init_map_matches_reference():
    jc, tc = configs()
    assert_tuple_close(to_numpy_dict(jms.init_map(jc)), tms.init_map(tc, "cpu"))


def test_converter_round_trips():
    slam, jd, tstate = _maps()
    back = convert.map_state_to_numpy(tstate)
    for k, v in jd.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    cd = to_numpy_dict(slam.carry)
    carry = convert.carry_from_numpy(cd, "cpu")
    cback = convert.carry_to_numpy(carry)
    for k in ("T_last", "velocity", "n_kf", "n_mp", "ok", "inliers_at_kf"):
        np.testing.assert_array_equal(np.asarray(cback[k]), np.asarray(cd[k]), err_msg=k)
    for k, v in cd["local_sets"].items():
        np.testing.assert_array_equal(cback["local_sets"][k], v, err_msg=k)
    imgs_frame = jax.device_get(jpipe.build_frame_jit(
        jnp.zeros((240, 320), jnp.float32), slam.intr, configs()[0]))
    fd = to_numpy_dict(imgs_frame)
    fback = convert.frame_to_numpy(convert.frame_from_numpy(fd, "cpu"))
    for k, v in fd.items():
        np.testing.assert_array_equal(fback[k], v, err_msg=k)


def test_counts_covisibility_and_obs_bits():
    slam, jd, t = _maps()
    j = slam.map
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


def test_votes():
    slam, jd, t = _maps()
    g = np.random.default_rng(2)
    P = jd["mp_valid"].shape[0]
    rows = g.integers(0, 400, 256)
    matched = g.uniform(size=256) < 0.5
    np.testing.assert_array_equal(
        tms.votes_from_bits(t.mp_obs_bits[torch.from_numpy(rows)],
                            torch.from_numpy(matched), t.kf_valid).numpy(),
        np.asarray(jms.votes_from_bits(jnp.asarray(jd["mp_obs_bits"][rows]),
                                       jnp.asarray(matched), jnp.asarray(jd["kf_valid"]))))
    m = g.uniform(size=P) < 0.3
    np.testing.assert_array_equal(
        tms.kf_match_votes(t, torch.from_numpy(m)).numpy(),
        np.asarray(jms.kf_match_votes(slam.map, jnp.asarray(m))))
