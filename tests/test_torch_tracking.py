"""Tracking parity: `track_step` of the port against the JAX reference on
the map the port bootstrapped, for the next frame (the same map, frame
and carry handed to both through convert.py, so tracking is compared
alone), at the normal windows and at the 2.5x wide re-track; plus the
pass-1 local sets and the seen counters.

Integer outputs (local-map slots, visibility, feature -> landmark
bindings, inlier counts) must be equal; the pose within 1e-4 (two pose
solves in float32, reductions in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.models import tracking as jtrk
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import tracking as ttrk
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

from torch_port_helpers import (assert_tuple_close, configs, jax_carry, jax_intr, jax_tuple,
                                port_boot, to_numpy_dict)

SEEN = ("mp_visible", "mp_found", "ml_visible", "ml_found")


def _T0(c, attempt: int) -> np.ndarray:
    """The initial pose of a tracking attempt: the velocity prediction,
    then the last pose for the wide re-track."""
    return (np.asarray(c["velocity"]) @ np.asarray(c["T_last"]) if attempt == 0
            else np.asarray(c["T_last"]))


def _setup():
    _, tc = configs()
    boot = port_boot()
    carry = convert.carry_from_numpy(boot["carry"], "cpu")
    return boot, carry, tc


@pytest.mark.parametrize("attempt", [0, 1])
def test_track_step(attempt):
    boot, carry, tc = _setup()
    jc, _ = configs()
    c = jax_carry(boot["carry"])
    n_kf = carry.n_kf
    T0 = _T0(boot["carry"], attempt).astype(np.float32)
    scale = 1.0 if attempt == 0 else 2.5
    ref = to_numpy_dict(jtrk.track_step(
        c.state, jax_tuple(jtrk.Frame, boot["frame"]), jnp.asarray(T0),
        jnp.asarray(max(n_kf - 20, 0)), jax_intr(jc), jc, radius_scale=scale, n_kf=c.n_kf,
        local_sets=c.local_sets))
    out = ttrk.track_step(carry.state, convert.frame_from_numpy(boot["frame"], "cpu"),
                          torch.from_numpy(T0), max(n_kf - 20, 0),
                          Intrinsics.from_config(tc.camera), tc, radius_scale=scale, n_kf=n_kf,
                          local_sets=carry.local_sets)
    assert int(ref["n_inliers"]) > 50
    assert_tuple_close(ref, out, atol=1e-4)


def test_local_sets_and_seen_counters():
    boot, carry, tc = _setup()
    jc, _ = configs()
    c = jax_carry(boot["carry"])
    ref = to_numpy_dict(jtrk.compute_local_sets(c.state, c.n_kf, 20, 1024, 64))
    assert_tuple_close(ref, ttrk.compute_local_sets(carry.state, carry.n_kf, 20, 1024, 64))
    st_ref = jtrk.update_seen_counters(c.state, jax_tuple(jtrk.TrackResult, boot["tr"]), jc)
    ttr = ttrk.TrackResult(**{k: torch.from_numpy(np.array(v)) for k, v in boot["tr"].items()})
    st_out = ttrk.update_seen_counters(carry.state, ttr, tc)
    for f in SEEN:
        np.testing.assert_array_equal(getattr(st_out, f).numpy(), np.asarray(getattr(st_ref, f)),
                                      err_msg=f)
