"""Tracking parity: `track_step` of the port against the JAX reference on
a map the JAX system bootstrapped, for the next frame (the frame itself
built by the JAX frontend, so tracking is compared alone), at the normal
windows and at the 2.5x wide re-track; plus the pass-1 local sets and the
seen counters.

Integer outputs (local-map slots, visibility, feature -> landmark
bindings, inlier counts) must be equal; the pose within 1e-4 (two pose
solves in float32, reductions in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.models import pipeline as jpipe
from structure_slam_pointline_tpu.models import tracking as jtrk
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.models import tracking as ttrk
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

from torch_port_helpers import assert_tuple_close, configs, jax_system, sequence, to_numpy_dict


@functools.lru_cache(maxsize=None)
def _setup():
    slam, i = jax_system()
    jc, tc = configs()
    imgs, _ = sequence()
    frame = jpipe.build_frame_jit(jnp.asarray(imgs[i]), slam.intr, jc)
    carry = convert.carry_from_numpy(to_numpy_dict(slam.carry), "cpu")
    tframe = convert.frame_from_numpy(to_numpy_dict(frame), "cpu")
    return slam, frame, carry, tframe, jc, tc


@pytest.mark.parametrize("attempt", [0, 1])
def test_track_step(attempt):
    slam, frame, carry, tframe, jc, tc = _setup()
    c = slam.carry
    T0 = np.asarray(c.velocity @ c.T_last) if attempt == 0 else np.asarray(c.T_last)
    scale = 1.0 if attempt == 0 else 2.5
    n_kf = int(c.n_kf)
    ref = jax.device_get(jtrk.track_step(
        c.state, frame, jnp.asarray(T0), jnp.asarray(max(n_kf - 20, 0)), slam.intr, jc,
        radius_scale=scale, n_kf=c.n_kf, local_sets=c.local_sets))
    out = ttrk.track_step(carry.state, tframe, torch.from_numpy(np.array(T0)), max(n_kf - 20, 0),
                          Intrinsics.from_config(tc.camera), tc, radius_scale=scale,
                          n_kf=n_kf, local_sets=carry.local_sets)
    assert int(ref.n_inliers) > 50
    assert_tuple_close(ref._asdict(), out, atol=1e-4)


def test_local_sets_and_seen_counters():
    slam, frame, carry, tframe, jc, tc = _setup()
    c = slam.carry
    ref = jtrk.compute_local_sets(c.state, c.n_kf, 20, 1024, 64)
    out = ttrk.compute_local_sets(carry.state, int(c.n_kf), 20, 1024, 64)
    assert_tuple_close(to_numpy_dict(ref), out)
    tr = jtrk.track_step(c.state, frame, c.velocity @ c.T_last, jnp.asarray(0), slam.intr,
                         jc, n_kf=c.n_kf, local_sets=c.local_sets)
    st_ref = jtrk.update_seen_counters(c.state, tr, jc)
    ttr = ttrk.TrackResult(**{k: torch.from_numpy(np.array(v)) for k, v in
                              to_numpy_dict(tr).items()})
    st_out = ttrk.update_seen_counters(carry.state, ttr, tc)
    for f in ("mp_visible", "mp_found", "ml_visible", "ml_found"):
        np.testing.assert_array_equal(getattr(st_out, f).numpy(),
                                      np.asarray(getattr(st_ref, f)), err_msg=f)
