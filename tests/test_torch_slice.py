"""The slice as a whole: `SLAMSystem` of the port against the JAX
reference, both with `use_lines=False`, on the bench scene at 320x240
with the default budgets and capacities (1024 / 2048 keypoints, 8 levels,
256 KF / 32768 points, local caps 2048 / 256). Bootstrap through `track()`,
then 16 frames through `track_sequence()`: the port's one path (a
`slam_step` per frame), and the reference's per-frame path, which it
takes for a sequence shorter than its 100-frame scan chunk.

Compared: the bootstrap frame, the tracked/lost flags and the keyframe
decision of every frame exactly; per-frame inlier counts within 10% and
poses within 1e-3. Measured on this sequence: identical inlier counts and
poses equal to ~1e-6 (from an identical carry one step agrees to ~1e-7;
over longer runs float32 sums taken in another order after each keyframe
BA can shift a marginal match, which the later frames carry, so the
bounds leave room for that). Both ATE-Sim3 must stay under 0.05.
"""

import functools

import numpy as np
import pytest

from structure_slam_pointline_tpu.io import synthetic
from structure_slam_pointline_tpu.models.system import SLAMSystem as JSystem
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem as TSystem
from structure_slam_pointline_tpu_torch.models.system import resolve_device

from torch_port_helpers import configs, sequence

N_TRACK = 16


def _run(cls, cfg, **kw):
    imgs, poses = sequence()
    slam = cls(cfg, **kw)
    i = 0
    while slam.carry is None and i < 20:
        slam.track(imgs[i], i)
        i += 1
    assert slam.carry is not None, "no bootstrap"
    T, ok, inl, kf = slam.track_sequence(imgs[i:i + N_TRACK], i)
    traj = slam.trajectory()
    ids = sorted(traj)
    est = np.stack([np.linalg.inv(traj[k]) for k in ids])
    return dict(init=i, T=T, ok=ok, inl=inl, kf=kf,
                ate=synthetic.ate_rmse(est, poses[ids]))


@functools.lru_cache(maxsize=None)
def _runs():
    jc, tc = configs(full=True)
    return _run(JSystem, jc), _run(TSystem, tc, device="cpu")


def test_bootstrap_frame_and_decisions():
    ref, out = _runs()
    assert out["init"] == ref["init"]
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    assert out["ok"].all()
    np.testing.assert_array_equal(out["kf"], ref["kf"])
    assert out["kf"].any()


def test_poses_inliers_and_ate():
    ref, out = _runs()
    np.testing.assert_allclose(out["inl"], ref["inl"], rtol=0.1)
    np.testing.assert_allclose(out["T"], ref["T"], atol=1e-3)
    assert ref["ate"] < 0.05 and out["ate"] < 0.05


def test_default_device_is_cuda_or_raises():
    """SLAMSystem(cfg) never falls back to the CPU silently."""
    import torch

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TSystem(configs()[1])
