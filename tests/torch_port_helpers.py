"""Shared set-up for the JAX <-> PyTorch parity tests (tests/test_torch_*.py).

One small configuration drives both packages: 320x240 images of the
bench scene (make_room_scene(350, 40, seed=0), circular trajectory of
radius 0.5), 512 runtime / 1024 init keypoints, a 32-keyframe /
4096-point map with local caps 1024 / 64 and `use_lines=False`. The JAX
reference initializes on it within a few frames. JAX runs on the CPU as
the existing tests run it; data crosses between the packages as numpy.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

from structure_slam_pointline_tpu import config as jcfg_mod
from structure_slam_pointline_tpu.io import synthetic
from structure_slam_pointline_tpu_torch import config as tcfg_mod

# The suite runs in several xdist workers next to XLA's own thread pools;
# torch's default of one intra-op thread per core oversubscribes the host
# many times over (the whole-slice test ran 10x slower that way). The
# port's CPU path is thousands of small ops, which gain nothing from more.
torch.set_num_threads(1)

W, H = 320, 240
CAM = dict(fx=481.2 * W / 640, fy=480.0 * W / 640, cx=W / 2 - 0.5,
           cy=H / 2 - 0.5, width=W, height=H)
FRONT = dict(n_keypoints=512, n_keypoints_init=1024, n_lines=16)
MAP = dict(max_keyframes=32, max_points=4096, max_lines=256,
           local_points_cap=1024, local_lines_cap=64)


def _make(mod, full: bool):
    small = not full
    return mod.SLAMConfig(camera=mod.CameraConfig(**CAM),
                          frontend=mod.FrontendConfig(**(FRONT if small else {})),
                          map=mod.MapConfig(**(MAP if small else {})),
                          use_lines=False)


def configs(full: bool = False):
    """(JAX SLAMConfig, torch SLAMConfig) with identical fields; `full`
    keeps the default frontend budgets and map capacities (1024 / 2048
    keypoints, 256 KF / 32768 points, local caps 2048 / 256)."""
    j = _make(jcfg_mod, full)
    t = _make(tcfg_mod, full)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@functools.lru_cache(maxsize=None)
def sequence(n_frames: int = 40):
    """Rendered [n, H, W] float32 frames and [n, 4, 4] T_wc ground truth."""
    cam = jcfg_mod.CameraConfig(**CAM)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(120, radius=0.5)[:n_frames]
    return synthetic.render_sequence(scene, poses, cam, noise=2.0), poses


def to_numpy_dict(nt) -> dict:
    """A JAX NamedTuple (nested ones too) -> dict of numpy arrays."""
    d = jax.device_get(nt)._asdict()
    return {k: (to_numpy_dict(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def jax_system():
    """A JAX SLAMSystem bootstrapped on the small sequence; returns
    (system, index of the next frame)."""
    from structure_slam_pointline_tpu.models.system import SLAMSystem

    jc, _ = configs()
    imgs, _ = sequence()
    slam = SLAMSystem(jc)
    i = 0
    while slam.carry is None:
        slam.track(imgs[i], i)
        i += 1
    return slam, i


def assert_tuple_close(a_np: dict, b_port, atol: float = 0.0):
    """Field-by-field comparison of a numpy dict (JAX side) with a port
    NamedTuple: integer / bool / bit fields exactly, floats within atol."""
    for f in b_port._fields:
        a = np.asarray(a_np[f])
        b = getattr(b_port, f).detach().cpu().numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
