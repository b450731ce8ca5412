"""Shared set-up for the JAX <-> PyTorch parity tests (tests/test_torch_*.py).

One small configuration drives both packages: 320x240 images of the
bench scene (make_room_scene(350, 40, seed=0), circular trajectory of
radius 0.5), 512 runtime / 1024 init keypoints, 16 lines, a 32-keyframe /
4096-point / 256-line map with local caps 1024 / 64, and `use_lines`
off unless a test asks for lines. The JAX reference initializes on it
within a few frames. JAX runs on the CPU as the existing tests run it;
data crosses between the packages as numpy.

Shared references are `disk_cached`: the suite runs in several
pytest-xdist workers, and `--dist load` hands the tests of one file to
different workers, so an in-process cache alone recomputes a reference in
every worker that draws one of its tests. The first worker computes it
under a file lock and pickles the numpy result under the temp directory;
the others load it. The key hashes the sources of both packages and of
these test helpers, so an edit never reads a stale entry. A worker that
finds the lock taken waits, so an expensive reference is best needed by
one test item: the function-by-function tests start from the port's own
bootstrap (`port_boot`, a few seconds) and run one JAX function each.
"""

from __future__ import annotations

import dataclasses
import fcntl
import functools
import hashlib
import os
import pickle
import tempfile

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


def _make(mod, full: bool, lines: bool):
    small = not full
    return mod.SLAMConfig(camera=mod.CameraConfig(**CAM),
                          frontend=mod.FrontendConfig(**(FRONT if small else {})),
                          map=mod.MapConfig(**(MAP if small else {})),
                          use_lines=lines)


def configs(full: bool = False, lines: bool = False):
    """(JAX SLAMConfig, torch SLAMConfig) with identical fields; `full`
    keeps the default frontend budgets and map capacities (1024 / 2048
    keypoints, 256 KF / 32768 points, local caps 2048 / 256)."""
    j = _make(jcfg_mod, full, lines)
    t = _make(tcfg_mod, full, lines)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _source_digest() -> str:
    h = hashlib.sha1()
    for pkg in ("structure_slam_pointline_tpu", "structure_slam_pointline_tpu_torch"):
        for d, _, files in sorted(os.walk(os.path.join(_ROOT, pkg))):
            for f in sorted(files):
                if f.endswith((".py", ".cu", ".cuh")):
                    with open(os.path.join(d, f), "rb") as fh:
                        h.update(fh.read())
    with open(os.path.abspath(__file__), "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()[:16]


def disk_cached(fn):
    """Compute `fn()` (no arguments, a picklable result) once per source
    state across processes: file lock + pickle under the temp directory,
    and an in-process cache on top."""
    @functools.lru_cache(maxsize=None)
    def wrapped():
        src = os.path.abspath(fn.__code__.co_filename)
        with open(src, "rb") as fh:
            tag = hashlib.sha1(fh.read()).hexdigest()[:8]
        d = os.path.join(tempfile.gettempdir(), f"sspl_torch_port_{_source_digest()}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{os.path.basename(src)[:-3]}.{fn.__name__}.{tag}.pkl")
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path):
                with open(path, "rb") as fh:
                    return pickle.load(fh)
            out = fn()
            with open(path + ".tmp", "wb") as fh:
                pickle.dump(out, fh)
            os.replace(path + ".tmp", path)
            return out

    return wrapped


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


@disk_cached
def port_boot():
    """The port's SLAMSystem bootstrapped on the CPU on the small sequence,
    and the next frame built and tracked once as the per-frame step tracks
    it (velocity prediction, local window from keyframe 0), as numpy in
    the reference's layout (convert.py): {"carry", "i" (the next frame's
    index), "frame", "tr"}. The tracking, map-store and keyframe-pipeline
    tests hand this state to both packages: each runs one JAX function on
    it, none needs a JAX bootstrap, so tests in parallel workers do not
    wait on one."""
    from structure_slam_pointline_tpu_torch import convert
    from structure_slam_pointline_tpu_torch.models import pipeline as tpipe
    from structure_slam_pointline_tpu_torch.models import tracking as ttrk
    from structure_slam_pointline_tpu_torch.models.system import SLAMSystem
    from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

    _, tc = configs()
    imgs, _ = sequence()
    slam = SLAMSystem(tc, device="cpu")
    i = 0
    while slam.carry is None:
        slam.track(imgs[i], i)
        i += 1
    c = slam.carry
    intr = Intrinsics.from_config(tc.camera)
    frame = tpipe.build_frame_device(torch.from_numpy(imgs[i]), intr, tc)
    tr = ttrk.track_step(c.state, frame, c.velocity @ c.T_last, 0, intr, tc, n_kf=c.n_kf,
                         local_sets=c.local_sets)
    return {"carry": convert.carry_to_numpy(c), "i": i, "frame": convert.frame_to_numpy(frame),
            "tr": {f: v.numpy() for f, v in tr._asdict().items()}}


def jax_carry(d: dict):
    """A JAX SLAMCarry from its numpy dict (fresh device buffers: the
    reference's transitions donate their inputs)."""
    import jax.numpy as jnp

    from structure_slam_pointline_tpu.models import pipeline as jpipe
    from structure_slam_pointline_tpu.models import tracking as jtrk
    from structure_slam_pointline_tpu.world import map_store as jms

    kw = {k: jnp.asarray(v) for k, v in d.items() if k not in ("state", "local_sets")}
    return jpipe.SLAMCarry(state=jms.MapState(**{k: jnp.asarray(v)
                                                 for k, v in d["state"].items()}),
                           local_sets=jtrk.LocalSets(**{k: jnp.asarray(v) for k, v in
                                                        d["local_sets"].items()}), **kw)


def jax_intr(jc):
    from structure_slam_pointline_tpu.utils.camera import Intrinsics

    return Intrinsics.from_config(jc.camera)


def jax_tuple(cls, d: dict):
    """A JAX NamedTuple of class `cls` from its numpy dict."""
    import jax.numpy as jnp

    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


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
