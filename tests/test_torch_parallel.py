"""The sharded path of the port (parallel/: meshes, landmark-sharded BA,
the multi-process entry point, the data-parallel frontend) against the JAX
package and against the port's own unsharded paths, on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's meshes are shards on the CPU (`edge_mesh(n, device="cpu")`), which
run the plain versions. What is held here, each bound with its reason:

- (a) `shard_bundle_adjust` on `tests/test_local_ba.build_problem(seed=6)`
  (300 points, so 8 shards pad it to 304; with lines, 37 map lines pad to
  40), on edge_mesh(8) and edge_mesh(2), lines on and off. Against the
  reference's `make_dist_ba(edge_mesh(8))`: inlier masks equal, poses,
  points and line endpoints within 1e-3 (the unsharded BA's own bound
  against the reference, tests/test_torch_local_mapping.py; the sums run in
  another order). Against the port's unsharded BA: masks equal, poses
  within 1e-5 and points within 5e-5 (the same float32 arithmetic, only
  the sums over the shards run in another order; measured 5.6e-7 / 5.2e-6),
  line endpoints within 5e-4 (an endpoint is held weakly along its line,
  so the last bits of the camera step move it further; measured 1.1e-4).
- (b) `SLAMSystem(cfg, mesh=edge_mesh(4))` against `mesh=None` on the
  reference test's scene and trajectory (tests/test_multidevice_system.py:
  31-50) at 320x240 with the port tests' small configuration (the two CPU
  runs at 640x480 would not fit this file's minute), with the reference's
  bounds (ATE-Sim3 < 0.05 both, within 1e-3 of each other, camera centres
  on common frames within 5e-2 m); then one sharded global BA on the final
  map against the unsharded one, within the local bounds of (a). At this
  map size every live landmark falls in the first shard of the dense
  column order, so the two agree to the bit; (a) and (d) hold the
  reduction across shards that hold landmarks.
- (c) `make_batch_extractor(frame_mesh(4))` with and without lines at the
  reference test's configurations (tests/test_batch_frontend.py) against
  the reference's `make_batch_extractor(frame_mesh(4))` and the port's
  single-frame frontend. Against the single-frame frontend every field is
  equal. Against the reference: valid masks, octaves, descriptors (on
  valid slots), line valid masks and octaves equal; keypoint xy and
  responses within 1e-4, angles within 1e-4 rad (the vmapped program fuses
  its float32 ops in another order than the single-frame one the other
  frontend tests hold bit-exact); line endpoints within 1e-3 px (the bound
  of tests/test_torch_lines.py) and LBD words equal but for the exact ties
  that XLA's fused arithmetic breaks by a rounding (bit 176 in
  tests/test_torch_lines.py): here bit 176, the pair (68, 69), and at this configuration's
  single octave also bit 172, the pair (66, 67), on 6 of the 8 frames; on
  every segment where one differs the port holds the pair exactly tied
  (equal floats, bit 0).
- (d) the multi-process entry: two processes on gloo, two local shards
  each (`global_edge_mesh(4)`): the psum of ones is 4, both ranks' BA
  results are bit-equal (one all_reduce sum on both), and they agree with
  the one-process edge_mesh(4) run within (a)'s local bounds (the group
  sums the two ranks' partials in another order than one process sums
  four).
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_slam_pointline_tpu.config import CameraConfig as JCam
from structure_slam_pointline_tpu.config import FrontendConfig as JFront
from structure_slam_pointline_tpu.io import synthetic as jsyn
from structure_slam_pointline_tpu.optim import local_ba as jba
from structure_slam_pointline_tpu.parallel import batch_frontend as jbf
from structure_slam_pointline_tpu.parallel import dist_ba as jdist
from structure_slam_pointline_tpu.parallel import mesh as jmesh
from structure_slam_pointline_tpu_torch import config as tc
from structure_slam_pointline_tpu_torch.io import synthetic as tsyn
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem
from structure_slam_pointline_tpu_torch.ops import extract, lbd, lsd
from structure_slam_pointline_tpu_torch.optim import global_ba, local_ba
from structure_slam_pointline_tpu_torch.parallel import batch_frontend, dist_ba
from structure_slam_pointline_tpu_torch.parallel.mesh import edge_mesh
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

from test_local_ba import CFG as JCFG
from test_local_ba import INTR as JINTR
from test_local_ba import build_problem
from torch_port_helpers import CAM as SMALL_CAM
from torch_port_helpers import FRONT, MAP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = Intrinsics.from_config(tc.CameraConfig(fy=480.0))
OCFG = tc.OptimConfig()
N_LINES = 37
LOCAL = {"kf_T_cw": 1e-5, "mp_xyz": 5e-5, "ln_start": 5e-4, "ln_end": 5e-4}


def ba_problem():
    """build_problem(seed=6) as numpy, and 37 map lines seen by its six
    cameras (0.3 px noise on one endpoint's image, endpoints moved 3 cm)."""
    prob, T_gt, _ = build_problem(seed=6)
    prob = {f: np.array(v) for f, v in prob._asdict().items()}
    g = np.random.default_rng(16)
    KL = T_gt.shape[0]
    ls = np.stack([g.uniform(-3, 3, N_LINES), g.uniform(-2, 2, N_LINES),
                   g.uniform(4, 9, N_LINES)], 1)
    le = ls + g.normal(0, 0.7, (N_LINES, 3))
    obs_l = np.zeros((KL, N_LINES, 3), np.float32)
    for k in range(KL):
        def proj(X):
            pc = X @ T_gt[k, :3, :3].T + T_gt[k, :3, 3]
            return np.stack([pc[:, 0] / pc[:, 2] * INTR.fx + INTR.cx,
                             pc[:, 1] / pc[:, 2] * INTR.fy + INTR.cy, np.ones(N_LINES)], 1)
        noise = np.c_[g.normal(0, 0.3, (N_LINES, 2)), np.zeros(N_LINES)]
        ln = np.cross(proj(ls) + noise, proj(le))
        obs_l[k] = ln / np.hypot(ln[:, 0], ln[:, 1])[:, None]
    lines = dict(ln_start=(ls + g.normal(0, 0.03, ls.shape)).astype(np.float32),
                 ln_end=(le + g.normal(0, 0.03, le.shape)).astype(np.float32),
                 ln_valid=np.ones(N_LINES, bool), obs_l=obs_l,
                 obs_sigma2=np.full((KL, N_LINES), 4.0, np.float32),
                 edge_ln=np.tile(np.arange(N_LINES, dtype=np.int32), (KL, 1)),
                 edge_valid=np.ones((KL, N_LINES), bool))
    return prob, lines


def _port(prob, lines):
    p = local_ba.BAProblem(**{f: torch.from_numpy(v) for f, v in prob.items()})
    ln = None if lines is None else local_ba.BALineProblem(
        **{f: torch.from_numpy(v) for f, v in lines.items()})
    return p, ln


def _fields(res):
    return {f: getattr(res, f) for f in ("kf_T_cw", "mp_xyz", "ln_start", "ln_end")
            if getattr(res, f) is not None}


def _check_local(out, ref, what):
    """`out` against `ref` (both port results) within LOCAL, masks equal."""
    assert torch.equal(out.edge_inlier, ref.edge_inlier), what
    if ref.line_inlier is not None:
        assert torch.equal(out.line_inlier, ref.line_inlier), what
    for f, v in _fields(ref).items():
        np.testing.assert_allclose(getattr(out, f).numpy(), v.numpy(), atol=LOCAL[f], rtol=0,
                                   err_msg=f"{what}: {f}")


def test_shard_bundle_adjust():
    """(a): the port's sharded BA against the reference's and its own
    unsharded BA, 8 and 2 shards, lines on and off."""
    prob, lines = ba_problem()
    for ln in (None, lines):
        jprob = jba.BAProblem(**{f: jnp.asarray(v) for f, v in prob.items()})
        jln = None if ln is None else jba.BALineProblem(
            **{f: jnp.asarray(v) for f, v in ln.items()})
        ref = jdist.make_dist_ba(jmesh.edge_mesh(8), JINTR, JCFG)(jprob, jln)
        tprob, tln = _port(prob, ln)
        single = local_ba.bundle_adjust(tprob, INTR, OCFG, lines=tln)
        for n in (8, 2):
            what = f"{n} shards, lines {'on' if ln is not None else 'off'}"
            out = dist_ba.make_dist_ba(edge_mesh(n, device="cpu"), INTR, OCFG,
                                       n_iters=15)(tprob, tln)
            np.testing.assert_array_equal(out.edge_inlier.numpy(), np.asarray(ref.edge_inlier),
                                          err_msg=what)
            if ln is not None:
                np.testing.assert_array_equal(out.line_inlier.numpy(),
                                              np.asarray(ref.line_inlier), err_msg=what)
            for f, v in _fields(out).items():
                np.testing.assert_allclose(v.numpy(), np.asarray(getattr(ref, f)), atol=1e-3,
                                           rtol=0, err_msg=f"{what}: {f} against the reference")
            assert out.edge_inlier.sum() > 0.9 * prob["edge_valid"].sum(), what
            _check_local(out, single, what + " against the unsharded BA")
        assert (single.kf_T_cw - tprob.kf_T_cw).abs().max() > 1e-3   # the poses moved


def _system_run(cfg, cam, mesh):
    """The reference test's `_run` (tests/test_multidevice_system.py:31-50)."""
    n_frames = 36
    scene = tsyn.make_room_scene(n_points=300, n_lines=12, seed=3)
    poses = tsyn.circular_trajectory(n_frames, radius=0.5)
    imgs = tsyn.render_sequence(scene, poses, cam, noise=2.0)
    slam = SLAMSystem(cfg, mesh=mesh, device="cpu")
    i = 0
    while slam.carry is None and i < 12:
        slam.track(imgs[i], i)
        i += 1
    assert slam.carry is not None, "init failed"
    for j in range(i, n_frames):
        slam.track(imgs[j], j)
    traj = slam.trajectory()
    ids = sorted(traj.keys())
    est = np.stack([np.linalg.inv(traj[k]) for k in ids])
    slam.sync_cursors()
    return slam, ids, est, tsyn.ate_rmse(est, poses[ids])


def test_system_on_mesh(monkeypatch):
    """(b): the system on a 4-shard mesh against the unsharded system, then
    global BA on the final map, sharded against unsharded."""
    cam = tc.CameraConfig(**SMALL_CAM)
    cfg = tc.SLAMConfig(camera=cam, frontend=tc.FrontendConfig(**FRONT),
                        map=tc.MapConfig(**MAP))
    sharded = []
    real = local_ba.bundle_adjust_sharded

    def spy(prob, *a, **k):
        sharded.append(prob.edge_mp.shape[0])
        return real(prob, *a, **k)

    monkeypatch.setattr(local_ba, "bundle_adjust_sharded", spy)
    with pytest.raises(ValueError):
        SLAMSystem(cfg, mesh=edge_mesh(4, device="cpu"), device="meta")
    slam1, ids1, est1, ate1 = _system_run(cfg, cam, None)
    assert not sharded
    slam4, ids4, est4, ate4 = _system_run(cfg, cam, edge_mesh(4, device="cpu"))
    assert sharded, "the keyframe pipeline's BA never took the sharded engine"
    assert len(ids1) >= 25 and len(ids4) >= 25, (len(ids1), len(ids4))
    assert ate1 < 0.05 and ate4 < 0.05, (ate1, ate4)
    assert abs(ate1 - ate4) < 1e-3, (ate1, ate4)
    common = sorted(set(ids1) & set(ids4))
    assert len(common) >= 20
    dt = np.linalg.norm(est1[[ids1.index(k) for k in common]][:, :3, 3]
                        - est4[[ids4.index(k) for k in common]][:, :3, 3], axis=1)
    assert np.max(dt) < 5e-2
    n_sharded = len(sharded)
    st, n_kf = slam1.map, slam1.cur.n_kf
    one = global_ba.global_bundle_adjust(st, n_kf, slam1.intr, cfg)
    four = global_ba.global_bundle_adjust(st, n_kf, slam1.intr, cfg,
                                          mesh=edge_mesh(4, device="cpu"))
    assert sharded[n_sharded:] == [global_ba.GBA_MAX_KF]
    assert (one.kf_T_cw - st.kf_T_cw).abs().max() > 1e-4     # global BA moved the map
    for f, tol in (("kf_T_cw", LOCAL["kf_T_cw"]), ("mp_xyz", LOCAL["mp_xyz"]),
                   ("ml_endpoints", LOCAL["ln_start"])):
        np.testing.assert_allclose(getattr(four, f).numpy(), getattr(one, f).numpy(), atol=tol,
                                   rtol=0, err_msg=f)


FRONTEND_CASES = (
    # (frontend, make_room_scene arguments, with_lines): the reference test's
    (dict(n_keypoints=256, n_levels=4), dict(n_points=60, n_lines=6, seed=2), False),
    (dict(n_keypoints=128, n_levels=3), dict(n_points=30, n_lines=8, seed=5), True),
)


def test_batch_extractor():
    """(c): the data-parallel frontend against the reference's and the
    port's single-frame frontend."""
    cam = dict(fy=480.0, width=320, height=240, cx=159.5, cy=119.5, fx=240.0)
    for fe, sc, with_lines in FRONTEND_CASES:
        scene = jsyn.make_room_scene(**sc, extent=2.0, depth_range=(3.0, 6.0))
        imgs = jsyn.render_sequence(scene, jsyn.circular_trajectory(8, radius=0.2),
                                    JCam(**cam), noise=1.5)
        ref = jbf.make_batch_extractor(jbf.frame_mesh(4), JFront(**fe),
                                       with_lines=with_lines)(jnp.asarray(imgs, jnp.float32))
        cfg = tc.FrontendConfig(**fe)
        out = batch_frontend.make_batch_extractor(batch_frontend.frame_mesh(4, device="cpu"),
                                                  cfg, with_lines=with_lines)(imgs)
        kp, jkp = (out[0], ref[0]) if with_lines else (out, ref)
        assert kp.xy.shape == (8, fe["n_keypoints"], 2)
        for b in range(8):
            one = extract.extract_orb(torch.from_numpy(imgs[b]), cfg)
            for f in one._fields:
                assert torch.equal(getattr(kp, f)[b], getattr(one, f)), (b, f)
        valid = np.asarray(jkp.valid)
        assert valid.sum() > 0.5 * valid.size
        np.testing.assert_array_equal(kp.valid.numpy(), valid)
        np.testing.assert_array_equal(kp.octave.numpy(), np.asarray(jkp.octave))
        np.testing.assert_array_equal(kp.desc.numpy().view(np.uint32)[valid],
                                      np.asarray(jkp.desc)[valid])
        for f in ("xy", "response", "angle"):
            np.testing.assert_allclose(getattr(kp, f).numpy()[valid],
                                       np.asarray(getattr(jkp, f))[valid], atol=1e-4, rtol=0,
                                       err_msg=f)
        if not with_lines:
            continue
        ln, words = out[1], out[2]
        jln, jwords = ref[1], np.asarray(ref[2])
        assert ln.endpoints.shape == (8, cfg.n_lines, 4) and words.shape == (8, cfg.n_lines, 8)
        assert int(ln.valid.sum()) > 0
        np.testing.assert_array_equal(ln.valid.numpy(), np.asarray(jln.valid))
        np.testing.assert_array_equal(ln.octave.numpy(), np.asarray(jln.octave))
        lv = np.asarray(jln.valid)
        np.testing.assert_allclose(ln.endpoints.numpy()[lv], np.asarray(jln.endpoints)[lv],
                                   atol=1e-3, rtol=0)
        for b in range(8):
            img = torch.from_numpy(imgs[b])
            one = lsd.detect_lines(img, cfg)
            w1, desc = lbd.describe_lines(img, one.endpoints.contiguous(), one.valid)
            for f in one._fields:
                assert torch.equal(getattr(ln, f)[b], getattr(one, f)), (b, f)
            assert torch.equal(words[b], w1), b
            w, d = w1.numpy().view(np.uint32)[lv[b]], desc.numpy()[lv[b]]
            flips = np.unpackbits((w ^ jwords[b][lv[b]]).view(np.uint8),
                                  bitorder="little").reshape(len(w), 256)
            assert not flips[:, ~np.isin(np.arange(256), (172, 176))].any(), b
            for bit in (172, 176):
                rows = flips[:, bit].astype(bool)
                a, c = lbd._PAIRS[bit]
                np.testing.assert_array_equal(d[rows, a], d[rows, c])
                assert not (w[rows, bit // 32] >> (bit % 32) & 1).any(), (b, bit)


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from structure_slam_pointline_tpu_torch.config import CameraConfig, OptimConfig
from structure_slam_pointline_tpu_torch.optim import local_ba
from structure_slam_pointline_tpu_torch.parallel import dist_ba, distributed
from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

rank, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
assert distributed.initialize_multihost(f"localhost:{port}", 2, rank, device="cpu") == rank
assert distributed.initialize_multihost(f"localhost:{port}", 2, rank, device="cpu") == rank
mesh = distributed.global_edge_mesh(4)
assert (mesh.size, mesh.n_local, mesh.world) == (4, 2, 2), mesh
total = mesh.psum([torch.ones(1) for _ in mesh.local_shards])
assert float(total) == 4.0, float(total)
d = np.load(data)
prob = local_ba.BAProblem(**{f: torch.from_numpy(d["p_" + f]) for f in local_ba.BAProblem._fields})
lines = local_ba.BALineProblem(**{f: torch.from_numpy(d["l_" + f])
                                  for f in local_ba.BALineProblem._fields})
res = dist_ba.shard_bundle_adjust(mesh, prob, Intrinsics.from_config(CameraConfig(fy=480.0)),
                                  OptimConfig(), lines=lines)
np.savez(out, **{f: getattr(res, f).numpy() for f in res._fields})
distributed.shutdown_multihost()
print("RANK_OK", rank)
"""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_on_gloo(tmp_path):
    """(d): the multi-process entry point, 2 processes x 2 shards."""
    prob, lines = ba_problem()
    data = tmp_path / "problem.npz"
    np.savez(data, **{"p_" + f: v for f, v in prob.items()},
             **{"l_" + f: v for f, v in lines.items()})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port), str(data),
                               str(tmp_path / f"rank{r}.npz")], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in so, (so, se)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for f in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][f], ranks[1][f], err_msg=f)
    tprob, tln = _port(prob, lines)
    one = dist_ba.shard_bundle_adjust(edge_mesh(4, device="cpu"), tprob, INTR, OCFG, lines=tln)
    got = local_ba.BAResult(**{f: torch.from_numpy(ranks[0][f]) for f in ranks[0].files})
    _check_local(got, one, "2 processes x 2 shards against 1 process x 4")
