"""The port's outputs and host I/O against the JAX package: the TUM
trajectory writers, the TUM / ICL manifests and the trajectory reader,
the native image loader, map save / load (each package loading the
other's files), the viewer, `device_trace`, and `shutdown` / `reset`.

Tolerances: trajectory files within 1e-7 per number (both packages print
the same float32 / float64 values with the same formats, so the text is
expected equal); a read-back trajectory within 1e-12 (float64 parsing of
the same text); decoded images, saved and loaded maps, manifests and the
rate counters exactly equal; the drawings pixel for pixel (the same
matplotlib calls on equal arrays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from structure_slam_pointline_tpu.io import datasets as jds
from structure_slam_pointline_tpu.io import native_loader as jnl
from structure_slam_pointline_tpu.models import system as jsys
from structure_slam_pointline_tpu.utils import lie as jlie
from structure_slam_pointline_tpu.viz import viewer as jviz
from structure_slam_pointline_tpu.world import map_store as jms
from structure_slam_pointline_tpu.world import serialize as jser
from structure_slam_pointline_tpu_torch import convert
from structure_slam_pointline_tpu_torch.io import datasets as tds
from structure_slam_pointline_tpu_torch.io import native_loader as tnl
from structure_slam_pointline_tpu_torch.models import pipeline as tpipe
from structure_slam_pointline_tpu_torch.models import system as tsys
from structure_slam_pointline_tpu_torch.utils import metrics as tmet
from structure_slam_pointline_tpu_torch.viz import viewer as tviz
from structure_slam_pointline_tpu_torch.world import map_store as tms
from structure_slam_pointline_tpu_torch.world import serialize as tser

from torch_port_helpers import assert_tuple_close, configs, port_boot, sequence


def _poses(g, n):
    """n poses T_cw as float32 [n, 4, 4]; the last third rotated by more
    than pi/2, so the quaternion's trace <= 0 branches run too."""
    xi = g.normal(0, 0.3, (n, 6)).astype(np.float32)
    xi[2 * n // 3:, :3] *= 9.0
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def _numbers(path):
    return np.loadtxt(path, ndmin=2)


def test_trajectory_writers_match_jax(tmp_path):
    """save_trajectory_tum / save_keyframe_trajectory_tum (with and
    without timestamps) and datasets.write_trajectory_tum of both
    packages on the same frame log and keyframe fields."""
    jc, tc = configs()
    g = np.random.default_rng(65)
    T = _poses(g, 24)
    ref, port = jsys.SLAMSystem(jc), tsys.SLAMSystem(tc, device="cpu")
    kf_ok = g.uniform(size=12) < 0.7
    fid = np.arange(12, dtype=np.int32) * 2
    for s, mod in ((ref, jsys), (port, tsys)):
        s.log = [mod.FrameLog(i, None if i % 5 == 3 else T[i], 100, i % 2 == 0,
                              mod.TrackingState.OK) for i in range(24)]
        s.cur.n_kf = 12
    K = tc.map.max_keyframes
    ref.map = ref.map._replace(kf_T_cw=ref.map.kf_T_cw.at[:12].set(T[:12]),
                               kf_valid=ref.map.kf_valid.at[:12].set(kf_ok),
                               kf_frame_id=ref.map.kf_frame_id.at[:12].set(fid))
    port.map = port.map._replace(
        kf_T_cw=torch.cat([torch.from_numpy(T[:12].copy()), port.map.kf_T_cw[12:]]),
        kf_valid=torch.cat([torch.from_numpy(kf_ok), torch.zeros(K - 12, dtype=torch.bool)]),
        kf_frame_id=torch.cat([torch.from_numpy(fid), port.map.kf_frame_id[12:]]))
    ts = 1.0 + np.arange(24) / 30.0
    for stamps in (None, ts):
        for writer in ("save_trajectory_tum", "save_keyframe_trajectory_tum"):
            a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
            getattr(ref, writer)(a, stamps)
            getattr(port, writer)(b, stamps)
            np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=0, atol=1e-7,
                                       err_msg=writer)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    jds.write_trajectory_tum(a, ts[:20], T[:20])
    tds.write_trajectory_tum(b, ts[:20], T[:20])
    np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=0, atol=1e-7)
    assert len(_numbers(b)) == 20 and _numbers(b).shape[1] == 8


def test_manifests_and_trajectory_roundtrip(tmp_path):
    """TUM and ICL manifests parse the same in both packages; a trajectory
    written by either reads back the same through either reader."""
    seq = tmp_path / "seq"
    seq.mkdir()
    (seq / "rgb.txt").write_text("# comment\n1.0 rgb/0.png\n\n1.033 rgb/1.png\n")
    (seq / "mono-normal.txt").write_text(
        "# icl\n0.0 rgb/0.png Normal/0.png\n0.033333 rgb/1.png Normal/1.png\n")
    (seq / "plain.txt").write_text("5 rgb/0.png\n")
    for a, b in ((jds.load_tum_rgb_manifest(str(seq)), tds.load_tum_rgb_manifest(str(seq))),
                 (jds.load_icl_manifest(str(seq / "mono-normal.txt")),
                  tds.load_icl_manifest(str(seq / "mono-normal.txt"))),
                 (jds.load_icl_manifest(str(seq / "plain.txt"), base_dir="/data"),
                  tds.load_icl_manifest(str(seq / "plain.txt"), base_dir="/data"))):
        np.testing.assert_array_equal(b.timestamps, a.timestamps)
        assert (b.image_paths, b.aux_paths, len(b)) == (a.image_paths, a.aux_paths, len(a))
    g = np.random.default_rng(66)
    T = _poses(g, 6)
    ts = np.arange(6, dtype=np.float64) * 0.5
    for writer in (jds.write_trajectory_tum, tds.write_trajectory_tum):
        path = str(tmp_path / "traj.txt")
        writer(path, ts, T)
        (t1, T1), (t2, T2) = jds.read_trajectory_tum(path), tds.read_trajectory_tum(path)
        np.testing.assert_array_equal(t2, t1)
        np.testing.assert_allclose(T2, T1, rtol=0, atol=1e-12)
        for i in range(6):
            np.testing.assert_allclose(T2[i], np.linalg.inv(T[i]), atol=1e-5)


def test_native_loader_matches_reference(tmp_path):
    """Gray and RGB PNG, PGM, and the prefetching stream: the port's
    binding gives the reference binding's arrays (both over
    native/libsspl_io.so, or both over PIL where it cannot be built)."""
    assert (tnl.get_lib() is None) == (jnl.get_lib() is None)
    g = np.random.default_rng(67)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"g{i}.png")
        Image.fromarray(g.integers(0, 256, (48, 64), dtype=np.uint8), "L").save(p)
        paths.append(p)
    rgb = str(tmp_path / "c.png")
    Image.fromarray(g.integers(0, 256, (32, 40, 3), dtype=np.uint8), "RGB").save(rgb)
    pgm = str(tmp_path / "x.pgm")
    with open(pgm, "wb") as f:
        f.write(b"P5\n32 24\n255\n" + g.integers(0, 256, (24, 32), dtype=np.uint8).tobytes())
    for p in paths[:2] + [rgb, pgm]:
        a, b = jnl.load_image(p), tnl.load_image(p)
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=p)
    np.testing.assert_array_equal(tds.load_image_grayscale(rgb), jds.load_image_grayscale(rgb))
    jl, tl = jnl.PrefetchingLoader(paths, n_threads=3, ring=2), tnl.PrefetchingLoader(
        paths, n_threads=3, ring=2)
    got_j, got_t = list(jl), list(tl)
    jl.close()
    tl.close()
    assert tl.decoder == ("pil" if tnl.get_lib() is None else "native")
    assert [i for i, _ in got_t] == [i for i, _ in got_j] == list(range(5))
    for (_, a), (_, b) in zip(got_j, got_t):
        np.testing.assert_array_equal(b, a)


def test_save_load_map_cross_package(tmp_path):
    """A map saved by either package loads in the other (and in itself)
    with equal arrays and cursors."""
    d = port_boot()["carry"]["state"]
    st = convert.map_state_from_numpy(d, "cpu")
    cur = tms.MapCursors(n_kf=2, n_mp=417, n_ml=3)
    p_port, p_ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tser.save_map(p_port, st, cur)
    jser.save_map(p_ref, jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}),
                  jms.MapCursors(n_kf=2, n_mp=417, n_ml=3))
    for path in (p_port, p_ref):
        st2, cur2 = tser.load_map(path, "cpu")
        assert (cur2.n_kf, cur2.n_mp, cur2.n_ml) == (2, 417, 3)
        assert_tuple_close(d, st2)
        jst, jcur = jser.load_map(path)
        assert (jcur.n_kf, jcur.n_mp, jcur.n_ml) == (2, 417, 3)
        for f in jms.MapState._fields:
            a = np.asarray(getattr(jst, f))
            assert a.dtype == d[f].dtype, f
            np.testing.assert_array_equal(a, d[f], err_msg=f)


def test_viewer_and_device_trace(tmp_path):
    """draw_map / draw_frame of both packages give the same pixels;
    device_trace writes a torch.profiler trace of the region on the CPU."""
    pytest.importorskip("matplotlib")
    d = port_boot()["carry"]["state"]
    traj = np.stack([np.linalg.inv(T) for T in _poses(np.random.default_rng(68), 8)])
    jviz.draw_map(jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}), 2,
                  str(tmp_path / "a.png"), trajectory=traj, gt_trajectory=traj)
    tviz.draw_map(convert.map_state_from_numpy(d, "cpu"), 2, str(tmp_path / "b.png"),
                  trajectory=traj, gt_trajectory=traj)
    img, _ = sequence(1)
    g = np.random.default_rng(69)
    kp = g.uniform(0, 200, (50, 2))
    kw = dict(kp_xy=kp, kp_matched=g.uniform(size=50) < 0.5,
              line_ep=g.uniform(0, 200, (6, 4)), line_valid=g.uniform(size=6) < 0.7, text="OK")
    jviz.draw_frame(img[0], str(tmp_path / "c.png"), **kw)
    tviz.draw_frame(img[0], str(tmp_path / "d.png"), **kw)
    for a, b in (("a", "b"), ("c", "d")):
        pa = np.asarray(Image.open(tmp_path / f"{a}.png"))
        pb = np.asarray(Image.open(tmp_path / f"{b}.png"))
        np.testing.assert_array_equal(pb, pa)
    with tmet.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "aten::mm" in (tmp_path / "trace" / "trace.json").read_text()
    assert isinstance(tmet.GLOBAL, tmet.Metrics)


def test_shutdown_and_reset():
    """The reference's tests/test_system.py:94 on the port's bootstrap, and
    the rate counters after a reset held to the reference's on one carried
    state: reset() keeps the landmark-rate baseline, so the first keyframe
    event of the new map counts against the old map's cursors."""
    jc, tc = configs()
    boot = port_boot()["carry"]
    imgs, _ = sequence(10)
    ref, port = jsys.SLAMSystem(jc), tsys.SLAMSystem(tc, device="cpu")
    port.carry = convert.carry_from_numpy(boot, "cpu")
    port.map = port.carry.state
    port.log = [tsys.FrameLog(i, np.eye(4, dtype=np.float32), 50, False,
                              tsys.TrackingState.OK) for i in range(12)]
    port.shutdown()   # cursors synced from the carry
    assert (port.cur.n_kf, port.cur.n_mp, port.cur.n_ml) == (
        boot["n_kf"], boot["n_mp"], boot["n_ml"])
    live = (int(boot["state"]["mp_valid"].sum()), int(boot["state"]["ml_valid"].sum()))
    base = [boot["n_mp"], boot["n_ml"], *live]
    new = [boot["n_mp"] + 40, boot["n_ml"] + 2, live[0] + 30, live[1] + 2]
    row = np.zeros(25, np.float32)
    row[20:24] = new
    ref._lm_base = list(base)
    port._lm_base = tuple(base)
    ref.reset()
    port.reset()
    assert port._lm_base == tuple(base) and ref._lm_base == base
    ref._count_landmark_deltas(row)
    port._count_landmark_deltas(tpipe.FrameOut(
        T_cw=None, ok=True, n_inliers=0, is_kf=True, n_mp=new[0], n_ml=new[1],
        n_live_mp=new[2], n_live_ml=new[3]))
    assert dict(port.metrics.counters) == dict(ref.metrics.counters)
    assert port.metrics.counters["points_created"] == 40
    assert port.state == tsys.TrackingState.NO_IMAGES_YET and port.carry is None
    assert port.cur.n_kf == 0 and len(port.trajectory()) == 12
    i = 0
    while port.carry is None and i < 10:
        port.track(imgs[i], i)
        i += 1
    assert port.carry is not None
