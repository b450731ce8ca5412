#!/usr/bin/env python3
"""Kernels of several checkouts, alternated on one GPU: each checked against
its plain version, then timed by launch name beside a PyTorch call for the
same work.

    python3 tools/kernel_ab.py ROOT [ROOT ...] [--kernels NAME ...]
                               [--systems N:CAP ...] [--reps 20] [--trace]
                               [--window FILE] [--out FILE]

Each root is a checkout of this repository (for example the parent commit
unpacked with `git archive` into `out_parent/`, which `.gitignore`'s
`out*/` covers, and this tree, `.`). The roots run in the order given
(parent, change, change, parent compares two versions), each in a process
of its own that imports the port from its root and builds the named
kernels' sources into its `build/`, printing their `-Xptxas -v` report
(registers, stack frame, spills). The inputs, the checks and the timing
(`chip_smoke.by_kernel`, `chip_smoke.time_ms`) come from this tree, so every
root runs the same code around its kernels. Kernels (`--kernels`, default
all):

- ransac_pnp: `tests/test_torch_kernels_gpu.py pnp_problem()` at 16
  candidates x 256 hypotheses x 1024 points (the relocalization shape) and
  3 x 100 x 1024; against `ransac_pnp_plain` (the same chosen hypothesis and
  count, poses within 1e-4, counts equal on >= 99%) and timed beside
  torch.linalg.svd of the same [C * I, 12, 12] DLT batch;
- lsd_support: both octaves of bench frame 40 (640x480 and 320x240) at
  line_support_downsample 1 and 2, bit for bit against
  `lsd_support_plain`, timed per frame;
- pose_lm: `tests/test_torch_kernels_gpu.py pose_problem()` (N 2048, M
  256) at line weight 0 and 1, each at the tracking's two schedules
  (rounds x iterations 2 x 4 and 4 x 6), the same at line weight 0 with
  144 masked points (the main path's density), and N 1024 with one line row on
  (the relocalization's shape) at 4 x 6; against `pose_optimize_plain`
  (pose within 1e-4, inlier masks equal on >= 99.5%, n_inliers equal to
  the kernel's masks' sum);
- lsd_refine: both octaves of bench frame 40 (256 anchors at 48 walk
  steps, 128 at 24) at line_support_downsample 1 and 2, the anchors as
  `detect_lines` selects them; every valid anchor's output bit-equal to
  `lsd_refine_plain`'s, timed per frame;
- dense_solve: per N:CAP (`--systems`), a damped J^T J + 1e-3 I of N rows
  and a random right side (numpy, seed 1, drawn in the order given) at a
  capacity of CAP rows (which picks the panel width); pivots and x against
  `lu_solve_blocked_plain` (bit for bit), timed beside torch.linalg.solve;
- lsd_merge: kernel 26 on the recorded calls of bench frames 0-19 and every
  25th to 225 (`bench_calls`: the frame's own `detect_lines_pyramid`), both
  entries bit-equal to `lsd_merge_plain` / `lsd_octave_merge_plain` on
  every output of every call, timed a frame over all the calls, for the
  first frame and for each late frame (200 and after); `--trace` adds,
  for roots whose source has the marks, each phase's clock64 cycles and
  the rows' popcounts around each squaring (`merge_trace`, a copy built
  with -DSSPL_LSD_TRACE into the root's build/);
- kp_select: kernel 11 on the same frames' recorded calls (the ORB
  8-level call, both LSD anchor calls): valid equal, xy and resp equal on
  valid slots (and whether every slot is), launches a call, frame 200's
  three calls timed one by one and together, and the batch entry on frames
  200 and 225 stacked (equal to their single-frame calls);
- local_ba: kernel 12 on the main path's largest recorded window (the lines
  path run once with this tree's port before the roots, saved to
  `--window`, default `build/ba_window.pt`) and on global BA's 64-keyframe
  shape (`ba_problem`, 64 keyframes, 56 valid): within 1e-3 of
  `bundle_adjust_plain`, masks equal on >= 99.5%, two calls bit-identical,
  launches a call, timed; `--trace` adds the one-launch form's cycles by
  phase at the window and the chain's `ba_solve` split (assembly, solve)
  at 64 keyframes (`ba_trace`, a copy built with -DSSPL_BA_TRACE);
- pyramid: kernel 25 on bench frames 0, 40 and 200 and frames 40 + 200
  stacked, bit-equal to `build_blurred_pyramid_plain`, C calls and device
  kernels a call, timed; `--trace` adds block 0's cycles per phase, its
  tiles and the grid barrier after them (`pyr_trace`, a copy built with
  -DSSPL_PYR_TRACE);
- fast: kernel 1 on the levels of bench frames 0, 40 and 200 and of frames
  40 + 200 stacked (made by the root's kernel 25), every level bit-equal
  to `fast_score_nms_plain`, C calls a frame, timed a frame; a root without
  the per-frame entry runs its per-level calls;
- orb: kernel 2 on the same frames' keypoints (the frontend's 1024,
  selected by the root's kernels 1 and 11), descriptors equal on >= 99.5%
  and angles within 1e-4 of the plain version, level-0 xy and octaves
  equal, C calls a frame, timed a frame alone and with the per-level glue
  a root without the per-frame entry runs (products, fills,
  concatenations).

Device time is per call from torch.profiler, by kernel name (memsets and
copies under their own names); caller time is the median of CUDA events
around one call. The card's name and power limit come first, then each
root's results as one JSON line. Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = ("48:48", "96:96", "306:306", "378:378", "357:1792", "1792:1792")


def timed(cs, fn, reps: int) -> dict:
    k = cs.by_kernel(fn, reps)
    return {"device_ms": sum(k.values()), "by_kernel": k, "caller_ms": cs.time_ms(fn, reps)}


def case_ransac_pnp(cs, reps: int, _systems) -> dict:
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.ops import pnp
    from test_torch_kernels_gpu import PNP_INTR, pnp_problem

    out = {}
    for C, I in ((16, 256), (3, 100)):
        pts, uv, mask, sets, _ = pnp_problem(C=C, I=I)
        args = [t.cuda() for t in (pts, uv, mask, sets)]
        run = lambda: pnp.ransac_pnp(*args, PNP_INTR, min_inliers=10)  # noqa: E731
        kernels.reset_counts()
        rk = run()
        launches = kernels.COUNTS["ransac_pnp"]
        rp = pnp.ransac_pnp_plain(*args, PNP_INTR, min_inliers=10)
        same = (torch.equal(torch.argmax(rk.counts, 1), torch.argmax(rp.counts, 1))
                and torch.equal(rk.n_inliers, rp.n_inliers))
        err = (rk.T_cw - rp.T_cw).abs().max().item()
        eq = (rk.counts == rp.counts).float().mean().item()
        dlt = pnp.dlt_systems(args[0], args[1], args[3], PNP_INTR)[0].reshape(-1, 12, 12)
        svd = timed(cs, lambda: torch.linalg.svd(dlt), reps)
        out[f"{C}x{I}x{pts.shape[1]}"] = {
            "ok": same and err <= 1e-4 and eq >= 0.99, "same_choice": same, "pose_err": err,
            "counts_equal": eq, "launches": launches, **timed(cs, run, reps),
            "svd_device_ms": svd["device_ms"], "svd_caller_ms": svd["caller_ms"]}
    return out


def case_lsd_support(cs, reps: int, _systems) -> dict:
    import torch

    from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import lsd

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose = synthetic.circular_trajectory(610, radius=0.5)[40]
    img = torch.from_numpy(synthetic.render(scene, pose, cam, noise=2.0, seed=40)).cuda()
    octaves = [img, lsd.half_octave(img).contiguous()]
    fe = FrontendConfig()
    out = {}
    for ds in (1, 2):
        calls = [(o, fe.line_grad_threshold, fe.line_angle_tol, fe.line_min_length, ds)
                 for o in octaves]
        equal = True
        for a in calls:
            bk, pk = lsd.lsd_support(*a)
            bp, pp = lsd.lsd_support_plain(*a)
            equal &= torch.equal(bk, bp) and torch.equal(pk, pp)
        out[f"ds{ds}"] = {"ok": bool(equal),
                          **timed(cs, lambda: [lsd.lsd_support(*a) for a in calls], reps)}
    return out


def case_pose_lm(cs, reps: int, _systems) -> dict:
    import dataclasses

    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.config import OptimConfig
    from structure_slam_pointline_tpu_torch.optim import pose_opt
    from test_torch_kernels_gpu import pose_problem, pose_to

    out = {}
    cases = [(w, 2048, 256, s, None) for w in (0.0, 1.0) for s in ((2, 4), (4, 6))]
    cases += [(0.0, 2048, 256, s, 144) for s in ((2, 4), (4, 6))]
    cases.append((1.0, 1024, 1, (4, 6), None))
    for w, N, M, (rounds, iters), keep in cases:
        args, intr = pose_problem(w, N, M, keep=keep)
        if M == 1:
            args[8] = torch.ones(1, dtype=torch.bool)   # the one line row on
        cfg = dataclasses.replace(OptimConfig(), pose_rounds=rounds, pose_iters=iters)
        args_k = pose_to(args, "cuda")
        args_p = [a.cuda() for a in args]
        run = lambda: pose_opt.pose_optimize(*args_k, intr, cfg)  # noqa: E731
        kernels.reset_counts()
        rk = run()
        launches = kernels.COUNTS["pose_lm"]
        rp = pose_opt.pose_optimize_plain(*args_p, intr, cfg)
        err = (rk.T_cw - rp.T_cw).abs().max().item()
        same = torch.cat([rk.point_inliers == rp.point_inliers,
                          rk.line_inliers == rp.line_inliers]).float().mean().item()
        n_ok = int(rk.n_inliers) == int(rk.point_inliers.sum()) + int(rk.line_inliers.sum())
        active = int(args[3].sum()) + 2 * int(args[8].sum())
        out[f"w{w:g}_N{N}_M{M}_{rounds}x{iters}" + (f"_keep{keep}" if keep else "")] = {
            "ok": err <= 1e-4 and same >= 0.995 and n_ok, "pose_err": err,
            "inliers_equal": same, "n_inliers": int(rk.n_inliers), "n_inliers_ok": n_ok,
            "active_rows": active, "launches": launches, **timed(cs, run, reps)}
    return out


def case_lsd_refine(cs, reps: int, _systems) -> dict:
    import torch

    from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import lsd
    from test_torch_kernels_gpu import _anchors

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    pose = synthetic.circular_trajectory(610, radius=0.5)[40]
    img = torch.from_numpy(synthetic.render(scene, pose, cam, noise=2.0, seed=40)).cuda()
    octaves = [img, lsd.half_octave(img).contiguous()]
    fe = FrontendConfig()
    out = {}
    for ds in (1, 2):
        calls, valid = [], []
        for o, K, S in zip(octaves, (256, 128), (48, 24)):
            ax, ay, avalid, packed = _anchors(o, K, ds)
            calls.append((o, packed, ax, ay, S, fe.line_refine_iters, fe.line_angle_tol,
                          fe.line_grad_threshold))
            valid.append(avalid)
        differ = 0
        for a, v in zip(calls, valid):
            differ += int((lsd.lsd_refine(*a)[v] != lsd.lsd_refine_plain(*a)[v]).any(1).sum())
        out[f"ds{ds}"] = {"ok": differ == 0, "valid_anchors": int(sum(v.sum() for v in valid)),
                          "anchors_differing": differ,
                          **timed(cs, lambda: [lsd.lsd_refine(*a) for a in calls], reps)}
    return out


def case_dense_solve(cs, reps: int, systems) -> dict:
    import numpy as np
    import torch

    from structure_slam_pointline_tpu_torch.utils import linalg

    g = np.random.default_rng(1)
    out = {}
    for spec in systems:
        n, cap = (int(v) for v in spec.split(":"))
        J = g.normal(size=(2 * n, n))
        A = J.T @ J + 1e-3 * np.eye(n)
        Ab = torch.from_numpy(np.concatenate([A, g.normal(size=(n, 1))], 1)
                              .astype(np.float32)).cuda()
        nb = linalg.dense_panel_width(cap)
        xk, pk = linalg.dense_solve(Ab, cap)
        xp, pp = linalg.lu_solve_blocked_plain(Ab, n, nb)
        Af, bf = Ab[:, :n].contiguous(), Ab[:, n].contiguous()
        lib = timed(cs, lambda: torch.linalg.solve(Af, bf), reps)
        out[spec] = {"ok": torch.equal(pk, pp) and torch.equal(xk, xp), "panel": nb,
                     **timed(cs, lambda: linalg.dense_solve(Ab, cap), reps),
                     "solve_device_ms": lib["device_ms"], "solve_caller_ms": lib["caller_ms"]}
    return out


# the bench frames whose frontend calls are recorded: the first 20 and every
# 25th (the lines path runs bootstrap + 200 frames, ~238 of the sequence)
BENCH_FRAMES = tuple(range(20)) + tuple(range(25, 240, 25))


def bench_calls(frames=BENCH_FRAMES) -> dict:
    """The main path's frontend calls on bench frames, recorded: for each
    frame {"kp_select": [ORB 8-level call, LSD octave 0 anchors, octave 1
    anchors], "lsd_merge": [octave 0, octave 1], "lsd_octave_merge": [one]},
    each an (args, kwargs) pair of the frame's own call (the run-time ORB
    budget, lines on), made by `extract_orb` and `detect_lines_pyramid` of
    the root's port on the card."""
    import torch

    from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import extract, fast, lsd

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(610, radius=0.5)
    fe = FrontendConfig()
    out = {}
    for f in frames:
        img = torch.from_numpy(synthetic.render(scene, poses[f], cam, noise=2.0, seed=f)).cuda()
        rec = {"kp_select": [], "lsd_merge": [], "lsd_octave_merge": []}
        saved = {}
        for name, mod, attr in (("kp_select", fast, "select_keypoints_levels"),
                                ("lsd_merge", lsd, "lsd_merge"),
                                ("lsd_octave_merge", lsd, "lsd_octave_merge")):
            fn = saved[(mod, attr)] = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                rec[_name].append((a, kw))
                return _fn(*a, **kw)
            setattr(mod, attr, wrapped)
        try:
            extract.extract_orb(img, fe)
            lsd.detect_lines_pyramid(img, fe)
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
        out[f] = rec
    return out


def merge_trace(calls) -> list:
    """Kernel 26's lsd_merge of `calls` through a copy built with
    -DSSPL_LSD_TRACE (into the root's build/): per call the cycles of each
    phase (clock64 marks), the squarings run and the rows each walked, and
    the rows' popcounts before and after each squaring (sum, mean, max)."""
    import ctypes
    import subprocess

    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.ops import lsd

    out_lib = os.path.join(kernels.BUILD_DIR, "libsspl_lsd_merge_trace.so")
    cmd = kernels._nvcc_cmd("lsd_merge.cu", out_lib)
    subprocess.run(cmd[:1] + ["-DSSPL_LSD_TRACE"] + cmd[1:], check=True, capture_output=True)
    lib = ctypes.CDLL(out_lib)
    lib.sspl_lsd_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    phases = ("stage", "links", "transpose", "square1", "square2", "square3", "square4",
              "extents", "suppression", "rank", "write")
    res = []
    for (ref, avalid, L, min_length, angle_tol), _ in calls:
        K = ref.shape[0]
        tr = torch.zeros(20 + 5 * K, dtype=torch.int64, device=ref.device)
        outs = [torch.empty(s, dtype=d, device=ref.device) for s, d in (
            ((L, 4), torch.float32), ((L, 3), torch.float32), ((L,), torch.float32),
            ((L,), torch.float32), ((L,), torch.bool), ((L,), torch.int32))]
        work = lsd._LsdWork(K=K, L=L, min_length=lsd._c(min_length),
                            angle_tol=lsd._c(angle_tol), ref=ref.data_ptr(),
                            avalid=avalid.data_ptr(), trace=tr.data_ptr(),
                            **{k: t.data_ptr() for k, t in zip(lsd.Lines._fields, outs)})
        err = lib.sspl_lsd_merge(ctypes.addressof(work),
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"traced lsd_merge failed: {err}")
        t = tr.cpu().tolist()
        pop = torch.tensor(t[20:]).reshape(5, K).float()
        res.append({"K": K, "cycles": dict(zip(phases, [t[i + 1] - t[i] for i in range(11)])),
                    "total_cycles": t[11] - t[0], "squarings_run": t[16],
                    "rows_walked": t[12:16],
                    "popcount_sum": pop.sum(1).tolist(), "popcount_mean": pop.mean(1).tolist(),
                    "popcount_max": pop.max(1).values.tolist()})
    return res


def case_lsd_merge(cs, reps: int, _systems, trace=False) -> dict:
    """Kernel 26 on the bench frames' recorded calls: every output of
    every call bit-equal to the plain version's; device time a frame (the
    two octaves) over all the recorded calls, the first frame's and each
    late frame's (200 and after); the cross-octave step likewise; with
    --trace, `merge_trace` of the first frame's and the late frames'."""
    import torch

    from structure_slam_pointline_tpu_torch.ops import lsd

    frames = bench_calls()

    def equal(a, b):
        return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)

    out = {}
    for name, fn, plain in (("lsd_merge", lsd.lsd_merge, lsd.lsd_merge_plain),
                            ("lsd_octave_merge", lsd.lsd_octave_merge,
                             lsd.lsd_octave_merge_plain)):
        calls = [c for f in frames for c in frames[f][name]]
        differ = [f"frame {f} call {i}" for f in frames for i, (a, k) in
                  enumerate(frames[f][name]) if not equal(fn(*a, **k), plain(*a, **k))]
        per_frame = len(frames[0][name])
        all_t = timed(cs, lambda: [fn(*a, **k) for a, k in calls], reps)
        row = {"ok": not differ, "calls": len(calls), "differ": differ[:20],
               "frame_device_ms": all_t["device_ms"] * per_frame / len(calls),
               "frame_caller_ms": all_t["caller_ms"] * per_frame / len(calls),
               "by_kernel_per_frame": {k: v * per_frame / len(calls)
                                       for k, v in all_t["by_kernel"].items()}}
        for f in [0] + [f for f in frames if f >= 200]:
            ft = timed(cs, lambda: [fn(*a, **k) for a, k in frames[f][name]], reps)
            row[f"frame{f}_device_ms"] = ft["device_ms"]
        out[name] = row
    if trace:
        out["trace"] = {f: merge_trace(frames[f]["lsd_merge"])
                        for f in [0] + [f for f in frames if f >= 200]}
    return out


def case_kp_select(cs, reps: int, _systems, **_) -> dict:
    """Kernel 11 on the bench frames' recorded calls (the ORB 8-level call
    and both LSD anchor calls of each): valid equal with xy and resp equal
    on valid slots (`ok`), and whether every slot is bit-equal; launches a
    call; device and caller ms of each of frame 200's three calls and of
    the three together; the batch entry on frames 200 and 225's ORB maps
    stacked, equal to the two single-frame calls, timed."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.ops import fast

    frames = bench_calls()
    on_valid = every_slot = True
    n = 0
    for f in frames:
        for a, k in frames[f]["kp_select"]:
            for (xk, rk, vk), (xp, rp, vp) in zip(fast.select_keypoints_levels(*a, **k),
                                                  fast.select_keypoints_levels_plain(*a, **k)):
                on_valid &= (torch.equal(vk, vp) and torch.equal(rk[vk], rp[vp])
                             and torch.equal(xk[vk], xp[vp]))
                every_slot &= torch.equal(xk, xp) and torch.equal(rk, rp)
            n += 1
    a, k = frames[200]["kp_select"][0]
    kernels.reset_counts()
    fast.select_keypoints_levels(*a, **k)
    out = {"ok": bool(on_valid), "every_slot_equal": bool(every_slot), "calls": n,
           "launches_per_call": kernels.COUNTS["kp_select"]}
    names = ("orb_8_levels", "lsd_octave0", "lsd_octave1")
    for name, (a, k) in zip(names, frames[200]["kp_select"]):
        out[name] = timed(cs, lambda: fast.select_keypoints_levels(*a, **k), reps)
    out["frame"] = timed(cs, lambda: [fast.select_keypoints_levels(*a, **k)
                                      for a, k in frames[200]["kp_select"]], reps)
    # the batch entry: frames 200 and 225's ORB maps as [2, H, W] stacks
    (sr200, *rest), k = frames[200]["kp_select"][0]
    sr225 = frames[225]["kp_select"][0][0][0]
    stacked = [(torch.stack([s0, s1]), torch.stack([r0, r1]))
               for (s0, r0), (s1, r1) in zip(sr200, sr225)]
    one = [fast.select_keypoints_levels(sr, *rest, **k) for sr in (sr200, sr225)]
    both = fast.select_keypoints_levels(stacked, *rest, **k)
    out["batch_equal"] = all(torch.equal(x[b], y) for lv, (xb, o0, o1) in
                             enumerate(zip(both, *one)) for b, ob in enumerate((o0, o1))
                             for x, y in zip(xb, ob))
    out["ok"] = out["ok"] and out["batch_equal"]
    out["batch_2_frames"] = timed(
        cs, lambda: fast.select_keypoints_levels(stacked, *rest, **k), reps)
    return out


def record_ba_window(path: str) -> None:
    """The main path's largest local BA window: the lines path (bootstrap +
    200 frames of the bench scene, `chip_smoke.drive`) with the tree's port,
    its `bundle_adjust` calls recorded; the one with the most valid
    keyframes saved to `path` (CPU tensors)."""
    import torch

    import chip_smoke as cs
    from structure_slam_pointline_tpu_torch.config import CameraConfig, SLAMConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.optim import local_ba

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(n_points=350, n_lines=40, seed=0)
    poses = synthetic.circular_trajectory(10 + 6 * 100, radius=0.5)

    def frame(i):
        return synthetic.render(scene, poses[i], cam, noise=2.0, seed=i)

    with cs.Recorder(local_ba, "bundle_adjust",
                     lambda prob, *a, **kw: ("ba", int(prob.kf_valid.sum()))) as rec:
        cs.drive(SLAMConfig(camera=cam), 200, frame, poses, "lines (kernel_ab)")
    key = max(rec.calls, key=lambda k: k[1])
    args, kw = rec.calls[key]

    def cpu(a):
        if isinstance(a, torch.Tensor):
            return a.cpu()
        if hasattr(a, "_fields") and all(isinstance(x, torch.Tensor) for x in a):
            return type(a)(*[x.cpu() for x in a])
        return a

    torch.save({"args": [cpu(a) for a in args], "kw": {k: cpu(v) for k, v in kw.items()},
                "calls": {str(k): n for k, n in rec.n.items()}}, path)


def ba_trace(calls: dict) -> dict:
    """Kernel 12 on each call through a copy of `csrc/local_ba.cu` built
    with -DSSPL_BA_TRACE (into the root's build/): the one-launch form (up
    to 16 keyframes) with the cycles between rank 0's barriers by phase,
    summed over the call, and the 64 warps' mean cycles in their landmark
    steps and in those steps' pair sums; the chain (64 keyframes) with its
    `ba_solve` launches' assembly (with the cost sum) and solve."""
    import ctypes
    import subprocess

    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.optim import local_ba

    out_lib = os.path.join(kernels.BUILD_DIR, "libsspl_local_ba_trace.so")
    cmd = kernels._nvcc_cmd("local_ba.cu", out_lib)
    subprocess.run(cmd[:1] + ["-DSSPL_BA_TRACE"] + cmd[1:], check=True, capture_output=True)
    lib = ctypes.CDLL(out_lib)
    for entry in kernels.ENTRIES["local_ba"] + ("dense_solve",):
        getattr(lib, f"sspl_{entry}").argtypes = kernels._ARGTYPES[entry]
    normal = kernels.lib("local_ba")
    source = kernels.SOURCES["local_ba"]
    phases = ("setup", "landmarks", "block_sums", "assembly", "solve", "backsub", "classify",
              "edges")
    out = {}
    for name, ((prob, intr, cfg), kw) in calls.items():
        tr = torch.zeros(16, dtype=torch.int64, device=prob.kf_T_cw.device)
        one = prob.edge_mp.shape[0] <= local_ba.ONE_LAUNCH_KEYFRAMES
        kernels._LIBS[source] = lib
        try:
            if one:
                local_ba._persist_ba("bundle_adjust", prob, intr, cfg, kw.get("lines"), trace=tr)
            else:
                local_ba._kernel_ba("bundle_adjust", prob, intr, cfg, kw.get("lines"), None,
                                    trace=tr)
            torch.cuda.synchronize()
        finally:
            kernels._LIBS[source] = normal
        t = tr.cpu().tolist()
        cyc = {p: c for p, c in zip(phases, t[:8]) if one or p in ("assembly", "solve")}
        out[name] = {"form": "one launch" if one else "chain (ba_solve launches)",
                     "cycles": cyc, "total_cycles": sum(cyc.values())}
        if one:
            out[name].update(warp_step_cycles_mean=t[8] / 64, warp_pair_cycles_mean=t[9] / 64)
    return out


def case_local_ba(cs, reps: int, _systems, trace=False, window=None) -> dict:
    """Kernel 12 on the main path's recorded window (`record_ba_window`) and
    on global BA's 64-keyframe shape (`tests/test_torch_kernels_gpu.py
    ba_problem` at 64 keyframes, 16384 points, 1024 lines, the last 8
    slots invalid): poses and landmarks within 1e-3 of `bundle_adjust_plain`,
    masks equal on >= 99.5% of edges, two calls bit-identical; launches a
    call, device ms by launch name and caller ms; with --trace, `ba_trace`
    of the window (roots whose source has the marks)."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.optim import local_ba
    from test_torch_kernels_gpu import _to, ba_problem
    from structure_slam_pointline_tpu_torch.config import OptimConfig

    def cuda(a):
        if isinstance(a, torch.Tensor):
            return a.cuda()
        if hasattr(a, "_fields") and all(isinstance(x, torch.Tensor) for x in a):
            return _to(a, "cuda")
        return a

    saved = torch.load(window, weights_only=False)
    win = ([cuda(a) for a in saved["args"]], {k: cuda(v) for k, v in saved["kw"].items()})
    prob, lines, intr = ba_problem(KL=64, PL=16384, LL=1024, F=1024, LF=64)
    prob = _to(prob._replace(kf_valid=torch.arange(64) < 56), "cuda")
    kl64 = ([prob, intr, OptimConfig()], {"lines": _to(lines, "cuda")})
    out = {}
    for name, (args, kw) in (("window", win), ("kl64", kl64)):
        run = lambda: local_ba.bundle_adjust(*args, **kw)  # noqa: E731
        kernels.reset_counts()
        rk = run()
        launches = kernels.COUNTS["local_ba"]
        rk2 = run()
        rp = local_ba.bundle_adjust_plain(*args, **kw)
        err = max((a - b).abs().max().item() for a, b in zip(
            (rk.kf_T_cw, rk.mp_xyz, rk.ln_start, rk.ln_end),
            (rp.kf_T_cw, rp.mp_xyz, rp.ln_start, rp.ln_end)) if a is not None)
        masks = min((a == b).float().mean().item() for a, b in
                    ((rk.edge_inlier, rp.edge_inlier), (rk.line_inlier, rp.line_inlier))
                    if a is not None)
        same = all(torch.equal(a, b) for a, b in zip(rk, rk2) if a is not None)
        p0 = args[0]
        ln = kw.get("lines")
        out[name] = {"ok": err <= 1e-3 and masks >= 0.995 and same, "max_abs_err": err,
                     "masks_equal": masks, "bit_identical": same, "launches": launches,
                     "keyframes": int(p0.kf_valid.sum()), "free": int(p0.kf_free.sum()),
                     "rows": int(p0.edge_valid.sum()) + (2 * int(ln.edge_valid.sum())
                                                          if ln is not None else 0),
                     **timed(cs, run, reps)}
    out["window"]["recorded_calls"] = saved["calls"]
    if trace:
        out["trace"] = ba_trace({"window": win, "kl64": kl64})
    return out


def pyr_trace(img, args) -> dict:
    """Kernel 25 on one input through a copy of `csrc/pyramid.cu` built with
    -DSSPL_PYR_TRACE (into the root's build/): block 0's cycles per phase
    on its own tiles and in the grid barrier after them."""
    import ctypes
    import subprocess

    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.ops import pyramid

    out_lib = os.path.join(kernels.BUILD_DIR, "libsspl_pyramid_trace.so")
    cmd = kernels._nvcc_cmd("pyramid.cu", out_lib)
    subprocess.run(cmd[:1] + ["-DSSPL_PYR_TRACE"] + cmd[1:], check=True, capture_output=True)
    lib = ctypes.CDLL(out_lib)
    lib.sspl_pyramid.argtypes = kernels._ARGTYPES["pyramid"]
    source = kernels.SOURCES["pyramid"]
    normal = kernels.lib("pyramid")
    n_levels, scale, sigma = args
    shapes = pyramid.level_shapes(*img.shape[-2:], n_levels, scale)
    tr = torch.zeros(2 * pyramid.MAX_LEVELS + 2, dtype=torch.int64, device=img.device)
    kernels._LIBS[source] = lib
    try:
        pyramid._launch(img, shapes, 0, True, sigma, trace=tr)
        torch.cuda.synchronize()
    finally:
        kernels._LIBS[source] = normal
    t = tr.cpu().tolist()
    phases = {f"phase{q}": {"tiles": t[2 * q], "barrier": t[2 * q + 1]}
              for q in range(1, n_levels + 1)}
    return {"phases": phases, "total_cycles": sum(t)}


def case_pyramid(cs, reps: int, _systems, trace=False, **_) -> dict:
    """Kernel 25 on bench frames 0, 40 and 200 (640x480, the frontend's 8
    levels at 1.2) and on frames 40 and 200 stacked: every level and
    blurred plane bit-equal to `build_blurred_pyramid_plain`; C calls and
    device kernels a call; device and caller ms a frame and for the
    stack."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import pyramid

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(610, radius=0.5)
    fe = FrontendConfig()
    imgs = {f: torch.from_numpy(synthetic.render(scene, poses[f], cam, noise=2.0, seed=f))
            .cuda().to(torch.bfloat16) for f in (0, 40, 200)}
    inputs = {f"frame{f}": x for f, x in imgs.items()}
    inputs["stack_40_200"] = torch.stack([imgs[40], imgs[200]])
    args = (fe.n_levels, fe.scale_factor, fe.blur_sigma)
    out = {"ok": True}
    for name, x in inputs.items():
        run = lambda: pyramid.build_blurred_pyramid(x, *args)  # noqa: E731
        kernels.reset_counts()
        lk, bk = run()
        calls = kernels.COUNTS["pyramid"]
        lp, bp = pyramid.build_blurred_pyramid_plain(x, *args)
        differ = sum(int((a != b).sum()) for a, b in zip(lk + bk, lp + bp))
        t = timed(cs, run, reps)
        out[name] = {"differ_px": differ, "c_calls": calls,
                     "device_kernels": len(t["by_kernel"]), **t}
        out["ok"] = out["ok"] and differ == 0
    if trace:
        out["trace"] = {name: pyr_trace(x, args) for name, x in inputs.items()
                        if name in ("frame40", "stack_40_200")}
    return out


def bench_levels(frames=(0, 40, 200)) -> dict:
    """The levels and blurred levels of bench frames (640x480, the
    frontend's 8 levels at 1.2), made by the root's kernel 25, and of
    frames 40 and 200 stacked."""
    import torch

    from structure_slam_pointline_tpu_torch.config import CameraConfig, FrontendConfig
    from structure_slam_pointline_tpu_torch.io import synthetic
    from structure_slam_pointline_tpu_torch.ops import pyramid

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_room_scene(350, 40, seed=0)
    poses = synthetic.circular_trajectory(610, radius=0.5)
    fe = FrontendConfig()
    imgs = {f: torch.from_numpy(synthetic.render(scene, poses[f], cam, noise=2.0, seed=f))
            .cuda().to(torch.bfloat16) for f in frames}
    inputs = {f"frame{f}": x for f, x in imgs.items()}
    inputs["stack_40_200"] = torch.stack([imgs[40], imgs[200]])
    return {name: pyramid.build_blurred_pyramid(x, fe.n_levels, fe.scale_factor,
                                                fe.blur_sigma)
            for name, x in inputs.items()}


def case_fast(cs, reps: int, _systems, **_) -> dict:
    """Kernel 1 on bench frames 0, 40 and 200 and on frames 40 and 200
    stacked: every level's raw and NMS maps bit-equal to
    `fast_score_nms_plain`; C calls (launches) a frame and device and
    caller ms a frame, by launch name. A root without the per-frame entry
    (`fast_score_nms_levels`) runs its per-level calls."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.ops import fast

    per_frame = hasattr(fast, "fast_score_nms_levels")
    out = {"ok": True, "per_frame_entry": per_frame}
    for name, (levels, _) in bench_levels().items():
        if per_frame:
            run = lambda: fast.fast_score_nms_levels(levels)  # noqa: E731
        else:
            run = lambda: [fast.fast_score_nms(lv) for lv in levels]  # noqa: E731
        kernels.reset_counts()
        maps = run()
        calls = sum(kernels.COUNTS[k] for k in ("fast_nms", "fast_nms_batch"))
        differ = sum(int((a != b).sum()) for lv, km in zip(levels, maps)
                     for a, b in zip(km, fast.fast_score_nms_plain(lv)))
        out[name] = {"differ_px": differ, "c_calls": calls,
                     "px": sum(lv.numel() for lv in levels), **timed(cs, run, reps)}
        out["ok"] = out["ok"] and differ == 0
    return out


def case_orb(cs, reps: int, _systems, **_) -> dict:
    """Kernel 2 on the keypoints of bench frames 0, 40 and 200 and of
    frames 40 and 200 stacked (the frontend's 1024 a frame, selected by
    the root's kernels 1 and 11): descriptors equal to the plain version's
    on >= 99.5% and angles within 1e-4 (the card's gates), level-0 xy and
    octaves equal; C calls (launches) a frame and device and caller ms by
    launch name, of the kernel alone (`kernel`) and with the per-level
    glue that a root without the per-frame entry
    (`orient_and_describe_levels`) runs around its per-level calls (the
    level-0 products, the octave fills and the concatenations,
    `with_glue`)."""
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.config import FrontendConfig
    from structure_slam_pointline_tpu_torch.ops import extract, fast, orb, pyramid

    fe = FrontendConfig()
    ks = extract.level_budgets(fe.n_keypoints, fe.n_levels, fe.scale_factor)
    scales = [float(s) for s in pyramid.level_scales(fe.n_levels, fe.scale_factor)]
    octaves = list(range(fe.n_levels))
    kw = dict(cell=fe.cell_size, cell_cap=8, threshold=fe.fast_threshold,
              min_threshold=fe.fast_min_threshold, border=orb.PATCH_RADIUS + 1)
    per_frame = hasattr(orb, "orient_and_describe_levels")
    out = {"ok": True, "per_frame_entry": per_frame}
    for name, (levels, blurred) in bench_levels().items():
        maps = [fast.fast_score_nms(lv) for lv in levels]
        sel = fast.select_keypoints_levels([(n, r) for r, n in maps], ks, **kw)
        xys = [x.contiguous() for x, _, _ in sel]
        xy = torch.cat(xys, dim=-2)
        lead = tuple(xy.shape[:-2])
        args = (blurred, xy, ks, scales, octaves)
        plain = orb.orient_and_describe_levels_plain(*args) if per_frame else None
        if per_frame:
            kernel = lambda: orb.orient_and_describe_levels(*args)  # noqa: E731
            glue = kernel
        else:
            kernel = lambda: [orb.orient_and_describe(bl, x)  # noqa: E731
                              for bl, x in zip(blurred, xys)]

            def glue():
                parts = [(a, d, x * s, torch.full(lead + (k,), o, dtype=torch.int32,
                                                   device=x.device))
                         for (a, d), x, k, s, o in zip(kernel(), xys, ks, scales, octaves)]
                return tuple(torch.cat([p[i] for p in parts], dim=len(lead))
                             for i in range(4))
        kernels.reset_counts()
        res = glue()
        calls = sum(kernels.COUNTS[k] for k in ("orb_describe", "orb_describe_batch"))
        if plain is None:
            pl = [orb.orient_and_describe_plain(bl, x) for bl, x in zip(blurred, xys)]
            plain = (torch.cat([p[0] for p in pl], dim=len(lead)),
                     torch.cat([p[1] for p in pl], dim=len(lead)), res[2], res[3])
        desc_eq = (res[1] == plain[1]).all(-1).float().mean().item()
        ang_err = (res[0] - plain[0]).abs().max().item()
        same = torch.equal(res[2], plain[2]) and torch.equal(res[3], plain[3])
        ok = desc_eq >= 0.995 and ang_err <= 1e-4 and same
        out[name] = {"ok": ok, "desc_equal": desc_eq, "angle_err": ang_err,
                     "xy0_octave_equal": same, "keypoints": xy.numel() // 2,
                     "c_calls": calls, "kernel": timed(cs, kernel, reps),
                     "with_glue": timed(cs, glue, reps)}
        out["ok"] = out["ok"] and ok
    return out


CASES = {"ransac_pnp": case_ransac_pnp, "lsd_support": case_lsd_support,
         "pose_lm": case_pose_lm, "lsd_refine": case_lsd_refine,
         "dense_solve": case_dense_solve, "lsd_merge": case_lsd_merge,
         "kp_select": case_kp_select, "local_ba": case_local_ba, "pyramid": case_pyramid,
         "fast": case_fast, "orb": case_orb}
# the kernels a case runs, where its name is not the kernel's (built and
# reported by -Xptxas -v before the case)
CASE_KERNELS = {"fast": ("pyramid", "fast_nms"),
                "orb": ("pyramid", "fast_nms", "kp_select", "orb_describe")}


def one_root(root: str, names, reps: int, systems, trace: bool = False,
             window: str | None = None) -> dict:
    # the timing helpers and the test inputs from here, the port from the
    # root (chip_smoke puts its own directory first on the path: the root
    # goes before it)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path[:0] = [root, os.path.join(HERE, "tests")]
    from structure_slam_pointline_tpu_torch import kernels

    port = os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
    if port != root:
        raise RuntimeError(f"kernel_ab: imported the port from {port}, not {root}")

    reports = kernels.build_all(sorted({k for n in names for k in CASE_KERNELS.get(n, (n,))}))
    for src, log in sorted(reports.items()):
        lines = [ln for ln in log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "stack frame" in ln]
        print(f"[ptxas] {root} {src}:\n  " + "\n  ".join(lines), flush=True)
    res = {"root": root, "ptxas": {src: [ln.strip() for ln in log.splitlines()
                                         if "Used" in ln or "spill" in ln]
                                   for src, log in reports.items()}}
    for n in names:
        if n == "lsd_merge":
            res[n] = case_lsd_merge(cs, reps, systems,
                                    trace=trace and _traceable(root, "lsd_merge.cu",
                                                               "SSPL_LSD_TRACE"))
        elif n == "pyramid":
            res[n] = case_pyramid(cs, reps, systems,
                                  trace=trace and _traceable(root, "pyramid.cu",
                                                             "SSPL_PYR_TRACE"))
        elif n == "local_ba":
            res[n] = case_local_ba(cs, reps, systems, window=window,
                                   trace=trace and _traceable(root, "local_ba.cu",
                                                              "SSPL_BA_TRACE"))
        else:
            res[n] = CASES[n](cs, reps, systems)
    return res


def _traceable(root: str, source: str, mark: str) -> bool:
    """Whether the root's source has the trace marks."""
    with open(os.path.join(root, "structure_slam_pointline_tpu_torch", "csrc", source)) as f:
        return mark in f.read()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kernels", nargs="+", choices=sorted(CASES), default=sorted(CASES))
    ap.add_argument("--systems", nargs="+", default=list(SYSTEMS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--trace", action="store_true",
                    help="lsd_merge: per-phase cycles and row popcounts; local_ba, pyramid: "
                         "per-phase cycles (roots with the marks)")
    ap.add_argument("--window", default=os.path.join(HERE, "build", "ba_window.pt"),
                    help="local_ba: the recorded main-path window (made if missing)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--record", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.record:
        sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
        record_ba_window(a.window)
        return 0
    if a.one:
        res = one_root(os.path.abspath(a.roots[0]), a.kernels, a.reps, a.systems, a.trace,
                       a.window)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if "local_ba" in a.kernels and not os.path.exists(a.window):
        os.makedirs(os.path.dirname(os.path.abspath(a.window)), exist_ok=True)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), HERE, "--record",
                            "--window", a.window], capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        print("\n".join(ln for ln in p.stdout.splitlines() if ln.startswith("[e2e")), flush=True)
        if p.returncode != 0:
            print("kernel_ab: recording the BA window failed", file=sys.stderr)
            return 1
    results, rc = [], 0
    for root in a.roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--one",
                            "--reps", str(a.reps), "--kernels", *a.kernels,
                            "--systems", *a.systems, "--window", a.window]
                           + (["--trace"] if a.trace else []),
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        res = None
        for ln in p.stdout.splitlines():
            if ln.startswith("RESULT "):
                res = json.loads(ln[7:])
                results.append(res)
                ln = ln[7:]
            print(ln, flush=True)
        if p.returncode != 0 or res is None:
            print(f"kernel_ab: {root} failed ({p.returncode})", file=sys.stderr)
            rc = 1
        elif not all(v["ok"] for n in a.kernels for v in _checked(res[n])):
            print(f"kernel_ab: {root} disagrees with its plain versions", file=sys.stderr)
            rc = 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    return rc


def _checked(case: dict) -> list:
    """A case's results that carry an `ok`: its sub-results, or itself."""
    if "ok" in case:
        return [case]
    return [v for v in case.values() if isinstance(v, dict) and "ok" in v]


if __name__ == "__main__":
    sys.exit(main())
