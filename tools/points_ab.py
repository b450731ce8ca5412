#!/usr/bin/env python3
"""One scenario of two checkouts of the port, alternated on one GPU.

    python3 tools/points_ab.py OLD_ROOT NEW_ROOT [--scenario points|lines|loop]
        [--frames 200] [--repeats 2] [--out FILE]

Each root is a checkout of this repository (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and this tree).
The runs go old, new, new, old, each in a process of its own that imports
the port (and, for `loop`, chip_smoke.py) from its root and builds that
root's kernels into its `build/`. The scenarios:

- `points` (the default): the bench scene of chip_smoke.py at 640x480 with
  `SLAMConfig(camera=CameraConfig(fy=480.0), use_lines=False)`: bootstrap
  through `track()` (within 90 frames), then `--frames` frames through
  `track_sequence()`. One JSON line per run (root, init frame, tracked
  fps, ATE-Sim3, tracked frames, keyframes, points, the launch counts).
- `lines`: the same scene with lines on (`SLAMConfig(camera=...)`, the main
  path): bootstrap, `--frames` frames through `track_sequence()`, then 20
  more under torch.profiler (device kernels and device-busy ms per frame,
  wall ms per frame) and one more through chip_smoke.py's
  `pageable_copies` (of the tree this tool runs from): its pageable
  host-to-device copies grouped by the line of the port that issued them,
  and its device kernels linked to torch ops, counted and by name (the
  port's own kernels, launched through ctypes, link to no op and are not
  among them).
  One JSON line per run (as `points`, plus those numbers).
- `loop`: chip_smoke.py's phase 2d with loop closing on (`loop_scenario`,
  `run_loop`: the reference's loop test), `--repeats` times in the one
  process, so the first run carries each kernel's first launch and the
  later ones do not. One JSON line per repeat: the root, the repeat,
  ATE-Sim3, tracked frames, the run's seconds and every correction's wall
  ms with its detect / verify / correct / global BA split.

`--out` also writes all the lines to a file. Exits nonzero if a run fails
(or, for `points`, does not initialize).
"""

import argparse
import json
import os
import subprocess
import sys

TOOL_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROFILE = r"""
from torch.profiler import ProfilerActivity, profile

j0 = i + FRAMES
prof_seq = np.stack([frame(j) for j in range(j0, j0 + 20)])
torch.cuda.synchronize()
t0 = time.time()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    slam.track_sequence(prof_seq, j0)
    torch.cuda.synchronize()
wall = (time.time() - t0) * 1e3 / 20
evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
busy = sum(getattr(e, "self_device_time_total", 0) or 0 for e in evs) / 1e3 / 20
n_k = sum(e.count for e in evs) / 20
saved_path = list(sys.path)   # chip_smoke.py of the tree this tool runs from
sys.path.insert(0, TOOL_ROOT)
import chip_smoke as tool_smoke
sys.path[:] = saved_path
copies = tool_smoke.pageable_copies(slam, frame(j0 + 20), j0 + 20)
result.update(profile_wall_ms_per_frame=wall, device_busy_ms_per_frame=busy,
              device_kernels_per_frame=n_k,
              pageable_htod_per_frame=copies["pageable_htod_per_frame"],
              pageable_htod_by_line=copies["by_line"],
              labelled_frame_kernels_linked=copies["device_kernels_linked"],
              labelled_frame_kernels_by_name=copies["device_kernels_by_name"])
"""

RUN = {"points": r"""
import json, sys, time
import numpy as np
sys.path.insert(0, ROOT)
import torch
from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import CameraConfig, SLAMConfig
from structure_slam_pointline_tpu_torch.io import synthetic
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem

kernels.build_all()
cam = CameraConfig(fy=480.0)
scene = synthetic.make_room_scene(n_points=350, n_lines=40, seed=0)
poses = synthetic.circular_trajectory(10 + 6 * 100, radius=0.5)
frame = lambda i: synthetic.render(scene, poses[i], cam, noise=2.0, seed=i)
slam = SLAMSystem(SLAMConfig(camera=cam, use_lines=LINES == 1))
kernels.reset_counts()
i = 0
while slam.carry is None and i < 90:
    slam.track(frame(i), i)
    i += 1
if slam.carry is None:
    sys.exit("no initialization within 90 frames")
seq = np.stack([frame(j) for j in range(i, i + FRAMES)])
torch.cuda.synchronize()
t0 = time.time()
T, ok, inl, iskf = slam.track_sequence(seq, i)
torch.cuda.synchronize()
dt = time.time() - t0
traj = slam.trajectory()
ids = sorted(traj)
est = np.stack([np.linalg.inv(traj[k]) for k in ids])
result = {"root": ROOT, "init_frame": i - 1, "frames": FRAMES, "fps": FRAMES / dt,
          "ate_sim3": synthetic.ate_rmse(est, poses[ids]), "tracked": int(ok.sum()),
          "keyframes": slam.cur.n_kf, "points": slam.cur.n_mp,
          "live_points": int(slam.map.mp_valid.sum()), "launches": dict(kernels.COUNTS)}
if LINES:
    exec(PROFILE)
print(json.dumps(result))
""", "loop": r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
import chip_smoke
from structure_slam_pointline_tpu_torch import kernels
from structure_slam_pointline_tpu_torch.config import CameraConfig

kernels.build_all()
cam = CameraConfig(fy=480.0)
imgs, poses = chip_smoke.loop_scenario(cam)
for rep in range(REPEATS):
    res = chip_smoke.run_loop(cam, imgs, poses, True, sync=torch.cuda.synchronize)
    res.pop("slam", None)
    print(json.dumps({"root": ROOT, "repeat": rep, **{k: res.get(k) for k in (
        "ate_sim3", "tracked", "frames", "seconds", "loop_corrected", "corrections",
        "error")}}))
"""}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    ap.add_argument("--scenario", choices=sorted(RUN) + ["lines"], default="points")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    results = []
    for root in (args.old_root, args.new_root, args.new_root, args.old_root):
        root = os.path.abspath(root)
        code = (f"ROOT = {root!r}\nTOOL_ROOT = {TOOL_ROOT!r}\nFRAMES = {args.frames}\n"
                f"REPEATS = {args.repeats}\n"
                f"LINES = {int(args.scenario == 'lines')}\nPROFILE = {PROFILE!r}\n"
                + RUN["points" if args.scenario == "lines" else args.scenario])
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=900, cwd=root)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                results.append(json.loads(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r.get("error") is None for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
