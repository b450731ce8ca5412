"""Dataset driver: run the port's SLAM system on a TUM / ICL-NUIM sequence.

Counterpart of the JAX package's `examples/run_slam.py`, with the same
flags, outputs and printout, plus `--device`:

    python -m structure_slam_pointline_tpu_torch.run_slam --seq PATH
        [--config icl|tum3] [--manifest rgb.txt] [--out-dir out]
        [--max-frames N] [--realtime] [--viz] [--device cuda|cpu]

`--seq` is a sequence directory in TUM layout (`rgb.txt` and the images
it lists) or an ICL manifest file. Frames are decoded by the native
prefetching loader (`io/native_loader.py`; `make -C native` builds it at
first use) and fed to `SLAMSystem.track()` one by one. Writes
`MonoTrajectory.txt` and `KeyFrameTrajectory.txt` (TUM format) into
`--out-dir`; `--viz` also renders the final map (`map.png`, matplotlib).
The device defaults to CUDA; `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from structure_slam_pointline_tpu_torch.config import SLAMConfig, icl_nuim_config, tum3_config
from structure_slam_pointline_tpu_torch.io import datasets, native_loader
from structure_slam_pointline_tpu_torch.models.system import SLAMSystem


def run(cfg: SLAMConfig, seq_path: str, manifest: str = "rgb.txt", out_dir: str = "out",
        max_frames: int = 0, realtime: bool = False, viz: bool = False,
        device=None) -> dict:
    """Track a sequence from disk and write its trajectories. Returns the
    system, the loader's decoder, the per-frame `track()` seconds and the
    wall seconds of the loop."""
    if os.path.isdir(seq_path):
        seq = datasets.load_tum_rgb_manifest(seq_path, manifest)
    else:
        seq = datasets.load_icl_manifest(seq_path)
    n = len(seq) if max_frames <= 0 else min(len(seq), max_frames)
    print(f"sequence: {n} frames")

    slam = SLAMSystem(cfg, device=device)
    loader = native_loader.PrefetchingLoader(seq.image_paths[:n], n_threads=3, ring=8)
    frame_dt = 1.0 / cfg.camera.fps

    t_start = time.time()
    times = []
    for i, img in loader:
        t0 = time.time()
        slam.track(img, i)
        dt = time.time() - t0
        times.append(dt)
        if realtime and dt < frame_dt:
            time.sleep(frame_dt - dt)
        if i % 100 == 0:
            e = slam.log[-1]
            print(f"frame {i}: {e.state.name} inliers={e.n_inliers} "
                  f"({1.0 / max(dt, 1e-6):.1f} fps inst)")
    loader.close()
    slam.shutdown()   # the device's work done, the cursors synced
    total = time.time() - t_start

    os.makedirs(out_dir, exist_ok=True)
    ts = seq.timestamps
    slam.save_trajectory_tum(os.path.join(out_dir, "MonoTrajectory.txt"), ts)
    # the keyframe trajectory from the map itself
    slam.save_keyframe_trajectory_tum(os.path.join(out_dir, "KeyFrameTrajectory.txt"), ts)

    tracked = sum(1 for e in slam.log if e.T_cw is not None)
    med = float(np.median(times)) if times else float("nan")
    print(f"tracked {tracked}/{n} frames | median frame time {med*1000:.1f} ms "
          f"({1.0/max(med,1e-9):.1f} fps) | wall {total:.1f}s | "
          f"KFs {slam.cur.n_kf} points {slam.cur.n_mp}")

    if viz:
        from structure_slam_pointline_tpu_torch.viz import viewer

        traj = slam.trajectory()
        ids = sorted(traj.keys())
        T_wc = np.stack([np.linalg.inv(traj[i]) for i in ids]) if ids else None
        viewer.draw_map(slam.map, slam.cur.n_kf, os.path.join(out_dir, "map.png"), trajectory=T_wc)
        print(f"map render: {out_dir}/map.png")
    return {"slam": slam, "decoder": loader.decoder, "frames": n, "track_s": times,
            "wall_s": total}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True,
                    help="sequence directory (TUM layout) or ICL manifest file")
    ap.add_argument("--config", default="icl", choices=["icl", "tum3"])
    ap.add_argument("--manifest", default="rgb.txt")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--realtime", action="store_true",
                    help="sleep to the camera frame rate like the reference driver")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the CUDA device")
    args = ap.parse_args(argv)
    cfg = icl_nuim_config() if args.config == "icl" else tum3_config()
    run(cfg, args.seq, args.manifest, args.out_dir, args.max_frames, args.realtime, args.viz,
        args.device)


if __name__ == "__main__":
    main()
