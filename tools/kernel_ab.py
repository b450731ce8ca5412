#!/usr/bin/env python3
"""Kernels of several checkouts, alternated on one GPU: each checked against
its plain version, then timed by launch name beside a PyTorch call for the
same work.

    python3 tools/kernel_ab.py ROOT [ROOT ...] [--kernels NAME ...]
                               [--systems N:CAP ...] [--reps 20] [--out FILE]

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
- dense_solve: per N:CAP (`--systems`), a damped J^T J + 1e-3 I of N rows
  and a random right side (numpy, seed 1, drawn in the order given) at a
  capacity of CAP rows (which picks the panel width); pivots and x against
  `lu_solve_blocked_plain` (bit for bit), timed beside torch.linalg.solve.

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


CASES = {"ransac_pnp": case_ransac_pnp, "lsd_support": case_lsd_support,
         "dense_solve": case_dense_solve}


def one_root(root: str, names, reps: int, systems) -> dict:
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

    reports = kernels.build_all(names)
    for src, log in sorted(reports.items()):
        lines = [ln for ln in log.splitlines()
                 if "Compiling entry" in ln or "Used" in ln or "stack frame" in ln]
        print(f"[ptxas] {root} {src}:\n  " + "\n  ".join(lines), flush=True)
    return {"root": root, **{n: CASES[n](cs, reps, systems) for n in names}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kernels", nargs="+", choices=sorted(CASES), default=sorted(CASES))
    ap.add_argument("--systems", nargs="+", default=list(SYSTEMS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        res = one_root(os.path.abspath(a.roots[0]), a.kernels, a.reps, a.systems)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    results, rc = [], 0
    for root in a.roots:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--one",
                            "--reps", str(a.reps), "--kernels", *a.kernels,
                            "--systems", *a.systems], capture_output=True, text=True)
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
        elif not all(v["ok"] for n in a.kernels for v in res[n].values()):
            print(f"kernel_ab: {root} disagrees with its plain versions", file=sys.stderr)
            rc = 1
    if a.out:
        with open(a.out, "w") as f:
            json.dump(results, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
