#!/usr/bin/env python3
"""Landmark-sharded BA across processes: N ranks, one device each.

    python3 tools/mesh_ranks.py [--ranks 4] [--shards-per-rank 2] [--device cuda|cpu]

Starts N processes (spawned); each joins the group with
`initialize_multihost` (NCCL on its own card, `local_device_ids=[rank]`, or
gloo on the CPU), builds `global_edge_mesh(N x S)` and runs
`shard_bundle_adjust` on the same seeded problem: 16 keyframes (the second
half free), 2049 points and 257 lines seen by 3-6 keyframes each with pixel
noise and 5% outliers, free poses and landmarks perturbed (the shapes of
the `gpu` test of kernel 12's sharded form). Rank 0 then checks that

- every rank's result is bit-equal to its own (the same all_reduce sum
  feeds every rank's replicated solve);
- it agrees with one process's mesh of N x S shards on rank 0's device,
  and with the unsharded BA, within 1e-3 (poses, points, line endpoints;
  inlier masks on >= 99.5% of edges): the group sums the ranks' partials
  in another order than one process sums its shards;

and prints one JSON line: the cards' names and power limits (nvidia-smi),
the errors, and each rank's caller ms of one call (median of 5, host
clock around a synchronized call). Exits 1 if a check fails.
"""

import argparse
import json
import os
import socket
import statistics
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def ba_problem(seed=7, KL=16, PL=2049, LL=257, F=2048, LF=128):
    """(BAProblem, BALineProblem, Intrinsics) on the CPU, seeded with numpy."""
    from structure_slam_pointline_tpu_torch.config import CameraConfig
    from structure_slam_pointline_tpu_torch.optim import local_ba
    from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

    g = np.random.default_rng(seed)
    intr = Intrinsics.from_config(CameraConfig(fy=480.0))
    Ts = []
    for k in range(KL):
        a = 0.6 * (k / (KL - 1) - 0.5)
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        C = np.array([2.0 * np.sin(a), 0.1 * np.cos(3 * a), -2.0 * (1 - np.cos(a))])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, -R @ C
        Ts.append(T)
    Ts = np.stack(Ts)

    def box(n):
        return np.stack([g.uniform(-2, 2, n), g.uniform(-1.5, 1.5, n), g.uniform(4, 8, n)], 1)

    def proj(T, X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([intr.fx * pc[:, 0] / pc[:, 2] + intr.cx,
                         intr.fy * pc[:, 1] / pc[:, 2] + intr.cy], 1)

    pts, ls, le = box(PL), box(LL), box(LL)
    obs_uv, edge_mp = np.zeros((KL, F, 2)), -np.ones((KL, F), np.int64)
    fill = np.zeros(KL, np.int64)
    for j in range(PL):
        for k in g.choice(KL, g.integers(3, 7), replace=False):
            uv = proj(Ts[k], pts[j:j + 1])[0] + g.normal(0, 0.8, 2)
            if g.uniform() < 0.05:
                uv += g.uniform(-25, 25, 2)
            if fill[k] < F:
                edge_mp[k, fill[k]], obs_uv[k, fill[k]] = j, uv
                fill[k] += 1
    obs_l, edge_ln = np.zeros((KL, LF, 3)), -np.ones((KL, LF), np.int64)
    lfill = np.zeros(KL, np.int64)
    for j in range(LL):
        for k in g.choice(KL, g.integers(3, 6), replace=False):
            us = proj(Ts[k], ls[j:j + 1])[0] + g.normal(0, 0.5, 2)
            ue = proj(Ts[k], le[j:j + 1])[0] + g.normal(0, 0.5, 2)
            ln = np.cross(np.r_[us, 1.0], np.r_[ue, 1.0])
            if lfill[k] < LF:
                edge_ln[k, lfill[k]], obs_l[k, lfill[k]] = j, ln / np.hypot(ln[0], ln[1])
                lfill[k] += 1
    free = np.arange(KL) >= KL // 2
    Tp = Ts.copy()
    Tp[free, :3, 3] += g.normal(0, 0.02, (int(free.sum()), 3))

    def f(x, dt=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dt)

    prob = local_ba.BAProblem(
        kf_T_cw=f(Tp), kf_free=f(free, torch.bool), kf_valid=torch.ones(KL, dtype=torch.bool),
        obs_uv=f(obs_uv), obs_sigma2=f(np.ones((KL, F))), edge_mp=f(edge_mp, torch.int32),
        edge_valid=f(edge_mp >= 0, torch.bool), mp_xyz=f(pts + g.normal(0, 0.01, pts.shape)),
        mp_valid=torch.ones(PL, dtype=torch.bool))
    lines = local_ba.BALineProblem(
        ln_start=f(ls + g.normal(0, 0.01, ls.shape)), ln_end=f(le + g.normal(0, 0.01, le.shape)),
        ln_valid=torch.ones(LL, dtype=torch.bool), obs_l=f(obs_l),
        obs_sigma2=f(np.full((KL, LF), 4.0)), edge_ln=f(edge_ln, torch.int32),
        edge_valid=f(edge_ln >= 0, torch.bool))
    return prob, lines, intr


def _to(t, dev):
    return type(t)(*[x.to(dev) for x in t])


def _caller_ms(fn, dev, reps=5):
    times = []
    for _ in range(reps + 1):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times[1:])


def _flat(res) -> torch.Tensor:
    """A result's tensors as one int32 vector (float bits kept exactly)."""
    parts = [t.float().reshape(-1) if t.dtype == torch.bool else t.reshape(-1)
             for t in res if t is not None]
    return torch.cat([p.contiguous().view(torch.int32) for p in parts])


def _errors(a, b) -> dict:
    err = max((x - y).abs().max().item() for x, y in zip(
        (a.kf_T_cw, a.mp_xyz, a.ln_start, a.ln_end), (b.kf_T_cw, b.mp_xyz, b.ln_start, b.ln_end)))
    same = min((a.edge_inlier == b.edge_inlier).float().mean().item(),
               (a.line_inlier == b.line_inlier).float().mean().item())
    return {"max_abs_err": err, "masks_equal": same}


def rank_main(rank, n_ranks, shards, port, device, out):
    import torch.distributed as dist

    from structure_slam_pointline_tpu_torch.config import OptimConfig
    from structure_slam_pointline_tpu_torch.optim import local_ba
    from structure_slam_pointline_tpu_torch.parallel import dist_ba, distributed
    from structure_slam_pointline_tpu_torch.parallel.mesh import edge_mesh

    torch.set_num_threads(1)
    if device == "cuda":
        distributed.initialize_multihost(f"localhost:{port}", n_ranks, rank,
                                         local_device_ids=[rank])
    else:
        distributed.initialize_multihost(f"localhost:{port}", n_ranks, rank, device="cpu")
    mesh = distributed.global_edge_mesh(n_ranks * shards)
    prob, lines, intr = ba_problem()
    prob, lines = _to(prob, mesh.device), _to(lines, mesh.device)
    cfg = OptimConfig()

    def run():
        return dist_ba.shard_bundle_adjust(mesh, prob, intr, cfg, lines=lines)

    res = run()
    flat = _flat(res)
    every = [torch.empty_like(flat) for _ in range(n_ranks)]
    dist.all_gather(every, flat)
    ms = torch.tensor([_caller_ms(run, mesh.device)], dtype=torch.float64, device=mesh.device)
    all_ms = [torch.empty_like(ms) for _ in range(n_ranks)]
    dist.all_gather(all_ms, ms)
    if rank == 0:
        one = dist_ba.shard_bundle_adjust(edge_mesh(n_ranks * shards, device=mesh.device), prob,
                                          intr, cfg, lines=lines)
        single = local_ba.bundle_adjust(prob, intr, cfg, lines=lines)
        smi = "cpu"
        if device == "cuda":
            import subprocess

            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
        report = {
            "device": (torch.cuda.get_device_name(mesh.device) if device == "cuda" else "cpu"),
            "nvidia_smi": smi,
            "backend": dist.get_backend(), "ranks": n_ranks, "shards": mesh.size,
            "ranks_bit_equal": all(torch.equal(e, every[0]) for e in every),
            "against_one_process": _errors(res, one),
            "against_unsharded": _errors(res, single),
            "caller_ms_per_rank": [float(m) for m in all_ms],
            "one_process_caller_ms": _caller_ms(
                lambda: dist_ba.shard_bundle_adjust(edge_mesh(n_ranks * shards,
                                                              device=mesh.device),
                                                    prob, intr, cfg, lines=lines), mesh.device)}
        with open(out, "w") as fh:
            json.dump(report, fh)
    distributed.shutdown_multihost()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--shards-per-rank", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="mesh_ranks.json")
    a = ap.parse_args()
    if a.device == "cuda":
        if torch.cuda.device_count() < a.ranks:
            print(f"mesh_ranks: {a.ranks} ranks need {a.ranks} cards, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from structure_slam_pointline_tpu_torch import kernels

        kernels.build_all(["local_ba", "local_ba_shard"])
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(rank_main, args=(a.ranks, a.shards_per_rank, port, a.device, a.out),
             nprocs=a.ranks, join=True)
    with open(a.out) as fh:
        report = json.load(fh)
    print(json.dumps(report))
    ok = (report["ranks_bit_equal"]
          and all(r["max_abs_err"] <= 1e-3 and r["masks_equal"] >= 0.995
                  for r in (report["against_one_process"], report["against_unsharded"])))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
