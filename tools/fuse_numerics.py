#!/usr/bin/env python3
"""How PyTorch rounds kernel 22's gate arithmetic on the card.

    python3 tools/fuse_numerics.py [--n 1000000] [--out FILE]

Kernel 22 (csrc/fuse_match.cu) repeats its plain version's float32 ops; a
last-bit difference matters where a value sits on a gate, as the predicted
octave ceil(log(dmax / dist) / log(sf)) does for a landmark seen from the
distance it was made at. This probe holds PyTorch's CUDA ops against
candidate orders on seeded inputs and prints, for each, how many results
differ:
- torch.linalg.norm of [n, 3] vectors against the orders of a sum of
  three squares, with and without FMAs (an FMA emulated in float64 on the
  host, rounded once), on the card and on the CPU; torch.sum of the
  same vectors against the two orders of a sum of three;
- torch.log of ratios near sf^k against the CUDA math library's logf in
  a probe kernel built here with nvcc at -fmad=false and at -fmad=true;
- the ops the tracking entries and kernel 26 add: the [n, 3] @ R^T + t
  product of `track_match_points_plain`, the camera centre -R^T @ t (a
  matrix-vector product), torch.linalg.cross of homogeneous endpoints
  (`ops/lsd.py _line_coeffs`), against candidate orders, and torch.cos /
  torch.sin against cosf / sinf in the probe kernel at either -fmad. On
  an H100 with torch 2.11 + CUDA 12.8 the product is the FMA chain, the
  matrix-vector product fma(a1, v1, a0 v0) + a2 v2 (`mv_fma01_plus2`),
  the cross product's third term fma(x1, y2, -(x2 y1)), and cos / sin
  equal cosf / sinf under either -fmad.
Needs a CUDA device and nvcc (the card's machine). One JSON line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from structure_slam_pointline_tpu_torch import kernels  # noqa: E402
SRC = r"""
#include <cuda_runtime.h>
__global__ void k(const float* x, float* y, int n, int op) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = op == 0 ? logf(x[i]) : op == 1 ? cosf(x[i]) : sinf(x[i]);
}
extern "C" int probe_logf(const void* x, void* y, int n, int op) {
  k<<<(n + 255) / 256, 256>>>((const float*)x, (float*)y, n, op);
  return (int)cudaDeviceSynchronize();
}
"""


def build(fmad: str) -> ctypes.CDLL:
    out_dir = kernels.BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe_logf.cu")
    with open(src, "w") as f:
        f.write(SRC)
    lib = os.path.join(out_dir, f"libprobe_logf_{fmad}.so")
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    f"-fmad={fmad}", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    h = ctypes.CDLL(lib)
    h.probe_logf.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    h.probe_logf.restype = ctypes.c_int
    return h


def tracking_orders(g, n: int) -> dict:
    """Mismatch counts of the tracking entries' and kernel 26's extra ops
    on the card against candidate orders (FMAs emulated in float64)."""
    import torch

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c.astype(np.float64)).astype(np.float32)

    out = {}
    f32 = np.float32
    mv = ("mv_fma_chain", "mv_fma_reverse", "mv_seq", "mv_xz_y", "mv_fma01_plus2",
          "mv_fma02_plus1", "mv_0_plus_fma12", "mv_fma_chain_201", "mv_right")
    bad = {"mm_fma_chain": 0, "mm_seq": 0, **{k: 0 for k in mv}}
    for trial in range(16):
        q, _ = np.linalg.qr(g.normal(size=(3, 3)))
        R = q.astype(f32)
        t = g.normal(size=3).astype(f32) * f32(3.0)
        T = np.eye(4, dtype=f32)
        T[:3, :3], T[:3, 3] = R, t
        X = (g.normal(size=(n // 16, 3)) * 4).astype(f32)
        Tc = torch.from_numpy(T).cuda()
        pc = (torch.from_numpy(X).cuda() @ Tc[:3, :3].T + Tc[:3, 3]).cpu().numpy()
        x, y, z = X[:, 0], X[:, 1], X[:, 2]
        for r in range(3):
            chain = fma(z, R[r, 2], fma(y, R[r, 1], x * R[r, 0])) + t[r]
            seq = ((x * R[r, 0] + y * R[r, 1]) + z * R[r, 2]) + t[r]
            bad["mm_fma_chain"] += int((pc[:, r] != chain).sum())
            bad["mm_seq"] += int((pc[:, r] != seq).sum())
    n_mv = 0
    for trial in range(512):
        q, _ = np.linalg.qr(g.normal(size=(3, 3)))
        R = q.astype(f32)
        t = (g.normal(size=3) * 3).astype(f32)
        T = np.eye(4, dtype=f32)
        T[:3, :3], T[:3, 3] = R, t
        Tc = torch.from_numpy(T).cuda()
        c = (-Tc[:3, :3].T @ Tc[:3, 3]).cpu().numpy()
        for j in range(3):
            a = [(-R[r, j:j + 1]).astype(f32) for r in range(3)]
            v = [t[r:r + 1] for r in range(3)]
            p = [a[r] * v[r] for r in range(3)]
            cand = {"mv_fma_chain": fma(a[2], v[2], fma(a[1], v[1], p[0])),
                    "mv_fma_reverse": fma(a[0], v[0], fma(a[1], v[1], p[2])),
                    "mv_seq": (p[0] + p[1]) + p[2], "mv_xz_y": (p[0] + p[2]) + p[1],
                    "mv_fma01_plus2": fma(a[1], v[1], p[0]) + p[2],
                    "mv_fma02_plus1": fma(a[2], v[2], p[0]) + p[1],
                    "mv_0_plus_fma12": p[0] + fma(a[2], v[2], p[1]),
                    "mv_fma_chain_201": fma(a[1], v[1], fma(a[0], v[0], p[2])),
                    "mv_right": p[0] + (p[1] + p[2])}
            for k, x_ in cand.items():
                bad[k] += int(c[j] != x_[0])
            n_mv += 1
    out.update({f"{k}_of_{n_mv if k.startswith('mv') else 3 * (n // 16) * 16}": v
                for k, v in bad.items()})
    p = (g.uniform(0, 640, (n, 4))).astype(f32)
    one = np.ones((n, 1), f32)
    a, b = np.concatenate([p[:, :2], one], 1), np.concatenate([p[:, 2:], one], 1)
    l2 = torch.linalg.cross(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())[:, 2]
    l2 = l2.cpu().numpy()
    sx, sy, ex, ey = p.T
    out["cross_vs_fma_first"] = int((l2 != fma(sx, ey, -(sy * ex))).sum())
    out["cross_vs_fma_second"] = int((l2 != fma(-sy, ex, sx * ey)).sum())
    out["cross_vs_plain"] = int((l2 != sx * ey - sy * ex).sum())
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fuse_numerics: no CUDA device", file=sys.stderr)
        return 2
    g = np.random.default_rng(0)
    v = (g.normal(size=(args.n, 3)) * g.uniform(0.1, 10.0, (args.n, 1))).astype(np.float32)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]

    def fma(a, b, c):   # a * b + c rounded once (exact product in float64)
        return (a.astype(np.float64) * b + c.astype(np.float64)).astype(np.float32)

    cands = {"seq": (x * x + y * y) + z * z, "right": x * x + (y * y + z * z),
             "xz_y": (x * x + z * z) + y * y, "fma_chain": fma(z, z, fma(y, y, x * x)),
             "fma_y_then_z": fma(y, y, x * x) + z * z, "fma_z_then_y": fma(y, y, fma(z, z, x * x)),
             "x_plus_fma": x * x + fma(z, z, y * y), "fma_x_last": fma(x, x, y * y + z * z),
             "fma_xz_plus_y": fma(z, z, x * x) + y * y}
    out = {"device": torch.cuda.get_device_name(0), "n": args.n}
    for dev in ("cuda", "cpu"):
        nrm = torch.linalg.norm(torch.from_numpy(v).to(dev), dim=-1).cpu().numpy()
        for name, c in cands.items():
            out[f"norm_{dev}_vs_{name}"] = int((nrm != np.sqrt(c)).sum())
        tot = torch.sum(torch.from_numpy(v).to(dev), dim=-1).cpu().numpy()
        out[f"sum_{dev}_vs_seq"] = int((tot != (x + y) + z).sum())
        out[f"sum_{dev}_vs_xz_y"] = int((tot != (x + z) + y).sum())
    sf = np.float32(1.2)
    k = g.integers(1, 8, args.n)
    r = (sf.astype(np.float64) ** k * (1 + g.normal(size=args.n) * 1e-6)).astype(np.float32)
    rt = torch.from_numpy(r).cuda()
    ref = torch.log(rt)
    ang = torch.from_numpy(g.uniform(-np.pi, np.pi, args.n).astype(np.float32)).cuda()
    for fmad in ("false", "true"):
        h = build(fmad)
        for op, name, x_, want in ((0, "log_vs_logf", rt, ref),
                                   (1, "cos_vs_cosf", ang, torch.cos(ang)),
                                   (2, "sin_vs_sinf", ang, torch.sin(ang))):
            o = torch.empty_like(x_)
            if h.probe_logf(x_.data_ptr(), o.data_ptr(), args.n, op) != 0:
                print("probe kernel failed", file=sys.stderr)
                return 1
            out[f"{name}_fmad_{fmad}"] = int((o != want).sum())
    out.update(tracking_orders(g, args.n))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
