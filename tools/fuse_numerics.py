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
  a probe kernel built here with nvcc at -fmad=false and at -fmad=true.
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
__global__ void k(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = logf(x[i]);
}
extern "C" int probe_logf(const void* x, void* y, int n) {
  k<<<(n + 255) / 256, 256>>>((const float*)x, (float*)y, n);
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
    h.probe_logf.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    h.probe_logf.restype = ctypes.c_int
    return h


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
    for fmad in ("false", "true"):
        h = build(fmad)
        o = torch.empty_like(rt)
        if h.probe_logf(rt.data_ptr(), o.data_ptr(), args.n) != 0:
            print("probe kernel failed", file=sys.stderr)
            return 1
        out[f"log_vs_logf_fmad_{fmad}"] = int((o != ref).sum())
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
