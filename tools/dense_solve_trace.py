#!/usr/bin/env python3
"""Where one solve of csrc/dense_lu.cuh spends its time, on the card.

    python3 tools/dense_solve_trace.py [N:CAP ...]   (default 306:306 357:1792)

Copies the header into build/ with timing marks added (the source in the
package is not touched): thread 0 of each block of the cluster writes
(block rank, phase, globaltimer ns) at the phases' boundaries, and thread 0
and thread 255 of rank 0 write the SM cycles (clock64) of each column step
of the first panel: the pivot search and barrier, the pivot read, the row
update. Builds the copy with nvcc (sm_90a, -fmad=false, as the port's
sources), runs one solve of a damped J^T J + 1e-3 I system (numpy, seed 0)
per N:CAP (the capacity picks the panel width), and prints, per system,
the SM clock (cycles over ns), the mean cycles of a column step's parts,
and for ranks 0 and 1 the time between consecutive marks summed by pair
of phases, largest first. The marks' own stores add a little to each
phase. Needs a CUDA card and nvcc; an anchor that no longer matches the
header is reported, not skipped.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "structure_slam_pointline_tpu_torch", "csrc", "dense_lu.cuh")
BUILD = os.path.join(ROOT, "build")
NVCC = "/usr/local/cuda/bin/nvcc"

PHASES = {0: "start", 1: "panel 0 written", 2: "update done", 3: "barrier after update",
          9: "end", 10: "strip loaded", 12: "panel factored", 20: "(b) start", 21: "(c) start",
          22: "(c) done", 30: "diagonal block solved", 31: "rows above updated"}

# (anchor in the header, mark, where): the mark goes before or after it
MARKS = [
    ("  if (!loaded) load_block<NB, 8>(A, ld, k0, m, k0, nb, P, PS);\n", "MARK(10);\n", "after"),
    ("  __syncthreads();\n#pragma unroll 4\n  for (int idx = tid; idx < m * NB; idx += THREADS) {",
     "MARK(12);\n", "before"),
    ("    // (b) on each owned tile", "MARK(20);\n", "before"),
    ("    // (c): A22 -= L21 U12 on the owned tiles", "MARK(21);\n", "before"),
    ("  if (rank == 0 && c1 < n) {\n    __syncthreads();\n", "MARK(22);\n", "after"),
    ("    if (r0 == 0) break;\n", "MARK(30);\n", "before"),
    ("    cluster_sync();\n  }\n}\n", "MARK(31);\n", "before"),
    ("  cluster_sync();\n  for (int k0 = 0; k0 < n; k0 += NB) {\n", "MARK(1);\n", "before"),
    ("    update<NB>(A, n, ld, k0, piv, rank, P, row_at, Ut, Low, sh);\n", "MARK(2);\n", "after"),
    ("    cluster_sync();\n  }\n  back_substitute", "MARK(3);\n", "after first line"),
    # the column step's cycles (rank 0, first panel, threads 0 and 255)
    ("  for (int j = 0; j < nb; ++j) {\n    const int par = j & 1;\n",
     "    long long tc0 = clock64();\n", "after"),
    ("    unsigned long long key = sh.wkey[par][0];\n", "    long long tc1 = clock64();\n", "before"),
    ("    const float rcp = sh.wrcp[par][ww];\n", "    long long tc2 = clock64();\n", "after"),
    ("  }\n#pragma unroll 1\n  for (int i = tid; i < m; i += THREADS) row_at[pos_of[i]] = i;",
     "    if (k0 == 0 && (tid == 0 || tid == 255)) {\n      const int o_ = (tid ? 64 : 0) + j;\n"
     "      long long tc3 = clock64();\n      dl_cols[3 * o_] = tc1 - tc0;\n"
     "      dl_cols[3 * o_ + 1] = tc2 - tc1;\n      dl_cols[3 * o_ + 2] = tc3 - tc2;\n    }\n",
     "before"),
]

PRELUDE = """__device__ unsigned long long dl_trace[1 << 16];
__device__ int dl_ntrace;
__device__ long long dl_cols[3 * 128];
__device__ long long dl_clk[2];
#define MARK(tag) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  int i_ = atomicAdd(&dl_ntrace, 1); if (i_ < (1 << 15)) { \\
  dl_trace[2 * i_] = ((unsigned long long)cg::this_cluster().block_rank() << 32) | (tag); \\
  dl_trace[2 * i_ + 1] = t_; } } } while (0)
namespace dense_lu {"""

DRIVER = r'''
#include "dense_lu_traced.cuh"
namespace cg = cooperative_groups;
template <int NB>
__global__ void __launch_bounds__(dense_lu::THREADS) traced(float* A, int n, int cap, int* piv) {
  extern __shared__ float dyn[];
  MARK(0);
  const long long c0 = clock64();
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  dense_lu::solve<NB>(A, n, piv, cap, dyn);
  MARK(9);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0 && cg::this_cluster().block_rank() == 0) {
    dl_clk[0] = clock64() - c0;
    dl_clk[1] = (long long)(g1 - g0);
  }
}
extern "C" int run(float* A, int n, int cap, int* piv, unsigned long long* marks, int* n_marks,
                   long long* cols, long long* clk) {
  const int zero = 0;
  cudaMemcpyToSymbol(dl_ntrace, &zero, sizeof(int));
  const int nb = dense_lu::panel_width(cap);
  cudaError_t e = nb == 32 ? dense_lu::launch(traced<32>, dense_lu::smem_bytes<32>(cap), 0, A, n, cap, piv)
                : nb == 16 ? dense_lu::launch(traced<16>, dense_lu::smem_bytes<16>(cap), 0, A, n, cap, piv)
                : cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  cudaMemcpyFromSymbol(n_marks, dl_ntrace, sizeof(int));
  const int m = *n_marks < (1 << 15) ? *n_marks : (1 << 15);
  cudaMemcpyFromSymbol(marks, dl_trace, sizeof(unsigned long long) * 2 * m);
  cudaMemcpyFromSymbol(cols, dl_cols, sizeof(long long) * 3 * 128);
  cudaMemcpyFromSymbol(clk, dl_clk, sizeof(long long) * 2);
  return 0;
}
'''


def traced_header() -> str:
    src = open(HEADER).read()
    for anchor, mark, where in MARKS:
        if anchor not in src:
            raise SystemExit(f"dense_solve_trace: anchor not in the header: {anchor!r}")
        if where == "after":
            src = src.replace(anchor, anchor + mark, 1)
        elif where == "before":
            src = src.replace(anchor, mark + anchor, 1)
        else:
            first = anchor.split("\n")[0] + "\n"
            src = src.replace(anchor, first + mark + anchor[len(first):], 1)
    return src.replace("namespace dense_lu {", PRELUDE, 1)


def build():
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "dense_lu_traced.cuh"), "w") as f:
        f.write(traced_header())
    with open(os.path.join(BUILD, "dense_solve_trace.cu"), "w") as f:
        f.write(DRIVER)
    out = os.path.join(BUILD, "dense_solve_trace.so")
    subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o", out,
                    os.path.join(BUILD, "dense_solve_trace.cu")], check=True)
    lib = ctypes.CDLL(out)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    return lib


def report(ev, rank):
    rows = sorted((t, tag) for r, tag, t in ev if r == rank)
    sums = {}
    for (ta, a), (tb, b) in zip(rows, rows[1:]):
        key = f"{PHASES.get(a, a)} -> {PHASES.get(b, b)}"
        total, count = sums.get(key, (0.0, 0))
        sums[key] = (total + tb - ta, count + 1)
    for key, (total, count) in sorted(sums.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  rank {rank} {key}: {total:.1f} us over {count}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("dense_solve_trace: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    lib = build()
    g = np.random.default_rng(0)
    for spec in argv or ("306:306", "357:1792"):
        n, cap = (int(v) for v in spec.split(":"))
        J = g.normal(size=(2 * n, n))
        Ab = torch.from_numpy(np.concatenate([J.T @ J + 1e-3 * np.eye(n), g.normal(size=(n, 1))], 1)
                              .astype(np.float32)).cuda()
        marks = np.zeros(2 * (1 << 15), np.uint64)
        cols = np.zeros(3 * 128, np.int64)
        clk = np.zeros(2, np.int64)
        n_marks = ctypes.c_int(0)
        for _ in range(2):   # the second run is reported
            A = Ab.clone()
            piv = torch.empty(n, dtype=torch.int32, device="cuda")
            err = lib.run(A.data_ptr(), n, cap, piv.data_ptr(), marks.ctypes.data,
                          ctypes.addressof(n_marks), cols.ctypes.data, clk.ctypes.data)
            if err:
                print(f"dense_solve_trace: CUDA error {err}", file=sys.stderr)
                return 1
        m = min(n_marks.value, 1 << 15)
        raw = marks[:2 * m].reshape(m, 2).astype(np.int64)
        t0 = raw[:, 1].min()
        ev = [(int(tag >> 32), int(tag & 0xFFFFFFFF), (t - t0) / 1e3) for tag, t in raw]
        print(f"== n={n} capacity={cap}: {max(e[2] for e in ev):.1f} us, SM clock "
              f"{clk[0] / clk[1]:.3f} GHz")
        c = cols.reshape(128, 3)
        for who, off in (("thread 0", 0), ("thread 255", 64)):
            step = c[off:off + min(n, 32)]
            print(f"  panel 0 column step, {who}: search + barrier {step[:, 0].mean():.0f}, "
                  f"pivot read {step[:, 1].mean():.0f}, row update {step[:, 2].mean():.0f} cycles")
        report(ev, 0)
        report(ev, 1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
