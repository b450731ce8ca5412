#!/usr/bin/env python3
"""Where one call of kernel 4 (csrc/pose_lm.cu) spends its time, on the card.

    python3 tools/pose_lm_trace.py [--line-weight W ...] [--schedule RxI ...]
                                   [--keep K ...]

Copies the source into build/ with timing marks added (the source in the
package is not touched): the block's first and last threads write the SM
cycles (clock64) at the staging, at each round's classification and task
compaction, at five points of every iteration (edge pass done, the warp's
column sums written, past the barrier, the slots summed and
broadcast, the solve done) and after each point row's projection and
accumulation, and thread 0 the global timer at the start and the end;
empty asm statements that take a mark's inputs keep their arithmetic from
moving past it. Builds the copy with nvcc (sm_90a, -fmad=false, as the port's
sources), puts it in place of the port's library for kernel 4, and runs
`pose_optimize` twice (the second traced) on
`tests/test_torch_kernels_gpu.py pose_problem()` at N 2048, M 256, for each
line weight, schedule and count of masked points kept (default 0 and 1,
2x4 and 4x6, all). Prints per problem the call's cycles and ns, the masked
rows, and the mean cycles of each part of an iteration and of a
classification, for thread 0 (warp 0, which holds tasks) and the last
thread (the last warp). The marks' own stores add a little to each part.
Needs a CUDA card and nvcc; an anchor that no longer matches the source is
an error.
"""

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "structure_slam_pointline_tpu_torch", "csrc", "pose_lm.cu")
BUILD = os.path.join(ROOT, "build")
NVCC = "/usr/local/cuda/bin/nvcc"

# tag -> what has just happened
TAGS = {0: "start", 1: "staged", 2: "classified", 3: "tasks written", 4: "iteration start",
        5: "edge pass", 6: "warp summed", 7: "barrier", 8: "slots summed", 9: "solved",
        10: "final classification", 11: "point projected", 12: "point accumulated"}

# the values a mark waits for: empty volatile asm statements that take them
# as operands keep the compiler from moving their arithmetic past the clock
PIN_ACC = ("#pragma unroll\n      for (int k_ = 0; k_ < NACC; ++k_) "
           "asm volatile(\"\" : \"+f\"(acc[k_]));\n")
PIN_PROJ = ("asm volatile(\"\" : \"+f\"(p.u), \"+f\"(p.v), \"+f\"(p.Ju[0]), "
            "\"+f\"(p.Jv[0]));\n")

# (anchor in the source, tag, where, pins): the mark goes before or after it
MARKS = [
    ("  for (int q = 0; q < 12; ++q) T[q] = T_init[q];\n", 0, "after", ""),
    ("  float cost = 0.f;\n  int it_all = 0;\n", 1, "before", ""),
    ("    classify_span(P, S, T, nc, npc, rnd > 0, cnt_items[0], cnt_tasks[0]);\n"
     "    __syncthreads();\n", 2, "after", ""),
    ("    write_tasks(S, nc, npc, warp_offset(tasks_of, &n_task));\n    __syncthreads();\n",
     3, "after", ""),
    ("      float acc[NACC];\n", 4, "before", ""),
    ("          project(T, r, P.fx, P.fy, P.cx, P.cy, p);\n", 11, "after", PIN_PROJ),
    ("          accum(acc, p.Jv, wt, rv);\n", 12, "after", PIN_ACC),
    ("      float(*tile)[33] = tiles[w];\n", 5, "before", PIN_ACC),
    ("      if (lane < NACC) slot[w][lane] = part;\n", 6, "after",
     "asm volatile(\"\" :: \"f\"(part));\n"),
    ("      // lane k adds entry k over the warps", 7, "before", ""),
    ("      cost = tot[27];\n", 8, "before", ""),
    ("      solve_and_update(tot, lam, T);\n", 9, "after",
     "asm volatile(\"\" : \"+f\"(T[0]), \"+f\"(T[5]), \"+f\"(T[11]));\n"),
    ("  if (threadIdx.x == 0) {\n    int n_act;\n", 10, "before", ""),
]

PRELUDE = r"""
#define PL_MAX 4096
__device__ long long pl_cyc[2][PL_MAX];
__device__ int pl_tag[2][PL_MAX];
__device__ int pl_n[2];
__device__ unsigned long long pl_ns[2];
#define MARK(tag) do { if (threadIdx.x == 0 || threadIdx.x == blockDim.x - 1) { \
  const int s_ = threadIdx.x ? 1 : 0; const int i_ = pl_n[s_]; \
  if (i_ < PL_MAX) { pl_cyc[s_][i_] = clock64(); pl_tag[s_][i_] = (tag); pl_n[s_] = i_ + 1; } \
  if (s_ == 0 && ((tag) == 0 || (tag) == 10)) { unsigned long long t_; \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); pl_ns[(tag) ? 1 : 0] = t_; } \
  } } while (0)
"""

EPILOGUE = r"""
extern "C" int pl_trace_reset() {
  const int z[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(pl_n, z, sizeof(z));
}
extern "C" int pl_trace_read(long long* cyc, int* tag, int* n, unsigned long long* ns) {
  cudaDeviceSynchronize();
  int e = (int)cudaMemcpyFromSymbol(cyc, pl_cyc, sizeof(long long) * 2 * PL_MAX);
  e |= (int)cudaMemcpyFromSymbol(tag, pl_tag, sizeof(int) * 2 * PL_MAX);
  e |= (int)cudaMemcpyFromSymbol(n, pl_n, sizeof(int) * 2);
  e |= (int)cudaMemcpyFromSymbol(ns, pl_ns, sizeof(unsigned long long) * 2);
  return e;
}
"""


def traced_source() -> str:
    src = open(SOURCE).read()
    for anchor, tag, where, pins in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"pose_lm_trace: anchor for tag {tag} ({TAGS[tag]}) found "
                               f"{src.count(anchor)} times in {SOURCE}")
        mark = f"{pins}MARK({tag});\n"
        src = src.replace(anchor, anchor + mark if where == "after" else mark + anchor)
    head = "namespace {\n"
    return src.replace(head, PRELUDE + head, 1) + EPILOGUE


def build() -> str:
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, "pose_lm_traced.cu")
    so = os.path.join(BUILD, "libpose_lm_traced.so")
    with open(cu, "w") as f:
        f.write(traced_source())
    subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-I", os.path.dirname(SOURCE), "-o", so, cu], check=True)
    return so


def parts(cyc, tag, n):
    """Mean cycles of each part, from consecutive marks (tag pairs)."""
    sums, counts = {}, {}
    for i in range(1, n):
        key = f"{TAGS[tag[i - 1]]} -> {TAGS[tag[i]]}"
        sums[key] = sums.get(key, 0) + int(cyc[i] - cyc[i - 1])
        counts[key] = counts.get(key, 0) + 1
    return {k: (sums[k] / counts[k], counts[k]) for k in sums}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--line-weight", type=float, nargs="+", default=[0.0, 1.0])
    ap.add_argument("--schedule", nargs="+", default=["2x4", "4x6"])
    ap.add_argument("--keep", type=int, nargs="+", default=[0],
                    help="masked points kept (0: all, ~80%% of N; the main path ~150)")
    a = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import numpy as np
    import torch

    from structure_slam_pointline_tpu_torch import kernels
    from structure_slam_pointline_tpu_torch.config import OptimConfig
    from structure_slam_pointline_tpu_torch.optim import pose_opt
    from test_torch_kernels_gpu import pose_problem, pose_to

    if not torch.cuda.is_available():
        print("pose_lm_trace: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    lib = ctypes.CDLL(build())
    lib.sspl_pose_lm.argtypes = kernels._ARGTYPES["pose_lm"]
    lib.sspl_pose_lm.restype = ctypes.c_int
    kernels._LIBS[kernels.SOURCES["pose_lm"]] = lib
    P = 4096
    cyc = (ctypes.c_longlong * (2 * P))()
    tag = (ctypes.c_int * (2 * P))()
    n = (ctypes.c_int * 2)()
    ns = (ctypes.c_ulonglong * 2)()
    for w, sch, keep in ((w, sch, k) for w in a.line_weight for sch in a.schedule
                         for k in a.keep):
        rounds, iters = (int(v) for v in sch.split("x"))
        args, intr = pose_problem(w, keep=keep or None)
        cfg = dataclasses.replace(OptimConfig(), pose_rounds=rounds, pose_iters=iters)
        args_k = pose_to(args, "cuda")
        pose_opt.pose_optimize(*args_k, intr, cfg)
        torch.cuda.synchronize()
        lib.pl_trace_reset()
        r = pose_opt.pose_optimize(*args_k, intr, cfg)
        if lib.pl_trace_read(cyc, tag, n, ns) != 0:
            raise RuntimeError("pose_lm_trace: reading the marks failed")
        active = int(args[3].sum()) + 2 * int(args[8].sum())
        print(f"\nline weight {w:g}, {rounds}x{iters}, keep {keep}: {active} rows masked, "
              f"n_inliers {int(r.n_inliers)}, {ns[1] - ns[0]} ns start to final class")
        for s, who in ((0, "thread 0"), (1, "the last thread")):
            c = np.array(cyc[s * P: s * P + n[s]])
            t = list(tag[s * P: s * P + n[s]])
            print(f"  {who}: {int(c[-1] - c[0])} cycles over {n[s]} marks")
            for k, (mean, cnt) in sorted(parts(c, t, n[s]).items(),
                                         key=lambda kv: -kv[1][0] * kv[1][1]):
                print(f"    {k:<45s} {mean:9.1f} cycles x {cnt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
