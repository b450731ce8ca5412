// The dense solve of kernels 12 and 18: x = A^-1 b for one augmented
// system [A | b] of n rows and n + 1 columns (row stride n + 1, b as
// column n) in global memory, by a right-looking blocked LU with partial
// pivoting run by one thread-block cluster.
//
// Replaces the two one-block unblocked LUs that local_ba.cu (`ba_solve`)
// and pose_graph.cu (`pg_solve`) carried until now, and with them the
// reference's jnp.linalg.solve of the reduced camera system
// (structure_slam_pointline_tpu/optim/local_ba.py:477) and of the pose
// graph's normal equations (optim/pose_graph.py:111). That is LAPACK's
// getrf, LU with partial pivoting, and the pivot rule stays its rule:
// the largest |a| of the column, the first row on ties (NaN never wins).
// Cholesky would halve the flops, but global BA's system keeps the
// monocular scale direction (damped only by lam and 1e-6 I) and the pose
// graph starts at lam = 1e-16: a float32 Cholesky can meet a non-positive
// pivot there, where the LU meets a small one.
//
// Bound on the card: 2 n^3 / 3 flops (1.9 x 10^7 at global BA's n = 306,
// 0.29 us at 67 TFLOP/s) on an L2-resident matrix (at most 12.8 MB, the
// pose graph at its 256-keyframe capacity). The work is small; what sets
// the time is the chain of n dependent pivot steps and, in a one-block
// design, the trailing matrix read and written through L2 once per
// column (the former kernels reached ~1% of one SM's float32 rate).
//
// Design (one cluster of CLUSTER blocks of THREADS threads, launched with
// cudaLaunchKernelEx and a cluster-dimension attribute; the cluster
// barrier, with a __threadfence before it, orders the global writes, and
// the matrix is read and written through L2 only, ld.cg / st.cg, so no
// block reads a stale line from its own L1):
//  (a) panel: rank 0 holds the n - k0 by NB strip of the panel's columns
//      in shared memory and factors it column by column, one
//      __syncthreads per column (factor_panel): the rows stay in place
//      and each thread tracks the positions of its own, each warp offers
//      its best pivot key (|a|, then the earlier position, so ties go to
//      the first row as the swap order has it), every thread takes the
//      largest, and updates its rows with one multiplier each (a row
//      times the pivot's reciprocal) and the rank-1 update of the strip's
//      remaining columns. The strip (L11, U11 with the pivots'
//      reciprocals on its diagonal, L21) goes back to global memory in
//      pivoted order, and the pivot rows (LAPACK's ipiv) beside it.
//  (b) the trailing columns (the right side included) are cut into tiles:
//      tile 0, the next panel's NB columns, is rank 0's; tiles 1, 2, ...,
//      CT columns each, go round robin to ranks 1 .. CLUSTER - 1. The
//      owner applies the panel's row swaps to its tile in shared memory
//      (the rows below the panel that a swap touches staged beside the
//      top rows) and forms the tile's U12 rows by forward substitution
//      with L11, a lane per row, CT / WARPS columns per warp.
//  (c) the owner then updates its tile below the panel, A22 -= L21 U12,
//      in chunks of RC rows: the chunk of L21 staged in shared memory,
//      each thread holding RC / WARPS rows of one column in registers.
//      Every product is subtracted one term at a time in the panel's
//      column order, in float32 (no TF32): each element sees exactly the
//      operations of the unblocked right-looking LU, so the blocked
//      factorization equals the unblocked one bit for bit (with
//      -fmad=false, which both callers are built with).
//  Look-ahead: tile 0 holds the next panel's columns, so rank 0, having
//  updated it (and kept it in its strip), factors the next panel while
//  the other ranks are still in (c); one cluster barrier per panel.
//  Back substitution, blocked by BS = 32 rows from the bottom: every
//  block solves the 32 x 32 diagonal triangle in one warp (a lane per
//  row, the solved x broadcast by shuffle, each x its right side times
//  the pivot's reciprocal), then every warp of the cluster subtracts the
//  block's products from the right side of its rows above (a warp per
//  row, a fixed shuffle tree): n / 32 barriers. Every block ends with the
//  whole x in its shared memory.
// No atomics touch the matrix and every sum runs in a fixed order: the
// result is the same on every run.
//
// What holds it back (one H100; PERF.md, tools/dense_solve_trace.py): a
// column step of the panel costs ~0.7 us, mostly the latency of the
// pivot search, the barrier and the dependent shared-memory round trips,
// and it is the critical path (n steps); then tile 0's (b) and (c) on
// rank 0, ~12 us per panel at n = 306. Rows held in registers instead of
// shared memory were slower (the selects cost more issue slots than the
// loads), and unrolling the column step over a thread's rows made it
// larger than the instruction cache (about twice the time a step).
//
// Shared memory: the strip, n_cap x (NB + 1) floats, two row maps of n_cap
// ints, and the owned tiles' top and staged rows; NB = 32 while that fits
// in MAX_DYN_SMEM, else 16 (the pose graph at 256 keyframes: n_cap = 1792).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense_lu {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;     // blocks of the cluster (the portable size)
constexpr int THREADS = 256;   // threads of a block
constexpr int WARPS = THREADS / 32;
constexpr int CT = 32;         // columns of a trailing tile
constexpr int RC = 64;         // rows of a trailing chunk
constexpr int BS = 32;         // rows of a back-substitution block (a lane each)
constexpr int MAX_ROWS = 2048;  // rows of a system (11 bits of the pivot key)
constexpr size_t MAX_DYN_SMEM = 200 * 1024;

// trailing tiles that a block of rank >= 1 owns at most, for systems of up
// to `cap` rows (tile 0, rank 0's, is the next panel; the others CT wide)
__host__ __device__ inline int tiles_per_block(int cap) {
  const int t = ((cap + CT - 1) / CT + CLUSTER - 2) / (CLUSTER - 1);
  return t > 1 ? t : 1;
}

// the trailing columns right of a panel ending at c1: tile 0 the next
// panel's NB (or the right side alone), tiles 1, 2, ... CT each
template <int NB>
__device__ __forceinline__ int tile_count(int n, int c1) {
  return n + 1 - c1 <= NB ? 1 : 1 + (n + 1 - c1 - NB + CT - 1) / CT;
}

template <int NB>
__device__ __forceinline__ int tile_start(int c1, int t) {
  return t == 0 ? c1 : c1 + NB + (t - 1) * CT;
}

template <int NB>
__device__ __forceinline__ int tile_width(int n, int c1, int t) {
  return min(t == 0 ? NB : CT, n + 1 - tile_start<NB>(c1, t));
}

// the strip, its two row maps, and the owned tiles' top and staged rows
template <int NB>
__host__ __device__ inline size_t smem_bytes(int cap) {
  return ((size_t)cap * (NB + 3) + 2 * (size_t)tiles_per_block(cap) * NB * CT) * sizeof(float);
}

// systems of up to `cap` rows in panels of NB
template <int NB>
inline bool fits(int cap) {
  return cap >= 1 && cap < MAX_ROWS && smem_bytes<NB>(cap) <= MAX_DYN_SMEM &&
         tiles_per_block(cap) <= WARPS;
}

template <int NB>
struct Shared {
  float L11[NB][NB + 1];
  float Lc[RC][NB + 1];      // a chunk of L21
  float Ub[BS][BS + 1];      // the back substitution's diagonal block
  float rdiag[NB];           // the reciprocals of the panel's pivots
  int pv[NB];                // the panel's pivot rows
  int slot[NB];              // the first panel step that pivots on the same row
  unsigned long long wkey[2][WARPS];  // each warp's pivot key of the column, by parity
  float wrcp[2][WARPS];       // the reciprocal of each warp's candidate pivot, by parity
};

// the pivot key of a strip row: |a| (its bits + 1; 0 for NaN), then the
// earlier position, then the row (unique): the largest key is the pivot
__device__ __forceinline__ unsigned long long pivot_key(float v, int pos, int row) {
  const float a = fabsf(v);
  const unsigned hi = a == a ? __float_as_uint(a) + 1u : 0u;
  return ((unsigned long long)hi << 32) |
         ((unsigned long long)(MAX_ROWS - 1 - pos) << 11) | (unsigned long long)row;
}

__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  cg::this_cluster().sync();
}

// rows [r0, r0 + h) x columns [c0, c0 + w) of A into S (row stride ss),
// columns w .. NB - 1 zeroed, LOADS loads in flight per thread at a time
template <int NB, int LOADS>
__device__ __forceinline__ void load_block(const float* A, int ld, int r0, int h, int c0, int w,
                                           float* S, int ss) {
  const int total = h * NB;
  for (int base = 0; base < total; base += THREADS * LOADS) {
    float v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int idx = base + u * THREADS + threadIdx.x, r = idx / NB, c = idx % NB;
      v[u] = idx < total && c < w ? __ldcg(A + (size_t)(r0 + r) * ld + c0 + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int idx = base + u * THREADS + threadIdx.x, r = idx / NB, c = idx % NB;
      if (idx < total) S[r * ss + c] = v[u];
    }
  }
}

// (a): rank 0 factors the panel at k0 in its strip P. The strip's rows
// stay where they are loaded; each thread keeps the positions of its own
// rows (tid, tid + THREADS, ...) in pos_of as the pivots move them, so a
// column step is one __syncthreads: each warp's best key (and the
// reciprocal of that row's entry, from the lane that holds it), then
// every thread takes the largest of the warps' keys and updates its rows
// with the pivot row, 8 columns at a time and only the groups right of
// the pivot, and forms its key of the next column. The step's code is
// kept small (the row loop is not unrolled): it runs n times, and a body
// larger than the instruction cache costs more than the arithmetic. At
// the end the rows go back to global memory in their positions, each
// pivot's reciprocal in place of the pivot (the back substitution
// multiplies by it).
template <int NB>
__device__ __forceinline__ void factor_panel(float* A, int n, int ld, int k0, int* piv, float* P,
                                             int* row_at, int* pos_of, Shared<NB>& sh,
                                             bool loaded) {
  constexpr int PS = NB + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = n - k0, nb = min(NB, m);
  if (!loaded) load_block<NB, 8>(A, ld, k0, m, k0, nb, P, PS);
  __syncthreads();
  unsigned long long best = 0ull;
  float bval = 0.f;
#pragma unroll 1
  for (int i = tid; i < m; i += THREADS) {
    pos_of[i] = i;
    const unsigned long long k = pivot_key(P[i * PS], i, i);
    if (k > best) {
      best = k;
      bval = P[i * PS];
    }
  }
#pragma unroll 1
  for (int j = 0; j < nb; ++j) {
    const int par = j & 1;
    const unsigned hi = (unsigned)(best >> 32);
    const unsigned wmax = __reduce_max_sync(0xffffffffu, hi);
    const unsigned wlo = __reduce_max_sync(0xffffffffu, hi == wmax ? (unsigned)best : 0u);
    if (best != 0ull && hi == wmax && (unsigned)best == wlo) sh.wrcp[par][warp] = 1.f / bval;
    if (lane == 0) sh.wkey[par][warp] = ((unsigned long long)wmax << 32) | wlo;
    __syncthreads();
    unsigned long long key = sh.wkey[par][0];
    int ww = 0;
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      if (sh.wkey[par][w] > key) {
        key = sh.wkey[par][w];
        ww = w;
      }
    const int pp = MAX_ROWS - 1 - (int)((key >> 11) & (MAX_ROWS - 1));   // its position
    const int pr = (int)(key & (MAX_ROWS - 1));                          // its strip row
    const float* prow = P + pr * PS;
    const float rcp = sh.wrcp[par][ww];
    if (tid == 0) {
      sh.pv[j] = k0 + pp;
      sh.rdiag[j] = rcp;
    }
    best = 0ull;
#pragma unroll 1
    for (int i = tid; i < m; i += THREADS) {
      int p = pos_of[i];
      if (i == pr) p = j;
      else if (p == j) p = pp;   // the row the pivot displaces takes its place
      pos_of[i] = p;
      if (p <= j) continue;      // the pivot, or pivoted earlier
      float* row = P + i * PS;
      const float f = row[j] * rcp;
#pragma unroll
      for (int g = 0; g < NB; g += 8) {
        if (g + 7 <= j) continue;   // the same for every thread: no divergence
        float v[8], u[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          v[c] = row[g + c];
          u[c] = prow[g + c];
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float nv = v[c] - f * u[c];
          row[g + c] = g + c > j ? nv : v[c];
        }
      }
      row[j] = f;
      if (j + 1 < nb) {
        const float nx = row[j + 1];
        const unsigned long long k = pivot_key(nx, p, i);
        if (k > best) {
          best = k;
          bval = nx;
        }
      }
    }
  }
#pragma unroll 1
  for (int i = tid; i < m; i += THREADS) row_at[pos_of[i]] = i;
  __syncthreads();
#pragma unroll 4
  for (int idx = tid; idx < m * NB; idx += THREADS) {
    const int r = idx / NB, c = idx % NB;
    if (c < nb)
      __stcg(A + (size_t)(k0 + r) * ld + k0 + c, r == c ? sh.rdiag[r] : P[row_at[r] * PS + c]);
  }
  if (tid < nb) __stcg(piv + k0 + tid, sh.pv[tid]);
}

// (b) and (c) of the panel at k0 on this block's tiles; rank 0 then factors
// the next panel (look-ahead)
template <int NB>
__device__ __forceinline__ void update(float* A, int n, int ld, int k0, int* piv, int rank,
                                       float* P, int* row_at, float* Ut, float* Low,
                                       Shared<NB>& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = min(NB, n - k0), c1 = k0 + nb;
  const int nt = tile_count<NB>(n, c1);
  const int nq = rank == 0 ? 1 : (rank < nt ? (nt - 1 - rank) / (CLUSTER - 1) + 1 : 0);
  if (nq > 0) {
    if (tid < nb) sh.pv[tid] = __ldcg(piv + k0 + tid);
    load_block<NB, (NB * NB + THREADS - 1) / THREADS>(A, ld, k0, nb, k0, nb, &sh.L11[0][0],
                                                      NB + 1);
    __syncthreads();
    if (tid < nb) {
      int s = tid;
      for (int j = 0; j < tid; ++j)
        if (sh.pv[j] == sh.pv[tid]) {
          s = j;
          break;
        }
      sh.slot[tid] = s;
    }
    __syncthreads();
    // (b) on each owned tile: the top rows and the staged rows loaded by
    // the block; the swaps in order by one warp, a lane per column; U12 by
    // forward substitution, CT / WARPS columns per warp, a lane per row
    for (int q = 0; q < nq; ++q) {
      const int t = rank == 0 ? 0 : rank + (CLUSTER - 1) * q;
      const int c0 = tile_start<NB>(c1, t), w = tile_width<NB>(n, c1, t);
      float* U = Ut + q * NB * CT;
      float* Lo = Low + q * NB * CT;
      constexpr int LD = NB * CT / THREADS;
      float top[LD], low[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int idx = u * THREADS + tid, j = idx / CT, c = idx % CT;
        const bool in = j < nb && c < w;
        top[u] = in ? __ldcg(A + (size_t)(k0 + j) * ld + c0 + c) : 0.f;
        low[u] = in && sh.pv[j] >= c1 && sh.slot[j] == j
                     ? __ldcg(A + (size_t)sh.pv[j] * ld + c0 + c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int idx = u * THREADS + tid;
        U[idx] = top[u];
        Lo[idx] = low[u];
      }
      __syncthreads();
      if (warp == 0 && lane < w) {
        for (int j = 0; j < nb; ++j) {
          const int p = sh.pv[j];
          if (p == k0 + j) continue;
          float* b = p < c1 ? U + (p - k0) * CT + lane : Lo + sh.slot[j] * CT + lane;
          const float tmp = U[j * CT + lane];
          U[j * CT + lane] = *b;
          *b = tmp;
        }
        for (int j = 0; j < nb; ++j)
          if (sh.pv[j] >= c1 && sh.slot[j] == j)
            __stcg(A + (size_t)sh.pv[j] * ld + c0 + lane, Lo[j * CT + lane]);
      }
      __syncthreads();
      constexpr int CPW = CT / WARPS;
      float v[CPW];
#pragma unroll
      for (int cc = 0; cc < CPW; ++cc) {
        const int c = warp * CPW + cc;
        v[cc] = lane < nb && c < w ? U[lane * CT + c] : 0.f;
      }
#pragma unroll
      for (int l = 0; l + 1 < NB; ++l) {   // past nb: zero terms
        const float li = lane < nb ? sh.L11[lane < NB ? lane : 0][l] : 0.f;
#pragma unroll
        for (int cc = 0; cc < CPW; ++cc) {
          const float ul = __shfl_sync(0xffffffffu, v[cc], l);
          if (lane > l) v[cc] = v[cc] - li * ul;
        }
      }
#pragma unroll
      for (int cc = 0; cc < CPW; ++cc) {
        const int c = warp * CPW + cc;
        if (lane < nb && c < w) {
          U[lane * CT + c] = v[cc];
          __stcg(A + (size_t)(k0 + lane) * ld + c0 + c, v[cc]);
        }
      }
    }
    __syncthreads();
    // (c): A22 -= L21 U12 on the owned tiles, RC rows at a time; the
    // chunk's L21 and the first tile's rows are loaded together. Rank 0
    // also keeps the next panel's columns of its tile in its strip.
    constexpr int RW = RC / WARPS;
    const int nb_next = min(NB, n - c1);
    for (int r0 = c1; r0 < n; r0 += RC) {
      const int h = min(RC, n - r0);
      float a[RW];
      for (int q = 0; q < nq; ++q) {
        const int t = rank == 0 ? 0 : rank + (CLUSTER - 1) * q;
        const int c0 = tile_start<NB>(c1, t);
        const bool live = lane < tile_width<NB>(n, c1, t);
        float* col = A + c0 + lane;
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const int r = warp + WARPS * k;
          a[k] = live && r < h ? __ldcg(col + (size_t)(r0 + r) * ld) : 0.f;
        }
        if (q == 0) {
          load_block<NB, RC * NB / THREADS>(A, ld, r0, h, k0, nb, &sh.Lc[0][0], NB + 1);
          __syncthreads();
        }
        if (live) {
          const float* U = Ut + q * NB * CT;
#pragma unroll
          for (int l = 0; l < NB; ++l) {   // past nb: zero terms (L21 and U12 zero-filled)
            const float uv = U[l * CT + lane];
#pragma unroll
            for (int k = 0; k < RW; ++k) a[k] = a[k] - sh.Lc[warp + WARPS * k][l] * uv;
          }
#pragma unroll
          for (int k = 0; k < RW; ++k) {
            const int r = warp + WARPS * k;
            if (r < h) {
              __stcg(col + (size_t)(r0 + r) * ld, a[k]);
              if (rank == 0 && lane < nb_next) P[(r0 + r - c1) * (NB + 1) + lane] = a[k];
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (rank == 0 && c1 < n) {
    __syncthreads();
    factor_panel<NB>(A, n, ld, c1, piv, P, row_at, row_at + n, sh, true);
  }
}

// the back substitution, blocked by BS rows (whatever the panel width);
// x ends in xs (shared) of every block
template <int NB>
__device__ __forceinline__ void back_substitute(float* A, int n, int ld, int rank, float* xs,
                                                Shared<NB>& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r0 = ((n - 1) / BS) * BS; r0 >= 0; r0 -= BS) {
    const int h = min(BS, n - r0);
    load_block<BS, (BS * BS + THREADS - 1) / THREADS>(A, ld, r0, h, r0, h, &sh.Ub[0][0], BS + 1);
    __syncthreads();
    if (warp == 0) {
      float v = lane < h ? __ldcg(A + (size_t)(r0 + lane) * ld + n) : 0.f;
#pragma unroll
      for (int r = BS - 1; r >= 0; --r) {
        if (r < h) {
          if (lane == r) v = v * sh.Ub[r][r];   // the pivot's reciprocal
          const float xr = __shfl_sync(0xffffffffu, v, r);
          if (lane < r) v = v - sh.Ub[lane][r] * xr;
        }
      }
      if (lane < h) xs[r0 + lane] = v;
    }
    __syncthreads();
    if (r0 == 0) break;
    // the rows above, BR at a time per warp with their loads in flight
    constexpr int BR = 4;
    const float xl = lane < h ? xs[r0 + lane] : 0.f;
    for (int rb = rank * WARPS + warp; rb < r0; rb += BR * CLUSTER * WARPS) {
      float s[BR], c[BR];
#pragma unroll
      for (int u = 0; u < BR; ++u) {
        const int r = rb + u * CLUSTER * WARPS;
        s[u] = r < r0 && lane < h ? __ldcg(A + (size_t)r * ld + r0 + lane) : 0.f;
        c[u] = r < r0 && lane == 0 ? __ldcg(A + (size_t)r * ld + n) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BR; ++u) {
        s[u] = s[u] * xl;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        const int r = rb + u * CLUSTER * WARPS;
        if (lane == 0 && r < r0) __stcg(A + (size_t)r * ld + n, c[u] - s[u]);
      }
    }
    cluster_sync();
  }
}

// The whole solve, called by every thread of every block of the cluster:
// A [n, n + 1] (row stride n + 1) is overwritten with the factors, piv
// [n] receives the pivot rows, and x ends in dyn[0, n) of every block
// (where the strip was). `cap` >= n sizes the shared memory (the launch's smem_bytes<NB>,
// fits<NB>); n may be 0.
template <int NB>
__device__ void solve(float* A, int n, int* piv, int cap, float* dyn) {
  __shared__ Shared<NB> sh;
  if (n <= 0) return;
  const int rank = (int)cg::this_cluster().block_rank();
  const int ld = n + 1;
  float* P = dyn;
  int* row_at = (int*)(dyn + (size_t)cap * (NB + 1));   // then pos_of, n more
  float* Ut = dyn + (size_t)cap * (NB + 3);
  float* Low = Ut + (size_t)tiles_per_block(cap) * NB * CT;
  if (rank == 0) factor_panel<NB>(A, n, ld, 0, piv, P, row_at, row_at + n, sh, false);
  cluster_sync();
  for (int k0 = 0; k0 < n; k0 += NB) {
    update<NB>(A, n, ld, k0, piv, rank, P, row_at, Ut, Low, sh);
    cluster_sync();
  }
  back_substitute<NB>(A, n, ld, rank, P, sh);
}

// the panel width for systems of up to `cap` rows: 32 while the strip fits
// in shared memory, else 16; 0 if neither does
inline int panel_width(int cap) { return fits<32>(cap) ? 32 : fits<16>(cap) ? 16 : 0; }

// one cluster of CLUSTER blocks, `smem` bytes of dynamic shared memory each
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace dense_lu
