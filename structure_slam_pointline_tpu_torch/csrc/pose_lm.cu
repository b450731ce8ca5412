// Kernel 4: pose-only Gauss-Newton with chi2 rounds, one block per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/pose_opt.py
// `pose_optimize` (:114, `_chol_solve6` :43, `round_body` :208). The
// reference unrolls the rounds x iterations schedule into one XLA program
// and lays the per-edge Jacobians out as [6, R] planes for the TPU's
// (8, 128) tiles, contracting them on the MXU each iteration. Here the
// whole schedule is ONE launch of one 256-thread block. Points and lines
// are both taken: a line contributes its start- and end-point rows
// (e = l . (u, v, 1)), each a task of its own.
//
// Bound on the card: operations, ~170 flops per active edge row per pass
// over ~30 passes, nanoseconds at the card's rate for the few hundred active
// rows of a frame (the input is ~40 B per landmark, ~100 KB at N = 2048,
// M = 256). What sets the time is the chain of dependent steps in each pass
// (a row's projection, the block-wide sum, the 6x6 solve) and, with many
// active rows, the one SM's issue rate in the edge pass. The first design
// (thread 0 solving while 255 threads waited, three barriers an iteration,
// every pass striding over all N + M rows in global memory) took ~4 us a
// pass. This design shortens the chain:
// - the masked rows' inputs (points, their observations and information
//   1 / max(sigma2, 1e-12); the lines' endpoints, coefficients and
//   information) are staged once into dynamic shared memory, compacted:
//   each thread loads the masks of a run of rows, one scan numbers the
//   masked ones, and a thread per candidate loads its inputs. After that
//   no pass reads global memory. Only masked rows can ever be inliers, and
//   the main path masks ~150 of its 2304 rows;
// - each classification (rounds + 1 of them, the reference's floor of 10
//   edges included) compacts the active rows into a task list by ballots
//   and one scan of the warps' counts, so an iteration's edge pass gives
//   the active rows evenly to the threads;
// - an iteration has ONE block-wide barrier: each thread accumulates its
//   rows' (H | g | cost) partials (21 + 6 + 1 floats, fused multiply-adds)
//   in registers; each warp adds its lanes' partials through a padded
//   [32][33] tile in shared memory, lane k adding column k (a butterfly of
//   shuffles cost ~2,000 cycles an iteration, four times the tile), and
//   writes them to its slot of a shared array double-buffered by iteration
//   parity; after the barrier, in every warp, lane k adds entry k over the
//   8 slots in one fixed order and the warp reads the totals back as
//   float4s. Every thread then runs the damped 6x6 Cholesky, the 0.5 step
//   clip and se3_exp in registers, so all threads hold the same pose and no
//   broadcast barrier is needed;
// - the solve's chain is cut to its dependencies: a pivot's reciprocal
//   square root (rsqrtf) in place of a square root and a division, the two
//   substitutions multiplying by it, the multiply-subtracts fused;
// - the kernel counts the final inliers itself (`n_inliers`) and reads the
//   three landmark arrays through their own pointers and row strides, so
//   the wrapper launches nothing around it.
// An iteration at the main path's ~150 active rows now takes ~3,600 SM
// cycles (`tools/pose_lm_trace.py`): the solve ~1,150 (eight warps run it
// at once), a row's projection and accumulation ~900, the warp sums ~560,
// the totals ~380, the barrier ~170. Spreading the edge pass over a cluster
// would shorten only the row's part, and only with many active rows.
//
// Numerics: float32 throughout; the reductions sum in another order than
// the plain version's matmul, the products are fused and the pivots, the
// Huber weight and the step clip use rsqrtf (2 ulp): the same function to
// float32's rounding, not bit for bit (the parity check holds the pose to
// 1e-4 and the inlier masks to 99.5%). All threads reduce in the same
// order, so the redundant solves agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int NACC = 28;  // 21 upper-triangular H, 6 g, 1 cost
constexpr unsigned FULL = 0xffffffffu;
constexpr int PT_REC = 6;   // X (3), obs (2), info
constexpr int LN_REC = 10;  // start (3), end (3), l (3), info
constexpr int SMEM_MAX = 232448;  // a block's shared memory on the H100

struct Params {
  const float* pts;  // [N, 3], rows pts_stride floats apart
  const float* sw;   // [M, 3] line starts, rows sw_stride apart
  const float* ew;   // [M, 3] line ends, rows ew_stride apart
  int pts_stride, sw_stride, ew_stride;
  const float* obs_uv;  // [N, 2]
  const bool* pt_mask;
  const float* pt_sigma2;
  const float* line_obs;  // [M, 3]
  const bool* ln_mask;
  const float* ln_sigma2;
  int N, M;
  float fx, fy, cx, cy;
  float chi2_mono, chi2_line, delta_pt, delta_ln;
};

// the staged edges: masked points first (records 0..npc-1), then masked
// lines; `row` is each candidate's input row, `flag` its current class,
// `task` the active rows (c >= 0: point record c; -1 - (2 lc + e): line
// record lc, endpoint e)
struct Stage {
  float* pt;
  float* ln;
  int* row;
  int* task;
  uint8_t* flag;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline size_t stage_bytes(int N, int M) {
  return align16(sizeof(float) * PT_REC * N) + align16(sizeof(float) * LN_REC * M) +
         align16(sizeof(int) * (N + M)) + align16(sizeof(int) * (N + 2 * M)) +
         align16((size_t)(N + M));
}

struct Proj {
  float u, v, z, Ju[6], Jv[6];
};

__device__ __forceinline__ void project(const float* T, const float* Xp, float fx,
                                        float fy, float cx, float cy, Proj& p) {
  const float X0 = Xp[0], X1 = Xp[1], X2 = Xp[2];
  const float x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  const float y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float z = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const float iz = __frcp_rn(fabsf(z) < 1e-6f ? 1e-6f : z);  // = 1.f / z, rounded alike
  p.u = fx * x * iz + cx;
  p.v = fy * y * iz + cy;
  p.z = z;
  const float a = fx * iz, c = -fx * x * iz * iz;
  const float b = fy * iz, d = -fy * y * iz * iz;
  p.Ju[0] = c * y; p.Ju[1] = a * z - c * x; p.Ju[2] = -a * y;
  p.Ju[3] = a;     p.Ju[4] = 0.f;           p.Ju[5] = c;
  p.Jv[0] = -b * z + d * y; p.Jv[1] = -d * x; p.Jv[2] = b * x;
  p.Jv[3] = 0.f;            p.Jv[4] = b;      p.Jv[5] = d;
}

__device__ __forceinline__ float huber(float chi2, float delta) {
  return fminf(1.f, delta * rsqrtf(fmaxf(chi2, 1e-12f)));
}

// acc += w * J J^T (upper triangle), g += w * J * r, as fused multiply-adds
__device__ __forceinline__ void accum(float* acc, const float* J, float w, float r) {
  float wJ[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wJ[i] = w * J[i];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) acc[k] = fmaf(wJ[i], J[j], acc[k]);
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] = fmaf(wJ[i], r, acc[21 + i]);
}

// class of candidate c under pose T; `gated` adds the chi2 gates (every
// classification but the first round's and the floor's fallback)
__device__ __forceinline__ bool classify(const Params& P, const Stage& S, const float* T,
                                         int c, int npc, bool gated) {
  Proj p;
  if (c < npc) {
    const float* r = S.pt + PT_REC * c;
    project(T, r, P.fx, P.fy, P.cx, P.cy, p);
    bool in = p.z > 0.f;
    if (gated) {
      const float ru = r[3] - p.u, rv = r[4] - p.v;
      in = in && (ru * ru + rv * rv) * r[5] <= P.chi2_mono;
    }
    return in;
  }
  const float* r = S.ln + LN_REC * (c - npc);
  bool in = true, ep_ok = true;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    project(T, r + 3 * e, P.fx, P.fy, P.cx, P.cy, p);
    in = in && p.z > 0.f;
    const float res = r[6] * p.u + r[7] * p.v + r[8];
    ep_ok = ep_ok && res * res * r[9] <= P.chi2_line;
  }
  return gated ? (in && ep_ok) : in;
}

// the warp's chunk of [0, n): 32-aligned contiguous spans, one per warp
__device__ __forceinline__ void warp_span(int n, int& lo, int& hi) {
  const int per = ((n + NW - 1) / NW + 31) & ~31;
  const int w = threadIdx.x >> 5;
  lo = min(w * per, n);
  hi = min(lo + per, n);
}

// every warp's count before this one (and the total), from counts[NW]
__device__ __forceinline__ int warp_offset(const int* counts, int* total) {
  const int w = threadIdx.x >> 5;
  int off = 0, tot = 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    off += q < w ? counts[q] : 0;
    tot += counts[q];
  }
  *total = tot;
  return off;
}

// classify every candidate of this warp's span, store the flags and count
// the active edges (items) and rows (tasks: a line has two)
__device__ __forceinline__ void classify_span(const Params& P, const Stage& S, const float* T,
                                              int nc, int npc, bool gated, int* items,
                                              int* tasks) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int lo, hi;
  warp_span(nc, lo, hi);
  int ci = 0, ct = 0;
  for (int base = lo; base < hi; base += 32) {
    const int c = base + lane;
    const bool in = c < hi && classify(P, S, T, c, npc, gated);
    if (c < hi) S.flag[c] = in;
    const unsigned bp = __ballot_sync(FULL, in && c < npc);
    const unsigned bl = __ballot_sync(FULL, in && c >= npc);
    ci += __popc(bp) + __popc(bl);
    ct += __popc(bp) + 2 * __popc(bl);
  }
  if (lane == 0) {
    items[w] = ci;
    tasks[w] = ct;
  }
}

// the active rows of this warp's span into the task list, in candidate
// order (the flags are the ones this lane wrote in classify_span)
__device__ __forceinline__ void write_tasks(const Stage& S, int nc, int npc, int off) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int lo, hi;
  warp_span(nc, lo, hi);
  for (int base = lo; base < hi; base += 32) {
    const int c = base + lane;
    const bool in = c < hi && S.flag[c];
    const unsigned bp = __ballot_sync(FULL, in && c < npc);
    const unsigned bl = __ballot_sync(FULL, in && c >= npc);
    if (in) {
      const int pos = off + __popc(bp & lt) + 2 * __popc(bl & lt);
      if (c < npc) {
        S.task[pos] = c;
      } else {
        const int lc = c - npc;
        S.task[pos] = -1 - 2 * lc;
        S.task[pos + 1] = -2 - 2 * lc;
      }
    }
    off += __popc(bp) + 2 * __popc(bl);
  }
}

// the warp's sums of its lanes' 28 partials, lane k holding entry k: each
// lane writes its partials as a row of the warp's [32][33] tile (the pad
// keeps the rows' and the columns' accesses on distinct banks), and lane k
// adds column k in lane order
__device__ __forceinline__ float warp_column_sum(const float (&v)[NACC], float (*tile)[33]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the previous iteration's reads of the tile are done
#pragma unroll
  for (int k = 0; k < NACC; ++k) tile[lane][k] = v[k];
  __syncwarp();
  float s = 0.f;
  if (lane < NACC) {
#pragma unroll
    for (int j = 0; j < 32; ++j) s += tile[j][lane];
  }
  return s;
}

// damped Cholesky solve, step clip, T <- exp(dx) T (every thread, in
// registers; the elimination order of the reference's `_chol_solve6`). The
// chain of dependent steps is what an iteration waits on, so it is kept
// short: each pivot's reciprocal square root (rsqrtf) in place of a square
// root and a division, the substitutions multiplying by it, the
// multiply-subtracts fused, the clip by 0.5 / |dx| through rsqrtf
__device__ __forceinline__ void solve_and_update(const float* tot, float lam, float* T) {
  float A[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) { A[i][j] = tot[k]; A[j][i] = tot[k]; }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    b[i] = tot[21 + i];
    A[i][i] = A[i][i] + lam * A[i][i] + 1e-8f;
  }
  float L[6][6], inv_d[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = fmaf(-L[j][q], L[j][q], s);
    inv_d[j] = rsqrtf(fmaxf(s, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) t = fmaf(-L[i][q], L[j][q], t);
      L[i][j] = t * inv_d[j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s = fmaf(-L[i][q], y[q], s);
    y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s = fmaf(-L[q][i], x[q], s);
    x[i] = s * inv_d[i];
  }
  float nrm2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) nrm2 = fmaf(x[i], x[i], nrm2);
  const float sc = fminf(1.f, 0.5f * rsqrtf(fmaxf(nrm2, 1e-18f)));
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] *= sc;
  // se3_exp with the reference's small-angle branch (utils/lie.py)
  const float w0 = x[0], w1 = x[1], w2 = x[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  float Ac, Bc, Cc;
  if (th2 < 1e-4f) {
    Ac = 1.f - th2 * (1.f / 6.f);
    Bc = 0.5f - th2 * (1.f / 24.f);
    Cc = 1.f / 6.f - th2 * (1.f / 120.f);
  } else {
    const float inv_th = rsqrtf(th2), th = th2 * inv_th;
    float sn, cs;
    sincosf(th, &sn, &cs);
    const float inv_th2 = inv_th * inv_th;
    Ac = sn * inv_th; Bc = (1.f - cs) * inv_th2; Cc = (th - sn) * inv_th2 * inv_th;
  }
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float tv = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[i][j] = id + Ac * W[i][j] + Bc * W2[i][j];
      tv += (id + Bc * W[i][j] + Cc * W2[i][j]) * x[3 + j];
    }
    E[i][3] = tv;
  }
  float Tn[12];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                      (j == 3 ? E[i][3] : 0.f);
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = Tn[q];
}

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(Params P, const float* __restrict__ T_init, int rounds, int iters,
               float lam, float* __restrict__ T_out, bool* __restrict__ pt_in,
               bool* __restrict__ ln_in, float* __restrict__ cost_out,
               int* __restrict__ n_inliers) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][NW][32];
  __shared__ float tiles[NW][32][33];
  __shared__ float4 totals[NW][NACC / 4];
  __shared__ int cnt_items[2][NW], cnt_tasks[2][NW], scan_w[NW];
  const int N = P.N, M = P.M;
  Stage S;
  {
    unsigned char* p = smem;
    S.pt = (float*)p;   p += align16(sizeof(float) * PT_REC * N);
    S.ln = (float*)p;   p += align16(sizeof(float) * LN_REC * M);
    S.row = (int*)p;    p += align16(sizeof(int) * (N + M));
    S.task = (int*)p;   p += align16(sizeof(int) * (N + 2 * M));
    S.flag = (uint8_t*)p;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float T[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) T[q] = T_init[q];

  // stage the masked rows, in row order (points, then lines). Thread t
  // owns a run of at most 32 consecutive rows and loads their masks into a
  // bit mask (32 loads from clamped addresses, none behind a branch, so
  // they are in flight together; an unmasked row is never an inlier, its
  // output is written here); one scan of the block numbers the masked
  // points and lines, the owners write each candidate's row, and thread c
  // loads candidate c's inputs
  const int n_rows = N + M;
  const int per_t = (n_rows + THREADS - 1) / THREADS;  // <= 32: the C entry checks
  const int r0 = min(threadIdx.x * per_t, n_rows), r1 = min(r0 + per_t, n_rows);
  unsigned my_rows = 0;
  if (n_rows > 0) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = min(r0 + k, n_rows - 1);
      const bool* src = i < N ? P.pt_mask + i : P.ln_mask + (i - N);
      my_rows |= (*src && r0 + k < r1 ? 1u : 0u) << k;
    }
  }
  for (int i = r0; i < r1; ++i) {
    if (!((my_rows >> (i - r0)) & 1u)) {
      if (i < N) pt_in[i] = false; else ln_in[i - N] = false;
    }
  }
  const unsigned pt_bits = N - r0 >= 32 ? FULL : (N > r0 ? (1u << (N - r0)) - 1u : 0u);
  const int n_pt_mine = __popc(my_rows & pt_bits), n_ln_mine = __popc(my_rows & ~pt_bits);
  // exclusive scan of (points << 16 | lines) over the threads
  const int mine = n_pt_mine | (n_ln_mine << 16);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) scan_w[w] = incl;
  __syncthreads();
  int before = incl - mine, total = 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    before += q < w ? scan_w[q] : 0;
    total += scan_w[q];
  }
  const int npc = total & 0xffff, nc = npc + (total >> 16);
  {
    int c_pt = before & 0xffff, c_ln = npc + (before >> 16);
    for (unsigned b = my_rows; b; b &= b - 1u) {
      const int i = r0 + __ffs(b) - 1;
      if (i < N) S.row[c_pt++] = i; else S.row[c_ln++] = i - N;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += THREADS) {
    const int i = S.row[c];
    if (c < npc) {
      float* r = S.pt + PT_REC * c;
      const float* X = P.pts + (size_t)i * P.pts_stride;
      r[0] = X[0]; r[1] = X[1]; r[2] = X[2];
      r[3] = P.obs_uv[2 * i]; r[4] = P.obs_uv[2 * i + 1];
      r[5] = __frcp_rn(fmaxf(P.pt_sigma2[i], 1e-12f));
    } else {
      float* r = S.ln + LN_REC * (c - npc);
      const float* s = P.sw + (size_t)i * P.sw_stride;
      const float* e = P.ew + (size_t)i * P.ew_stride;
      const float* l = P.line_obs + 3 * i;
      r[0] = s[0]; r[1] = s[1]; r[2] = s[2];
      r[3] = e[0]; r[4] = e[1]; r[5] = e[2];
      r[6] = l[0]; r[7] = l[1]; r[8] = l[2];
      r[9] = __frcp_rn(fmaxf(P.ln_sigma2[i], 1e-12f));
    }
  }
  __syncthreads();

  float cost = 0.f;
  int it_all = 0;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    // classify, the floor of 10 edges, the active rows compacted
    classify_span(P, S, T, nc, npc, rnd > 0, cnt_items[0], cnt_tasks[0]);
    __syncthreads();
    int n_act, n_task;
    warp_offset(cnt_items[0], &n_act);
    const int* tasks_of = cnt_tasks[0];
    if (rnd > 0 && n_act < 10) {
      classify_span(P, S, T, nc, npc, false, cnt_items[1], cnt_tasks[1]);
      __syncthreads();
      tasks_of = cnt_tasks[1];
    }
    write_tasks(S, nc, npc, warp_offset(tasks_of, &n_task));
    __syncthreads();

    for (int it = 0; it < iters; ++it, ++it_all) {
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
      for (int t = threadIdx.x; t < n_task; t += THREADS) {
        const int code = S.task[t];
        Proj p;
        if (code >= 0) {
          const float* r = S.pt + PT_REC * code;
          project(T, r, P.fx, P.fy, P.cx, P.cy, p);
          const float ru = r[3] - p.u, rv = r[4] - p.v;
          const float chi2 = (ru * ru + rv * rv) * r[5];
          const float wt = huber(chi2, P.delta_pt) * r[5];
          accum(acc, p.Ju, wt, ru);
          accum(acc, p.Jv, wt, rv);
          acc[27] += fminf(chi2, P.chi2_mono * 4.f);
        } else {
          const int lc = (-1 - code) >> 1, e = (-1 - code) & 1;
          const float* r = S.ln + LN_REC * lc;
          project(T, r + 3 * e, P.fx, P.fy, P.cx, P.cy, p);
          const float res = r[6] * p.u + r[7] * p.v + r[8];
          const float chi2 = res * res * r[9];
          const float wt = huber(chi2, P.delta_ln) * r[9];
          float Jl[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) Jl[q] = r[6] * p.Ju[q] + r[7] * p.Jv[q];
          accum(acc, Jl, wt, -res);
          acc[27] += fminf(chi2, P.chi2_line * 4.f);
        }
      }
      float(*tile)[33] = tiles[w];
      const float part = warp_column_sum(acc, tile);
      float(*slot)[32] = red[it_all & 1];
      if (lane < NACC) slot[w][lane] = part;
      __syncthreads();
      // lane k adds entry k over the warps in one fixed order and hands the
      // totals to its warp through shared memory (read back as float4s)
      float* tw = reinterpret_cast<float*>(totals[w]);
      if (lane < NACC) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NW; ++q) s += slot[q][lane];
        tw[lane] = s;
      }
      __syncwarp();
      float tot[NACC];
#pragma unroll
      for (int k = 0; k < NACC / 4; ++k) {
        const float4 v = totals[w][k];
        tot[4 * k] = v.x; tot[4 * k + 1] = v.y; tot[4 * k + 2] = v.z; tot[4 * k + 3] = v.w;
      }
      cost = tot[27];
      solve_and_update(tot, lam, T);
    }
  }

  // the final classification (gated, no floor) and the inlier count
  classify_span(P, S, T, nc, npc, true, cnt_items[0], cnt_tasks[0]);
  {
    int clo, chi;
    warp_span(nc, clo, chi);
    for (int c = clo + lane; c < chi; c += 32) {
      if (c < npc) pt_in[S.row[c]] = S.flag[c]; else ln_in[S.row[c]] = S.flag[c];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n_act;
    warp_offset(cnt_items[0], &n_act);
    *n_inliers = n_act;
    *cost_out = cost;
#pragma unroll
    for (int q = 0; q < 12; ++q) T_out[q] = T[q];
#pragma unroll
    for (int q = 12; q < 16; ++q) T_out[q] = T_init[q];
  }
}

}  // namespace

extern "C" int sspl_pose_lm(const void* T_init, const void* pts, int pts_stride,
                            const void* sw, int sw_stride, const void* ew, int ew_stride,
                            const void* obs_uv, const void* pt_mask, const void* pt_sigma2,
                            const void* line_obs, const void* ln_mask, const void* ln_sigma2,
                            int N, int M, float fx, float fy, float cx, float cy, int rounds,
                            int iters, float chi2_mono, float chi2_line, float delta_pt,
                            float delta_ln, float lam, void* T_out, void* pt_in, void* ln_in,
                            void* cost, void* n_inliers, void* stream) {
  static size_t smem_set = 0;
  const size_t smem = stage_bytes(N, M);
  // the static part: the reduction slots and the warps' counts
  const size_t smem_static =
      sizeof(float) * (2 * NW * 32 + NW * 32 * 33 + NW * NACC) + sizeof(int) * 5 * NW;
  // the staged rows must fit a block's shared memory, and a thread stages
  // at most 32 rows
  if (smem + smem_static > SMEM_MAX || N + M > 32 * THREADS) return (int)cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  Params P{(const float*)pts, (const float*)sw, (const float*)ew, pts_stride, sw_stride,
           ew_stride, (const float*)obs_uv, (const bool*)pt_mask, (const float*)pt_sigma2,
           (const float*)line_obs, (const bool*)ln_mask, (const float*)ln_sigma2, N, M,
           fx, fy, cx, cy, chi2_mono, chi2_line, delta_pt, delta_ln};
  pose_lm_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      P, (const float*)T_init, rounds, iters, lam, (float*)T_out, (bool*)pt_in,
      (bool*)ln_in, (float*)cost, (int*)n_inliers);
  return (int)cudaGetLastError();
}
