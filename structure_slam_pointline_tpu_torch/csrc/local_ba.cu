// Kernel 12: local bundle adjustment (poses + points + line endpoints) by
// Gauss-Newton with a Schur complement, the whole schedule on the device.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/local_ba.py
// `bundle_adjust` (:226). The reference lays the [KL, F] edges out as dense
// [KL, PL] camera x landmark planes, builds every Jacobian as a plane,
// reduces the 3x3 landmark blocks over KL and the 6x6 camera blocks over
// PL, forms the Schur product A Hpp^-1 A^T as one MXU matmul
// (`_schur_block`, :146) and solves the 96x96 reduced camera system with
// jnp.linalg.solve, 5 iterations, the chi2 cut, 15 more (~10^4 torch ops
// per call as plain torch, and a host sync per iteration in
// torch.linalg.solve's error check).
//
// Here the schedule is a fixed sequence of launches with no host round
// trip (4 per iteration, 85 per call). The same library exports the
// solver of dense_lu.cuh alone (`dense_solve`, counted apart; no path
// calls it) for timing and testing it on one system.
//  ba_grid      one thread per [KL, F] (and [KL, LF]) edge: scatter the
//               observations into dense [KL, PL, 4] / [KL, LL, 5] grids
//               (float atomicAdd; exact and order-free while a keyframe
//               row binds each landmark at most once, as the map keeps it).
//  ba_classify  one thread per point or line: the phase's edge bits
//               (mode 0: every edge; mode 1: the chi2 cut; mode 2: the
//               final inliers) and the landmark's free flag (>= 2 edges).
//  ba_landmarks one thread per point or line (a line owns its two
//               endpoint columns): projects into every camera it is seen
//               in, forms residual, Huber weight and Jacobians, writes each
//               edge's 6x3 block A, its Hcc / bc terms, accumulates Hpp and
//               bp in registers, forms the damped adjugate inverse with the
//               trace-relative floor, and writes A Hpp^-1 per edge.
//  ba_reduce    one block per camera pair (k1 <= k2, both free) sums
//               A Hpp^-1 A^T over the landmarks; one block per free camera
//               sums Hcc, bc and A Hpp^-1 bp. Each thread strides over
//               landmarks in a fixed order and a fixed shuffle + shared
//               tree reduces: no atomics, so S is the same on every run.
//  ba_solve     one thread-block cluster (dense_lu.cuh): its blocks
//               assemble S + 1e-6 I and the right side over the free
//               cameras' rows (6 n_free: 96 at most at KL = 16, 378 at
//               global BA's 64) into an L2-resident matrix, the cluster
//               solves it by blocked LU with partial pivoting (first row on
//               ties) and back substitution, rank 0 applies the 0.5 step
//               clip and T <- exp(dx) T, and the last rank sums the
//               iteration's cost.
//  ba_backsub   one thread per landmark column: dx_p = Hpp^-1 (bp - A^T dx_c),
//               clipped to norm 0.5.
//  ba_edges     one thread per edge: the final inlier masks on [KL, F] and
//               [KL, LF].
//
// Bound on the card: operations, a few hundred per active edge per
// iteration (projection, Jacobians, the 6x6 and 6x3 blocks) plus the
// Schur products of the co-visible pairs and the (6 n_free)^3 / 3 solve,
// against ~0.5 MB of inputs. The launch chain and the solve's chain of
// dependent pivot steps set the time: the card is latency-bound here, not
// throughput-bound. The solve spreads its trailing updates over the
// cluster and factors the next panel while they run (dense_lu.cuh).
//
// The sharded form (optim/local_ba.py `bundle_adjust_sharded`, for
// parallel/dist_ba.py `shard_bundle_adjust`; replaces the reference's
// shard_map of the same schedule, parallel/dist_ba.py:66, with psum over
// the landmark axis, optim/local_ba.py:532-555) runs the same launches on
// each landmark shard's own Work, with three differences, all switched by
// Work fields that the unsharded form leaves at 0 / null:
//  - ba_grid and ba_edges read edge ids relative to the shard's first
//    column (`col0`, `ln_col0`): a shard owns the edges whose landmark
//    falls in [col0, col0 + PL), as the reference's `rel = edge_mp - col0`;
//  - ba_reduce writes the shard's partial Sred / Hk and, in one more block,
//    its partial cost (`cost_part`), all summed in a fixed order by the
//    wrapper (and over the process group) before the solve;
//  - ba_solve then reads the summed buffers through its own Work (the
//    damping is added there, once, after the sum) and copies the summed
//    cost instead of summing landmark costs.
// Each shard's ba_edges writes its own flags (false where another shard
// owns the edge); the wrapper ORs them.
//
// Up to 64 cameras (global BA's window, optim/global_ba.py): a landmark's
// edge sets are 64-bit masks. Local BA's 10-16 cameras run the same
// arithmetic as with 32-bit masks, and the same solve.
//
// Numerics: float32; every per-edge formula follows the plain version's
// op order, but the sums over landmarks and cameras run in another order
// than torch's reductions and cuBLAS / cuSOLVER, so the result agrees with
// the plain version to a tolerance (poses and landmarks within 1e-3).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_lu.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAXKL = 64;

typedef unsigned long long Bits;   // bit k: camera k
constexpr int RED_THREADS = 256;
constexpr int COST_LANES = 512;   // the cost sum's lanes (its order, fixed)

struct Work {
  int KL, F, PL, LF, LL, NJ;
  int col0, ln_col0;        // the shard's first point / line column (0 unsharded)
  float fx, fy, cx, cy;
  float chi2_mono, chi2_mono4, chi2_line2, chi2_line8, delta_pt, delta_ln;
  float ds;   // 1 + lam, rounded from double (the reference's `1.0 + lam`)
  float lam;
  const bool* cam_free;     // [KL] free & valid
  const bool* kf_valid;     // [KL]
  const float* obs_uv;      // [KL, F, 2]
  const float* obs_sigma2;  // [KL, F]
  const int* edge_mp;       // [KL, F]
  const bool* edge_valid;   // [KL, F]
  const bool* mp_valid;     // [PL]
  const float* obs_l;       // [KL, LF, 3]
  const float* ln_sigma2;   // [KL, LF]
  const int* edge_ln;       // [KL, LF]
  const bool* ln_edge_valid;  // [KL, LF]
  const bool* ln_valid;     // [LL]
  float* T;                 // [KL, 16] current poses (the wrapper's copy)
  float* X;                 // [NJ, 3] points, line starts, line ends
  float* pgrid;             // [KL, PL, 4] u, v, info, count
  float* lgrid;             // [KL, LL, 5] l0, l1, l2, info, count
  Bits* edge_bits;          // [PL + LL] bit k: edge in camera k
  Bits* act_bits;           // [NJ] bit k: active edge of this phase
  Bits* inl_bits;           // [PL + LL] final inliers
  float* A;                 // [KL, NJ, 18]
  float* AHi;               // [KL, NJ, 18]
  float* HB;                // [KL, NJ, 27] Hcc upper 21, sum wJ r 6
  float* Hpi;               // [NJ, 9]
  float* bp;                // [NJ, 3]
  float* lm_cost;           // [PL + LL]
  float* Sred;              // [KL (KL + 1) / 2, 36]
  float* Hk;                // [KL, 33] Hcc 21, sum wJ r 6, A Hpp^-1 bp 6
  float* dxc;               // [KL, 6]
  float* cost;              // [1]
  float* Sg;                // [6KL (6KL + 1)] the solve's augmented matrix
  float* cost_part;         // sharded: [1] the shard's cost (ba_reduce), or
                            // the summed cost (ba_solve); null unsharded
  int* piv;                 // [6KL] the solve's pivot rows
};

struct Proj {
  float x, y, z, u, v, a, b, c, d;
};

__device__ __forceinline__ void load_cam(const float* T, int k, float* R, float* t) {
  const float* Tk = T + 16 * k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    R[3 * i] = Tk[4 * i];
    R[3 * i + 1] = Tk[4 * i + 1];
    R[3 * i + 2] = Tk[4 * i + 2];
    t[i] = Tk[4 * i + 3];
  }
}

// `_project_planes` of the plain version, op for op
__device__ __forceinline__ Proj project(const float* R, const float* t, const float* X,
                                        const Work& W) {
  Proj p;
  p.x = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  p.y = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  p.z = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  const float iz = 1.f / (fabsf(p.z) < 1e-6f ? 1e-6f : p.z);
  p.u = W.fx * p.x * iz + W.cx;
  p.v = W.fy * p.y * iz + W.cy;
  p.a = W.fx * iz;
  p.c = -W.fx * p.x * iz * iz;
  p.b = W.fy * iz;
  p.d = -W.fy * p.y * iz * iz;
  return p;
}

// `_jacobian_planes`: residual rows w.r.t. the pose (Ju, Jv) and the point
__device__ __forceinline__ void jacobians(const Proj& p, const float* R, float* Ju,
                                          float* Jv, float* Jxu, float* Jxv) {
  Ju[0] = -(p.c * p.y); Ju[1] = -(p.a * p.z - p.c * p.x); Ju[2] = p.a * p.y;
  Ju[3] = -p.a;         Ju[4] = 0.f;                       Ju[5] = -p.c;
  Jv[0] = -(-p.b * p.z + p.d * p.y); Jv[1] = p.d * p.x; Jv[2] = -(p.b * p.x);
  Jv[3] = 0.f;                       Jv[4] = -p.b;      Jv[5] = -p.d;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    Jxu[l] = -(p.a * R[l] + p.c * R[6 + l]);
    Jxv[l] = -(p.b * R[3 + l] + p.d * R[6 + l]);
  }
}

__device__ __forceinline__ float huber(float chi2, float delta) {
  return fminf(delta / sqrtf(fmaxf(chi2, 1e-12f)), 1.f);
}

__device__ __forceinline__ size_t blk(const Work& W, int k, int j) {
  return (size_t)k * W.NJ + j;
}

__device__ __forceinline__ int pair_index(int k1, int k2, int KL) {
  return k1 * KL - k1 * (k1 - 1) / 2 + (k2 - k1);
}

// ---- ba_grid ----
__global__ void grid_kernel(Work W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long np = (long long)W.KL * W.F;
  if (i < np) {
    const int k = (int)(i / W.F);
    const int e = W.edge_mp[i] - W.col0;
    if (!(W.edge_valid[i] && e >= 0 && e < W.PL && W.kf_valid[k])) return;
    float* g = W.pgrid + ((size_t)k * W.PL + e) * 4;
    atomicAdd(g, W.obs_uv[2 * i]);
    atomicAdd(g + 1, W.obs_uv[2 * i + 1]);
    atomicAdd(g + 2, 1.f / fmaxf(W.obs_sigma2[i], 1e-12f));
    atomicAdd(g + 3, 1.f);
    return;
  }
  const long long i2 = i - np;
  if (i2 >= (long long)W.KL * W.LF) return;
  const int k = (int)(i2 / W.LF);
  const int e = W.edge_ln[i2] - W.ln_col0;
  if (!(W.ln_edge_valid[i2] && e >= 0 && e < W.LL)) return;
  float* g = W.lgrid + ((size_t)k * W.LL + e) * 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) atomicAdd(g + q, W.obs_l[3 * i2 + q]);
  atomicAdd(g + 3, 1.f / fmaxf(W.ln_sigma2[i2], 1e-12f));
  atomicAdd(g + 4, 1.f);
}

// ---- ba_classify ----
__device__ __forceinline__ float point_chi2(const Work& W, int k, int j, float& z) {
  float R[9], t[3];
  load_cam(W.T, k, R, t);
  const float* g = W.pgrid + ((size_t)k * W.PL + j) * 4;
  const Proj p = project(R, t, W.X + 3 * j, W);
  const float ru = g[0] - p.u, rv = g[1] - p.v;
  z = p.z;
  return (ru * ru + rv * rv) * g[2];
}

__device__ __forceinline__ bool line_keep(const Work& W, int k, int l) {
  float R[9], t[3];
  load_cam(W.T, k, R, t);
  const float* g = W.lgrid + ((size_t)k * W.LL + l) * 5;
  const Proj ps = project(R, t, W.X + 3 * (W.PL + l), W);
  const Proj pe = project(R, t, W.X + 3 * (W.PL + W.LL + l), W);
  const float es = g[0] * ps.u + g[1] * ps.v + g[2];
  const float ee = g[0] * pe.u + g[1] * pe.v + g[2];
  const float cs = es * es * g[3], ce = ee * ee * g[3];
  return cs + ce <= W.chi2_line2 && ps.z > 0.f && pe.z > 0.f;
}

__global__ void classify_kernel(Work W, int mode) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W.PL + W.LL) return;
  const bool is_pt = t < W.PL;
  const int l = t - W.PL;
  Bits bits = 0;
  if (mode == 0) {
    const bool valid = is_pt ? W.mp_valid[t] : W.ln_valid[l];
    for (int k = 0; k < W.KL; ++k) {
      const float cnt = is_pt ? W.pgrid[((size_t)k * W.PL + t) * 4 + 3]
                              : W.lgrid[((size_t)k * W.LL + l) * 5 + 4];
      if (cnt > 0.5f && valid) bits |= 1ull << k;
    }
    W.edge_bits[t] = bits;
  } else {
    const Bits edge = W.edge_bits[t];
    for (int k = 0; k < W.KL; ++k) {
      if (!((edge >> k) & 1ull)) continue;
      bool keep;
      if (is_pt) {
        float z;
        const float chi2 = point_chi2(W, k, t, z);
        keep = chi2 <= W.chi2_mono && z > 0.f;
      } else {
        keep = line_keep(W, k, l);
      }
      if (keep) bits |= 1ull << k;
    }
    if (mode == 2) {
      W.inl_bits[t] = bits;
      return;
    }
  }
  const Bits act = __popcll(bits) >= 2 ? bits : 0ull;
  if (is_pt) {
    W.act_bits[t] = act;
  } else {
    W.act_bits[W.PL + l] = act;
    W.act_bits[W.PL + W.LL + l] = act;
  }
}

// ---- ba_landmarks ----
// Hpp^-1 (damped, trace-relative floor; `_plane_inv3`), the column's
// A Hpp^-1 blocks, Hpi and bp = -g.
__device__ void finish_column(const Work& W, int j, Bits act, const float* H,
                              const float* g) {
  float Hi[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Hi[q] = 0.f;
  if (act) {
    // H: upper triangle 00, 01, 02, 11, 12, 22
    const float tr = H[0] + H[3] + H[5];
    const float eps = 1e-3f * tr + 1e-6f;
    const float a_ = H[0] * W.ds + eps, b_ = H[1], c_ = H[2];
    const float e_ = H[3] * W.ds + eps, f_ = H[4];
    const float i_ = H[5] * W.ds + eps;
    const float co00 = e_ * i_ - f_ * f_;
    const float co01 = c_ * f_ - b_ * i_;
    const float co02 = b_ * f_ - c_ * e_;
    const float co11 = a_ * i_ - c_ * c_;
    const float co12 = c_ * b_ - a_ * f_;
    const float co22 = a_ * e_ - b_ * b_;
    const float det = a_ * co00 + b_ * co01 + c_ * co02;
    const float idet = 1.f / (fabsf(det) > 1e-20f ? det : 1.f);
    Hi[0] = co00 * idet; Hi[1] = co01 * idet; Hi[2] = co02 * idet;
    Hi[3] = co01 * idet; Hi[4] = co11 * idet; Hi[5] = co12 * idet;
    Hi[6] = co02 * idet; Hi[7] = co12 * idet; Hi[8] = co22 * idet;
    for (int k = 0; k < W.KL; ++k) {
      if (!((act >> k) & 1ull)) continue;
      const float* a = W.A + blk(W, k, j) * 18;
      float* ah = W.AHi + blk(W, k, j) * 18;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int l = 0; l < 3; ++l)
          ah[3 * i + l] = a[3 * i] * Hi[l] + a[3 * i + 1] * Hi[3 + l] + a[3 * i + 2] * Hi[6 + l];
    }
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) W.Hpi[9 * (size_t)j + q] = Hi[q];
#pragma unroll
  for (int l = 0; l < 3; ++l) W.bp[3 * (size_t)j + l] = -g[l];
}

// one edge's blocks: Hcc / bc terms of pose rows J (nrow of them, weight w,
// residual r), Hpp / g terms of point rows Jx, and A = wJ Jx^T
template <int NROW>
__device__ __forceinline__ void edge_blocks(const Work& W, int k, int j, float w,
                                            float (*J)[6], float (*Jx)[3], const float* r, float* H, float* g) {
  float* hb = W.HB + blk(W, k, j) * 27;
  float* a = W.A + blk(W, k, j) * 18;
  float wJ[NROW][6], wJx[NROW][3];
#pragma unroll
  for (int n = 0; n < NROW; ++n) {
#pragma unroll
    for (int i = 0; i < 6; ++i) wJ[n][i] = w * J[n][i];
#pragma unroll
    for (int l = 0; l < 3; ++l) wJx[n][l] = w * Jx[n][l];
  }
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int i2 = i; i2 < 6; ++i2) {
      float s = wJ[0][i] * J[0][i2];
      if (NROW == 2) s = s + wJ[1][i] * J[1][i2];
      hb[q++] = s;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = wJ[0][i] * r[0];
    if (NROW == 2) s = s + wJ[1][i] * r[1];
    hb[21 + i] = s;
  }
  q = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int l2 = l; l2 < 3; ++l2) {
      float s = wJx[0][l] * Jx[0][l2];
      if (NROW == 2) s = s + wJx[1][l] * Jx[1][l2];
      H[q++] += s;
    }
    float s = wJx[0][l] * r[0];
    if (NROW == 2) s = s + wJx[1][l] * r[1];
    g[l] += s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float s = wJ[0][i] * Jx[0][l];
      if (NROW == 2) s = s + wJ[1][i] * Jx[1][l];
      a[3 * i + l] = s;
    }
}

__global__ void landmarks_kernel(Work W) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W.PL + W.LL) return;
  float cost = 0.f;
  if (t < W.PL) {
    const int j = t;
    const Bits act = W.act_bits[j];
    float H[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
    for (int k = 0; k < W.KL; ++k) {
      if (!((act >> k) & 1ull)) continue;
      float R[9], tt[3];
      load_cam(W.T, k, R, tt);
      const float* gr = W.pgrid + ((size_t)k * W.PL + j) * 4;
      const float info = gr[2];
      const Proj p = project(R, tt, W.X + 3 * j, W);
      float r[2];
      r[0] = gr[0] - p.u;
      r[1] = gr[1] - p.v;
      const float chi2 = (r[0] * r[0] + r[1] * r[1]) * info;
      cost += fminf(chi2, W.chi2_mono4);
      const float w = huber(chi2, W.delta_pt) * info;
      float J[2][6], Jx[2][3];
      jacobians(p, R, J[0], J[1], Jx[0], Jx[1]);
      edge_blocks<2>(W, k, j, w, J, Jx, r, H, g);
    }
    W.lm_cost[t] = cost;
    finish_column(W, j, act, H, g);
    return;
  }
  const int l = t - W.PL;
  const int js = W.PL + l, je = W.PL + W.LL + l;
  const Bits act = W.act_bits[js];
  float H[2][6] = {}, g[2][3] = {};
  for (int k = 0; k < W.KL; ++k) {
    if (!((act >> k) & 1ull)) continue;
    float R[9], tt[3];
    load_cam(W.T, k, R, tt);
    const float* gr = W.lgrid + ((size_t)k * W.LL + l) * 5;
    const float l0 = gr[0], l1 = gr[1], l2 = gr[2], info = gr[3];
    float c2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = e ? je : js;
      const Proj p = project(R, tt, W.X + 3 * j, W);
      const float err = l0 * p.u + l1 * p.v + l2;
      c2[e] = err * err * info;
      const float w = huber(c2[e], W.delta_ln) * info;
      float Ju[6], Jv[6], Jxu[3], Jxv[3];
      jacobians(p, R, Ju, Jv, Jxu, Jxv);
      float J[1][6], Jx[1][3], r[1];
#pragma unroll
      for (int i = 0; i < 6; ++i) J[0][i] = l0 * Ju[i] + l1 * Jv[i];
#pragma unroll
      for (int m = 0; m < 3; ++m) Jx[0][m] = l0 * Jxu[m] + l1 * Jxv[m];
      r[0] = -err;
      edge_blocks<1>(W, k, j, w, J, Jx, r, H[e], g[e]);
    }
    cost += fminf(c2[0] + c2[1], W.chi2_line8);
  }
  W.lm_cost[t] = cost;
  finish_column(W, js, act, H[0], g[0]);
  finish_column(W, je, act, H[1], g[1]);
}

// ---- ba_reduce ----
template <int N>
__device__ void block_reduce_store(float* acc, float* out) {
  __shared__ float red[RED_THREADS / 32][36];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < RED_THREADS / 32; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(RED_THREADS) reduce_kernel(Work W) {
  const int npairs = W.KL * (W.KL + 1) / 2;
  const int p = blockIdx.x;
  if (p < npairs) {
    int k1 = 0, rem = p;
    while (rem >= W.KL - k1) { rem -= W.KL - k1; ++k1; }
    const int k2 = k1 + rem;
    if (!(W.cam_free[k1] && W.cam_free[k2])) return;
    float acc[36];
#pragma unroll
    for (int q = 0; q < 36; ++q) acc[q] = 0.f;
    for (int j = threadIdx.x; j < W.NJ; j += RED_THREADS) {
      const Bits bits = W.act_bits[j];
      if (!((bits >> k1) & (bits >> k2) & 1ull)) continue;
      const float* ah = W.AHi + blk(W, k1, j) * 18;
      const float* a = W.A + blk(W, k2, j) * 18;
      float av[18], hv[18];
#pragma unroll
      for (int q = 0; q < 18; ++q) { av[q] = a[q]; hv[q] = ah[q]; }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int i2 = 0; i2 < 6; ++i2)
          acc[6 * i + i2] += hv[3 * i] * av[3 * i2] + hv[3 * i + 1] * av[3 * i2 + 1] +
                             hv[3 * i + 2] * av[3 * i2 + 2];
    }
    block_reduce_store<36>(acc, W.Sred + 36 * (size_t)p);
    return;
  }
  const int k = p - npairs;
  if (k == W.KL) {
    // sharded: the shard's cost, summed as the unsharded solve sums it
    float acc[1] = {0.f};
    for (int j = threadIdx.x; j < W.PL + W.LL; j += RED_THREADS) acc[0] += W.lm_cost[j];
    block_reduce_store<1>(acc, W.cost_part);
    return;
  }
  if (!W.cam_free[k]) return;
  float acc[33];
#pragma unroll
  for (int q = 0; q < 33; ++q) acc[q] = 0.f;
  for (int j = threadIdx.x; j < W.NJ; j += RED_THREADS) {
    if (!((W.act_bits[j] >> k) & 1ull)) continue;
    const float* hb = W.HB + blk(W, k, j) * 27;
#pragma unroll
    for (int q = 0; q < 27; ++q) acc[q] += hb[q];
    const float* ah = W.AHi + blk(W, k, j) * 18;
    const float* b = W.bp + 3 * (size_t)j;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[27 + i] += ah[3 * i] * b[0] + ah[3 * i + 1] * b[1] + ah[3 * i + 2] * b[2];
  }
  block_reduce_store<33>(acc, W.Hk + 33 * (size_t)k);
}

// ---- ba_solve ----
__device__ __forceinline__ int sym6(int i, int j) {
  if (i > j) { const int s = i; i = j; j = s; }
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

__device__ void se3_update(const float* x, float* T) {
  // se3_exp with the reference's small-angle branch (utils/lie.py), T <- E T
  const float w0 = x[0], w1 = x[1], w2 = x[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  float Ac, Bc, Cc;
  if (th2 < 1e-4f) {
    Ac = 1.f - th2 / 6.f; Bc = 0.5f - th2 / 24.f; Cc = 1.f / 6.f - th2 / 120.f;
  } else {
    const float th = sqrtf(th2);
    Ac = sinf(th) / th; Bc = (1.f - cosf(th)) / th2; Cc = (th - sinf(th)) / (th2 * th);
  }
  const float Wm[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = Wm[i][0] * Wm[0][j] + Wm[i][1] * Wm[1][j] + Wm[i][2] * Wm[2][j];
  float E[3][4];
  for (int i = 0; i < 3; ++i) {
    float tv = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[i][j] = id + Ac * Wm[i][j] + Bc * W2[i][j];
      tv += (id + Bc * Wm[i][j] + Cc * W2[i][j]) * x[3 + j];
    }
    E[i][3] = tv;
  }
  float Tn[12];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      Tn[4 * i + j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                      (j == 3 ? E[i][3] : 0.f);
  for (int q = 0; q < 12; ++q) T[q] = Tn[q];
}

// The reduced camera system over the free cameras only (cam_of: row block
// -> camera): a fixed or invalid camera's rows would be (1 + 1e-6) I with
// a zero right side and zero coupling, so its step is exactly zero; the
// free rows alone give the free cameras the same step. Every block of the
// cluster assembles its share of rows into W.Sg (global memory, L2-
// resident), dense_lu.cuh solves, rank 0 applies the step and the last
// rank sums the iteration's cost.
constexpr int SOLVE_NB = 32;   // the panel width (6 KL <= 384 rows fit at 32)

__global__ void __launch_bounds__(dense_lu::THREADS) solve_kernel(Work W) {
  extern __shared__ float dyn[];
  __shared__ int cam_of[MAXKL];
  __shared__ int nblk;
  __shared__ float cred[COST_LANES / 32];
  const int rank = (int)cg::this_cluster().block_rank();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int k = 0; k < W.KL; ++k)
      if (W.cam_free[k]) cam_of[m++] = k;
    nblk = m;
  }
  __syncthreads();
  const int n = 6 * nblk, ld = n + 1;
  // S = -sum A Hpp^-1 A^T + Hcc (1 + lam on the diagonal) + 1e-6 I;
  // b = bc - A Hpp^-1 bp, as column n
  for (int r = rank; r < n; r += dense_lu::CLUSTER) {
    const int kr = cam_of[r / 6], ir = r % 6;
    for (int c = threadIdx.x; c <= n; c += dense_lu::THREADS) {
      float v;
      if (c == n) {
        v = -W.Hk[33 * kr + 21 + ir] - W.Hk[33 * kr + 27 + ir];
      } else {
        const int kc = cam_of[c / 6], ic = c % 6;
        const float* s = W.Sred + 36 * (size_t)pair_index(min(kr, kc), max(kr, kc), W.KL);
        v = -(kr <= kc ? s[6 * ir + ic] : s[6 * ic + ir]);
        if (kr == kc) v = v + W.Hk[33 * kr + sym6(ir, ic)] * (ir == ic ? 1.f + W.lam : 1.f);
        if (r == c) v = v + 1e-6f;
      }
      __stcg(W.Sg + (size_t)r * ld + c, v);
    }
  }
  // the iteration's cost (sharded: already summed), in the fixed order of
  // COST_LANES lanes strided over the landmarks, a shuffle tree in each
  // warp of lanes, then the warps in order
  if (rank == dense_lu::CLUSTER - 1) {
    for (int v = threadIdx.x; v < COST_LANES; v += dense_lu::THREADS) {
      float c = 0.f;
      if (W.cost_part == nullptr)
        for (int j = v; j < W.PL + W.LL; j += COST_LANES) c += W.lm_cost[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
      if ((v & 31) == 0) cred[v >> 5] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < COST_LANES / 32; ++w) s += cred[w];
      W.cost[0] = W.cost_part != nullptr ? W.cost_part[0] : s;
    }
  }
  dense_lu::cluster_sync();
  dense_lu::solve<SOLVE_NB>(W.Sg, n, W.piv, 6 * W.KL, dyn);
  if (rank != 0) return;
  const float* x = dyn;   // the solve leaves x there
  if (threadIdx.x < W.KL && !W.cam_free[threadIdx.x]) {
#pragma unroll
    for (int i = 0; i < 6; ++i) W.dxc[6 * threadIdx.x + i] = 0.f;
  }
  if (threadIdx.x < nblk) {
    const int b = threadIdx.x, k = cam_of[b];
    float d[6];
    float nrm = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      d[i] = x[6 * b + i];
      W.dxc[6 * k + i] = d[i];
      nrm += d[i] * d[i];
    }
    const float sc = fminf(0.5f / fmaxf(sqrtf(nrm), 1e-9f), 1.f);
#pragma unroll
    for (int i = 0; i < 6; ++i) d[i] = d[i] * sc;
    se3_update(d, W.T + 16 * k);
  }
}

// the header's solver alone on one [n, n + 1] system (x out, A overwritten)
template <int NB>
__global__ void __launch_bounds__(dense_lu::THREADS) dense_solve_kernel(float* A, int n, int cap,
                                                                        int* piv, float* x) {
  extern __shared__ float dyn[];
  dense_lu::solve<NB>(A, n, piv, cap, dyn);
  if (cg::this_cluster().block_rank() != 0) return;
  const float* xs = dyn;   // the solve leaves x there
  for (int i = threadIdx.x; i < n; i += dense_lu::THREADS) x[i] = xs[i];
}

// ---- ba_backsub ----
__global__ void backsub_kernel(Work W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W.NJ) return;
  const Bits act = W.act_bits[j];
  if (!act) return;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < W.KL; ++k) {
    if (!((act >> k) & 1ull)) continue;
    const float* a = W.A + blk(W, k, j) * 18;
    const float* d = W.dxc + 6 * k;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float s = a[l] * d[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) s = s + a[3 * i + l] * d[i];
      acc[l] += s;
    }
  }
  const float* Hi = W.Hpi + 9 * (size_t)j;
  const float* b = W.bp + 3 * (size_t)j;
  const float r0 = b[0] - acc[0], r1 = b[1] - acc[1], r2 = b[2] - acc[2];
  float dx[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) dx[l] = Hi[3 * l] * r0 + Hi[3 * l + 1] * r1 + Hi[3 * l + 2] * r2;
  const float pn = sqrtf(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
  const float sc = fminf(0.5f / fmaxf(pn, 1e-9f), 1.f);
#pragma unroll
  for (int l = 0; l < 3; ++l) W.X[3 * (size_t)j + l] += dx[l] * sc;
}

// ---- ba_edges ----
__global__ void edges_kernel(Work W, bool* __restrict__ inl_pt, bool* __restrict__ inl_ln) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long np = (long long)W.KL * W.F;
  if (i < np) {
    const int k = (int)(i / W.F);
    const int e = W.edge_mp[i] - W.col0;
    inl_pt[i] = W.edge_valid[i] && W.kf_valid[k] && e >= 0 && e < W.PL &&
                ((W.inl_bits[e] >> k) & 1ull);
    return;
  }
  const long long i2 = i - np;
  if (i2 >= (long long)W.KL * W.LF) return;
  const int k = (int)(i2 / W.LF);
  const int e = W.edge_ln[i2] - W.ln_col0;
  inl_ln[i2] = W.ln_edge_valid[i2] && e >= 0 && e < W.LL &&
               ((W.inl_bits[W.PL + e] >> k) & 1ull);
}

int grid_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int sspl_ba_grid(const void* ws, void* stream) {
  const Work& W = *(const Work*)ws;
  if (W.KL < 1 || W.KL > MAXKL) return (int)cudaErrorInvalidValue;
  const long long n = (long long)W.KL * (W.F + W.LF);
  if (n > 0)
    grid_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(W);
  return (int)cudaGetLastError();
}

extern "C" int sspl_ba_classify(const void* ws, int mode, void* stream) {
  const Work& W = *(const Work*)ws;
  const int n = W.PL + W.LL;
  if (n > 0)
    classify_kernel<<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(W, mode);
  return (int)cudaGetLastError();
}

extern "C" int sspl_ba_landmarks(const void* ws, void* stream) {
  const Work& W = *(const Work*)ws;
  const int n = W.PL + W.LL;
  if (n > 0)
    landmarks_kernel<<<grid_for(n, 64), 64, 0, (cudaStream_t)stream>>>(W);
  return (int)cudaGetLastError();
}

extern "C" int sspl_ba_reduce(const void* ws, void* stream) {
  const Work& W = *(const Work*)ws;
  const int blocks = W.KL * (W.KL + 1) / 2 + W.KL + (W.cost_part != nullptr ? 1 : 0);
  reduce_kernel<<<blocks, RED_THREADS, 0, (cudaStream_t)stream>>>(W);
  return (int)cudaGetLastError();
}

extern "C" int sspl_ba_solve(const void* ws, void* stream) {
  const Work& W = *(const Work*)ws;
  const int cap = 6 * W.KL;
  if (W.Sg == nullptr || W.piv == nullptr || !dense_lu::fits<SOLVE_NB>(cap))
    return (int)cudaErrorInvalidValue;
  return (int)dense_lu::launch(solve_kernel, dense_lu::smem_bytes<SOLVE_NB>(cap),
                               (cudaStream_t)stream, W);
}

// x = A^-1 b of A_aug [n, n + 1] (overwritten), pivot rows to piv [n];
// `cap` >= n picks the panel width as a caller of that capacity gets it
extern "C" int sspl_dense_solve(void* A, int n, int cap, void* piv, void* x, void* stream) {
  if (n < 1 || cap < n) return (int)cudaErrorInvalidValue;
  float* a = (float*)A;
  int* p = (int*)piv;
  float* xo = (float*)x;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dense_lu::panel_width(cap)) {
    case 32:
      return (int)dense_lu::launch(dense_solve_kernel<32>, dense_lu::smem_bytes<32>(cap), st, a,
                                   n, cap, p, xo);
    case 16:
      return (int)dense_lu::launch(dense_solve_kernel<16>, dense_lu::smem_bytes<16>(cap), st, a,
                                   n, cap, p, xo);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sspl_ba_backsub(const void* ws, void* stream) {
  const Work& W = *(const Work*)ws;
  if (W.NJ > 0)
    backsub_kernel<<<grid_for(W.NJ, 128), 128, 0, (cudaStream_t)stream>>>(W);
  return (int)cudaGetLastError();
}

extern "C" int sspl_ba_edges(const void* ws, void* inl_pt, void* inl_ln, void* stream) {
  const Work& W = *(const Work*)ws;
  const long long n = (long long)W.KL * (W.F + W.LF);
  if (n > 0)
    edges_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        W, (bool*)inl_pt, (bool*)inl_ln);
  return (int)cudaGetLastError();
}
