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
// Two forms run the schedule with no host round trip, chosen by shape:
//  - ba_persist, the whole call in one launch of one thread-block cluster,
//    up to 16 keyframes (local BA's window), unsharded: compact
//    landmark-major edge lists instead of the reference's planes, a half
//    warp per landmark and a lane per camera, each warp's camera-side sums
//    in its own shared memory, the dense solve between cluster barriers
//    (see `ba_persist` below);
//  - the chain, a fixed sequence of launches (4 per iteration, 85 per
//    call), for global BA's 64 keyframes and the sharded form:
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
// The same library exports the solver of dense_lu.cuh alone
// (`dense_solve`, counted apart; no path calls it) for timing and testing
// it on one system. Both forms share the per-edge arithmetic (project,
// jacobians, edge_terms, point_terms / line_terms, inv3, ahi_of,
// pair_term, backsub_terms, point_step, system_entry, rhs_entry,
// camera_step): one source for every formula.
//
// Bound on the card: operations, a few hundred per active edge per
// iteration (projection, Jacobians, the 6x6 and 6x3 blocks) plus the
// Schur products of the co-visible pairs and the (6 n_free)^3 / 3 solve,
// against ~0.5 MB of inputs. The solve's chain of dependent pivot steps
// sets the time: at the window the LU takes ~55 us of an iteration's ~85
// (PERF.md), the rest the landmark steps, mostly their pair sums; the
// card is latency-bound here, not throughput-bound. The solve spreads its
// trailing updates over the cluster and factors the next panel while
// they run (dense_lu.cuh).
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
  Bits* act_bits;           // [NJ] bit k: active edge of this phase (the chain)
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
  // the one-launch form (ba_persist): its inputs, copied in at the start,
  // its schedule, and its landmark-major work list and edge slots
  int iters1, iters2;       // iterations before and after the chi2 cut
  const float* T_in;        // [KL, 16] the poses given (T receives the result)
  const float* X_pt;        // [PL, 3] the points given (X receives them, then
  const float* X_ls;        // [LL, 3] the line starts and
  const float* X_le;        // [LL, 3] the line ends)
  const bool* kf_free;      // [KL]
  int* lm_info;             // [PL + LL, 4] the landmarks with an edge, in id
                            // order: id, first edge slot, edge bits, active bits
  int* lm_off;              // [PL + LL] a listed landmark's first edge slot, by id
  int* counts;              // [3] points listed, lines listed, slots used
  float* obs;               // [slots, 4] u, v, info, 0 or l0, l1, l2, info
  float* Ae;                // [slots, 18] A of each edge (a line's end points
                            // take a slot each)
  long long* trace;         // built with -DSSPL_BA_TRACE: clock64 sums per phase
};

// trace slots (built with -DSSPL_BA_TRACE; tools/kernel_ab.py --trace):
// rank 0's clock64 from barrier to barrier, summed over the call (the
// chain's ba_solve adds its assembly and its solve), and the one-launch
// form's warps' cycles in their landmark steps and in their pair sums
enum { TR_SETUP, TR_LANDMARKS, TR_BLOCK_SUMS, TR_ASSEMBLY, TR_SOLVE, TR_BACKSUB, TR_CLASSIFY,
       TR_EDGES, TR_WARP_STEPS, TR_WARP_PAIRS, TR_SLOTS };

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

// an input point edge i (keyframe k, landmark e of the span) that the
// schedule sees, and an input line edge i2 (landmark e of the span)
__device__ __forceinline__ bool point_edge_ok(const Work& W, long long i, int k, int e) {
  return W.edge_valid[i] && e >= 0 && e < W.PL && W.kf_valid[k];
}

__device__ __forceinline__ bool line_edge_ok(const Work& W, long long i2, int e) {
  return W.ln_edge_valid[i2] && e >= 0 && e < W.LL;
}

// ---- ba_grid ----
__global__ void grid_kernel(Work W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long np = (long long)W.KL * W.F;
  if (i < np) {
    const int k = (int)(i / W.F);
    const int e = W.edge_mp[i] - W.col0;
    if (!point_edge_ok(W, i, k, e)) return;
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
  if (!line_edge_ok(W, i2, e)) return;
  float* g = W.lgrid + ((size_t)k * W.LL + e) * 5;
#pragma unroll
  for (int q = 0; q < 3; ++q) atomicAdd(g + q, W.obs_l[3 * i2 + q]);
  atomicAdd(g + 3, 1.f / fmaxf(W.ln_sigma2[i2], 1e-12f));
  atomicAdd(g + 4, 1.f);
}

// ---- ba_classify ----
// whether a point edge (observation ou, ov, weight info) passes the chi2
// cut in front of the camera
__device__ __forceinline__ bool point_keep(const Work& W, const float* R, const float* t,
                                           const float* X, float ou, float ov, float info) {
  const Proj p = project(R, t, X, W);
  const float ru = ou - p.u, rv = ov - p.v;
  return (ru * ru + rv * rv) * info <= W.chi2_mono && p.z > 0.f;
}

// whether a line edge (endpoints Xs, Xe; observed line l0, l1, l2) passes
__device__ __forceinline__ bool line_keep(const Work& W, const float* R, const float* t,
                                          const float* Xs, const float* Xe, float l0, float l1,
                                          float l2, float info) {
  const Proj ps = project(R, t, Xs, W);
  const Proj pe = project(R, t, Xe, W);
  const float es = l0 * ps.u + l1 * ps.v + l2;
  const float ee = l0 * pe.u + l1 * pe.v + l2;
  const float cs = es * es * info, ce = ee * ee * info;
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
      float R[9], tt[3];
      load_cam(W.T, k, R, tt);
      bool keep;
      if (is_pt) {
        const float* g = W.pgrid + ((size_t)k * W.PL + t) * 4;
        keep = point_keep(W, R, tt, W.X + 3 * t, g[0], g[1], g[2]);
      } else {
        const float* g = W.lgrid + ((size_t)k * W.LL + l) * 5;
        keep = line_keep(W, R, tt, W.X + 3 * (W.PL + l), W.X + 3 * (W.PL + W.LL + l), g[0], g[1],
                         g[2], g[3]);
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
// Hpp^-1 of the upper triangle H (00, 01, 02, 11, 12, 22): damped by
// ds = 1 + lam, trace-relative floor (`_plane_inv3`), adjugate over det
__device__ __forceinline__ void inv3(const float* H, float ds, float* Hi) {
  const float tr = H[0] + H[3] + H[5];
  const float eps = 1e-3f * tr + 1e-6f;
  const float a_ = H[0] * ds + eps, b_ = H[1], c_ = H[2];
  const float e_ = H[3] * ds + eps, f_ = H[4];
  const float i_ = H[5] * ds + eps;
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
}

// A Hpp^-1 of one edge's 6x3 block
__device__ __forceinline__ void ahi_of(const float* a, const float* Hi, float* ah) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      ah[3 * i + l] = a[3 * i] * Hi[l] + a[3 * i + 1] * Hi[3 + l] + a[3 * i + 2] * Hi[6 + l];
}

// Hpp^-1 (damped, trace-relative floor; `_plane_inv3`), the column's
// A Hpp^-1 blocks, Hpi and bp = -g.
__device__ void finish_column(const Work& W, int j, Bits act, const float* H,
                              const float* g) {
  float Hi[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Hi[q] = 0.f;
  if (act) {
    inv3(H, W.ds, Hi);
    for (int k = 0; k < W.KL; ++k) {
      if (!((act >> k) & 1ull)) continue;
      ahi_of(W.A + blk(W, k, j) * 18, Hi, W.AHi + blk(W, k, j) * 18);
    }
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) W.Hpi[9 * (size_t)j + q] = Hi[q];
#pragma unroll
  for (int l = 0; l < 3; ++l) W.bp[3 * (size_t)j + l] = -g[l];
}

// one edge's (or line endpoint's) terms: its Hcc upper triangle and
// sum wJ r (hb), its Hpp terms (h, upper 00 01 02 11 12 22) and sum wJx r
// (g), and A = wJ Jx^T; both forms add them up, each in its own order
struct Edge {
  float hb[27];
  float h[6];
  float g[3];
  float a[18];
};

// the terms of pose rows J (NROW of them, weight w, residual r) and point
// rows Jx
template <int NROW>
__device__ __forceinline__ void edge_terms(float w, float (*J)[6], float (*Jx)[3], const float* r,
                                           Edge& e) {
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
      e.hb[q++] = s;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = wJ[0][i] * r[0];
    if (NROW == 2) s = s + wJ[1][i] * r[1];
    e.hb[21 + i] = s;
  }
  q = 0;
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int l2 = l; l2 < 3; ++l2) {
      float s = wJx[0][l] * Jx[0][l2];
      if (NROW == 2) s = s + wJx[1][l] * Jx[1][l2];
      e.h[q++] = s;
    }
    float s = wJx[0][l] * r[0];
    if (NROW == 2) s = s + wJx[1][l] * r[1];
    e.g[l] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float s = wJ[0][i] * Jx[0][l];
      if (NROW == 2) s = s + wJ[1][i] * Jx[1][l];
      e.a[3 * i + l] = s;
    }
}

// a point edge seen from pose (R, t) at observation (ou, ov) with weight
// info: its terms; returns its cost term min(chi2, 4 chi2_mono)
__device__ __forceinline__ float point_terms(const Work& W, const float* R, const float* t,
                                             const float* X, float ou, float ov, float info,
                                             Edge& e) {
  const Proj p = project(R, t, X, W);
  float r[2];
  r[0] = ou - p.u;
  r[1] = ov - p.v;
  const float chi2 = (r[0] * r[0] + r[1] * r[1]) * info;
  const float w = huber(chi2, W.delta_pt) * info;
  float J[2][6], Jx[2][3];
  jacobians(p, R, J[0], J[1], Jx[0], Jx[1]);
  edge_terms<2>(w, J, Jx, r, e);
  return fminf(chi2, W.chi2_mono4);
}

// a line endpoint X against the observed line (l0, l1, l2): its terms;
// returns its chi2 (a line's cost term is min(chi2_s + chi2_e, 8 chi2_line))
__device__ __forceinline__ float line_terms(const Work& W, const float* R, const float* t,
                                            const float* X, float l0, float l1, float l2,
                                            float info, Edge& e) {
  const Proj p = project(R, t, X, W);
  const float err = l0 * p.u + l1 * p.v + l2;
  const float c2 = err * err * info;
  const float w = huber(c2, W.delta_ln) * info;
  float Ju[6], Jv[6], Jxu[3], Jxv[3];
  jacobians(p, R, Ju, Jv, Jxu, Jxv);
  float J[1][6], Jx[1][3], r[1];
#pragma unroll
  for (int i = 0; i < 6; ++i) J[0][i] = l0 * Ju[i] + l1 * Jv[i];
#pragma unroll
  for (int m = 0; m < 3; ++m) Jx[0][m] = l0 * Jxu[m] + l1 * Jxv[m];
  r[0] = -err;
  edge_terms<1>(w, J, Jx, r, e);
  return c2;
}

// the old form's plane writes of one edge, and its landmark sums
__device__ __forceinline__ void edge_blocks(const Work& W, int k, int j, const Edge& e, float* H,
                                            float* g) {
  float* hb = W.HB + blk(W, k, j) * 27;
  float* a = W.A + blk(W, k, j) * 18;
#pragma unroll
  for (int q = 0; q < 27; ++q) hb[q] = e.hb[q];
#pragma unroll
  for (int q = 0; q < 6; ++q) H[q] += e.h[q];
#pragma unroll
  for (int l = 0; l < 3; ++l) g[l] += e.g[l];
#pragma unroll
  for (int q = 0; q < 18; ++q) a[q] = e.a[q];
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
      Edge e;
      cost += point_terms(W, R, tt, W.X + 3 * j, gr[0], gr[1], gr[2], e);
      edge_blocks(W, k, j, e, H, g);
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
    float c2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = e ? je : js;
      Edge ed;
      c2[e] = line_terms(W, R, tt, W.X + 3 * j, gr[0], gr[1], gr[2], gr[3], ed);
      edge_blocks(W, k, j, ed, H[e], g[e]);
    }
    cost += fminf(c2[0] + c2[1], W.chi2_line8);
  }
  W.lm_cost[t] = cost;
  finish_column(W, js, act, H[0], g[0]);
  finish_column(W, je, act, H[1], g[1]);
}

// ---- ba_reduce ----
// one entry of a camera pair's A Hpp^-1 A^T (row i of k1's A Hpp^-1, row
// i2 of k2's A), or of A Hpp^-1 bp
__device__ __forceinline__ float pair_term(const float* h, const float* a) {
  return h[0] * a[0] + h[1] * a[1] + h[2] * a[2];
}

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
        for (int i2 = 0; i2 < 6; ++i2) acc[6 * i + i2] += pair_term(hv + 3 * i, av + 3 * i2);
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
    for (int i = 0; i < 6; ++i) acc[27 + i] += pair_term(ah + 3 * i, b);
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

// an entry of S + 1e-6 I: -sum A Hpp^-1 A^T (s), plus Hcc (1 + lam on the
// diagonal) in a camera's own block
__device__ __forceinline__ float system_entry(float s, float hcc, bool same_cam, bool diag_of_cam,
                                              bool diag, float lam) {
  float v = -s;
  if (same_cam) v = v + hcc * (diag_of_cam ? 1.f + lam : 1.f);
  if (diag) v = v + 1e-6f;
  return v;
}

// the right side: bc - A Hpp^-1 bp (hb: -bc, ahb: A Hpp^-1 bp)
__device__ __forceinline__ float rhs_entry(float hb, float ahb) { return -hb - ahb; }

// a free camera's step: x clipped to norm 0.5, T <- exp(x) T
__device__ __forceinline__ void camera_step(const float* x, float* T) {
  float d[6];
  float nrm = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    d[i] = x[i];
    nrm += d[i] * d[i];
  }
  const float sc = fminf(0.5f / fmaxf(sqrtf(nrm), 1e-9f), 1.f);
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = d[i] * sc;
  se3_update(d, T);
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
#ifdef SSPL_BA_TRACE
  const long long t_start = clock64();
#endif
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
        v = rhs_entry(W.Hk[33 * kr + 21 + ir], W.Hk[33 * kr + 27 + ir]);
      } else {
        const int kc = cam_of[c / 6], ic = c % 6;
        const float* s = W.Sred + 36 * (size_t)pair_index(min(kr, kc), max(kr, kc), W.KL);
        v = system_entry(kr <= kc ? s[6 * ir + ic] : s[6 * ic + ir],
                         kr == kc ? W.Hk[33 * kr + sym6(ir, ic)] : 0.f, kr == kc, ir == ic,
                         r == c, W.lam);
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
#ifdef SSPL_BA_TRACE
  long long t_mark = 0;
  if (rank == 0 && threadIdx.x == 0) {
    t_mark = clock64();
    W.trace[TR_ASSEMBLY] += t_mark - t_start;
  }
#endif
  dense_lu::solve<SOLVE_NB>(W.Sg, n, W.piv, 6 * W.KL, dyn);
#ifdef SSPL_BA_TRACE
  if (rank == 0 && threadIdx.x == 0) W.trace[TR_SOLVE] += clock64() - t_mark;
#endif
  if (rank != 0) return;
  const float* x = dyn;   // the solve leaves x there
  if (threadIdx.x < W.KL && !W.cam_free[threadIdx.x]) {
#pragma unroll
    for (int i = 0; i < 6; ++i) W.dxc[6 * threadIdx.x + i] = 0.f;
  }
  if (threadIdx.x < nblk) {
    const int b = threadIdx.x, k = cam_of[b];
#pragma unroll
    for (int i = 0; i < 6; ++i) W.dxc[6 * k + i] = x[6 * b + i];
    camera_step(x + 6 * b, W.T + 16 * k);
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
// one edge's A^T dx_c (s[l] = sum_i A[i][l] dx_c[i], in i order)
__device__ __forceinline__ void backsub_terms(const float* a, const float* d, float* s) {
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    float v = a[l] * d[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) v = v + a[3 * i + l] * d[i];
    s[l] = v;
  }
}

// X += clip(Hpp^-1 (bp - sum A^T dx_c), 0.5)
__device__ __forceinline__ void point_step(const float* Hi, const float* b, const float* acc,
                                           float* X) {
  const float r0 = b[0] - acc[0], r1 = b[1] - acc[1], r2 = b[2] - acc[2];
  float dx[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) dx[l] = Hi[3 * l] * r0 + Hi[3 * l + 1] * r1 + Hi[3 * l + 2] * r2;
  const float pn = sqrtf(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]);
  const float sc = fminf(0.5f / fmaxf(pn, 1e-9f), 1.f);
#pragma unroll
  for (int l = 0; l < 3; ++l) X[l] += dx[l] * sc;
}

__global__ void backsub_kernel(Work W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= W.NJ) return;
  const Bits act = W.act_bits[j];
  if (!act) return;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < W.KL; ++k) {
    if (!((act >> k) & 1ull)) continue;
    float s[3];
    backsub_terms(W.A + blk(W, k, j) * 18, W.dxc + 6 * k, s);
#pragma unroll
    for (int l = 0; l < 3; ++l) acc[l] += s[l];
  }
  point_step(W.Hpi + 9 * (size_t)j, W.bp + 3 * (size_t)j, acc, W.X + 3 * (size_t)j);
}

// ---- ba_edges ----
__global__ void edges_kernel(Work W, bool* __restrict__ inl_pt, bool* __restrict__ inl_ln) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long np = (long long)W.KL * W.F;
  if (i < np) {
    const int k = (int)(i / W.F);
    const int e = W.edge_mp[i] - W.col0;
    inl_pt[i] = point_edge_ok(W, i, k, e) && ((W.inl_bits[e] >> k) & 1ull);
    return;
  }
  const long long i2 = i - np;
  if (i2 >= (long long)W.KL * W.LF) return;
  const int k = (int)(i2 / W.LF);
  const int e = W.edge_ln[i2] - W.ln_col0;
  inl_ln[i2] = line_edge_ok(W, i2, e) && ((W.inl_bits[W.PL + e] >> k) & 1ull);
}

// ---- ba_persist: the whole call in one launch (KL <= 16, unsharded) ----
// One cluster of dense_lu::CLUSTER blocks of dense_lu::THREADS threads
// (the dense solve's own launch shape) runs the schedule from the edge
// lists to the inlier masks, its phases separated by cluster barriers.
// Its 64 warps take the listed landmarks round robin in steps, a step a
// landmark per half warp (two points, or a line's two end points), a lane
// per camera; a step's landmark, first edge slot and edge bits come in one
// 16-byte load (`lm_info`), the next step's while this one computes. Each
// warp adds its landmarks' camera-side terms into its own partial sums in
// shared memory (the free camera pairs' A Hpp^-1 A^T, the free cameras'
// Hcc, sum wJ r and A Hpp^-1 bp), in its landmarks' order; the blocks then
// sum their warps' partials in warp order and the system's entries are
// summed over the blocks in rank order (distributed shared memory): no
// atomics, so every run gives the same sums. The dense solve then reuses
// the partials' shared memory; every block keeps the step x and applies
// it to its own copy of the poses, and each landmark's back substitution
// runs at the start of its next step (the same warp owns it), so an
// iteration has two cluster barriers besides the solve's own; a phase's
// last iteration back-substitutes on its own before the chi2 cut. The
// setup: each landmark's edge bits by integer atomicOr (order-free), the
// list by a block scan in rank 0, the observations into their slots by
// atomicAdd onto zeros (exact while a keyframe row binds a landmark at
// most once, as for the chain's grids).
constexpr int KL1 = 16;                           // cameras, at most: a half warp's lanes
constexpr int NPAIR1 = KL1 * (KL1 + 1) / 2;
constexpr int PART = NPAIR1 * 36 + KL1 * 33;      // a warp's partial sums: pairs, then Hk
constexpr int PWARPS = dense_lu::WARPS;
constexpr int CWARPS = dense_lu::CLUSTER * PWARPS;
constexpr size_t PERSIST_DYN = (size_t)PWARPS * PART * sizeof(float);
constexpr unsigned FULL = 0xffffffffu;

struct Stage {   // a warp's landmark: its free edges' A Hpp^-1 and A
  float ahi[KL1][18];
  float a[KL1][18];
  int fcam[KL1];   // its free cameras in order
};

struct Shared1 {
  float T[KL1 * 16];              // the poses (every block keeps the same copy)
  float xs[6 * KL1];              // the last solve's step, free cameras in order
  Stage stg[PWARPS];
  int cam_of[KL1];                // the free cameras in order
  int pairs[NPAIR1];              // the free pairs' partial rows (pair_index, KL1)
  unsigned char tri_a[NPAIR1], tri_b[NPAIR1];   // pair p = b (b + 1) / 2 + a, a <= b
  float wcost[PWARPS];
  float bcost;
  int nblk, npf;
  unsigned free_mask;
  int scan[3][PWARPS];
};

__device__ __forceinline__ float half_sum(float v) {   // over a half warp, the same in each lane
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// a half warp's column in step s: points 2s and 2s + 1 of the list, then
// one line a step (its start, then its end); `info` is the list entry
// (landmark id, first edge slot, edge bits, active bits)
struct Col {
  int4 info;
  int col;      // X / Hpi / bp column
  bool on, line, end;
};

__device__ __forceinline__ Col step_col(const Work& W, int n_pt, int s, int h) {
  const int np = (n_pt + 1) / 2;
  Col c;
  c.line = s >= np;
  const int item = c.line ? n_pt + s - np : 2 * s + h;
  c.on = c.line || item < n_pt;
  c.info = c.on ? __ldcg((const int4*)W.lm_info + item) : make_int4(0, 0, 0, 0);
  c.end = c.line && h == 1;
  c.col = c.line ? (c.end ? W.LL : 0) + c.info.x : c.info.x;   // a line's id is PL + l
  return c;
}

// the edge slot of camera k of a listed landmark (first slot off, edge bits eb)
__device__ __forceinline__ int edge_slot(int off, unsigned eb, int k) {
  return off + __popc(eb & ((1u << k) - 1u));
}

__device__ __forceinline__ void load3(const float* p, float* v) {
  v[0] = __ldcg(p);
  v[1] = __ldcg(p + 1);
  v[2] = __ldcg(p + 2);
}

// the back substitution of the half's landmark from the last solve (its
// blocks from its last step): the free lanes' A^T dx_c summed over the
// half, X += clip(Hpp^-1 (bp - that), 0.5) in the half's first lane; the
// new X in X of every lane of the half
__device__ __forceinline__ void backsub_col(const Work& W, const Shared1& sh, const Col& c,
                                            float* X) {
  const int lane = threadIdx.x & 31, h = lane >> 4, k = lane & 15;
  const unsigned act = (unsigned)c.info.w, eb = (unsigned)c.info.z;
  float sv[3] = {0.f, 0.f, 0.f};
  if (((act & sh.free_mask) >> k) & 1u) {
    const int slot_a = edge_slot(c.info.y, eb, k) + (c.end ? __popc(eb) : 0);
    float a[18];
    const float2* a2 = (const float2*)(W.Ae + 18 * (size_t)slot_a);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const float2 v = __ldcg(a2 + q);
      a[2 * q] = v.x;
      a[2 * q + 1] = v.y;
    }
    backsub_terms(a, sh.xs + 6 * __popc(sh.free_mask & ((1u << k) - 1u)), sv);
  }
  float acc[3];
#pragma unroll
  for (int l = 0; l < 3; ++l) acc[l] = half_sum(sv[l]);
  if (act && k == 0) {
    float Hi[9], b[3];
#pragma unroll
    for (int q = 0; q < 9; ++q) Hi[q] = __ldcg(W.Hpi + 9 * (size_t)c.col + q);
    load3(W.bp + 3 * (size_t)c.col, b);
    point_step(Hi, b, acc, X);
#pragma unroll
    for (int l = 0; l < 3; ++l) __stcg(W.X + 3 * (size_t)c.col + l, X[l]);
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) X[l] = __shfl_sync(FULL, X[l], 16 * h);
}

// one step of the landmark phase: with `back`, the last solve's back
// substitution first; each live lane's edge terms; per half, Hpp and g
// summed over its lanes, Hpp^-1, A Hpp^-1 and A Hpp^-1 bp; Hpi, bp and the
// edges' A kept for the back substitution; the camera-side terms added
// into the warp's partial sums, the first half's, then the second's
__device__ void landmark_step(const Work& W, Shared1& sh, float* part, Stage& st, const Col& c,
                              bool back, float& cacc, long long& pair_cycles) {
  const int lane = threadIdx.x & 31, h = lane >> 4, k = lane & 15;
  const unsigned act = (unsigned)c.info.w, eb = (unsigned)c.info.z;
  const bool live = (act >> k) & 1u;
  const int slot = edge_slot(c.info.y, eb, k);
  const int slot_a = slot + (c.end ? __popc(eb) : 0);
  float X[3] = {0.f, 0.f, 0.f};
  if (c.on) load3(W.X + 3 * (size_t)c.col, X);
  const float4 o = live ? __ldcg((const float4*)W.obs + slot) : make_float4(0.f, 0.f, 0.f, 0.f);
  if (back) backsub_col(W, sh, c, X);
  Edge e;
#pragma unroll
  for (int q = 0; q < 6; ++q) e.h[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 3; ++q) e.g[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 18; ++q) e.a[q] = 0.f;
  float cost = 0.f, c2 = 0.f;
  if (live) {
    float R[9], tt[3];
    load_cam(sh.T, k, R, tt);
    if (c.line)
      c2 = line_terms(W, R, tt, X, o.x, o.y, o.z, o.w, e);
    else
      cost = point_terms(W, R, tt, X, o.x, o.y, o.z, e);
  }
  if (c.line) {   // the line's cost term, from both end points of a camera
    const float c2o = __shfl_xor_sync(FULL, c2, 16);
    cost = h == 0 && live ? fminf(c2 + c2o, W.chi2_line8) : 0.f;
  }
  cacc += warp_sum(cost);
  float H[6], g[3], Hi[9], ah[18], bpv[3], ahb[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) H[q] = half_sum(e.h[q]);
#pragma unroll
  for (int q = 0; q < 3; ++q) g[q] = half_sum(e.g[q]);
  inv3(H, W.ds, Hi);
  ahi_of(e.a, Hi, ah);
#pragma unroll
  for (int l = 0; l < 3; ++l) bpv[l] = -g[l];
#pragma unroll
  for (int i = 0; i < 6; ++i) ahb[i] = pair_term(ah + 3 * i, bpv);
  if (live) {
    float2* a2 = (float2*)(W.Ae + 18 * (size_t)slot_a);
#pragma unroll
    for (int q = 0; q < 9; ++q) a2[q] = make_float2(e.a[2 * q], e.a[2 * q + 1]);
  }
  if (act && k == 0) {
#pragma unroll
    for (int q = 0; q < 9; ++q) W.Hpi[9 * (size_t)c.col + q] = Hi[q];
#pragma unroll
    for (int l = 0; l < 3; ++l) W.bp[3 * (size_t)c.col + l] = bpv[l];
  }
#ifdef SSPL_BA_TRACE
  const long long t0 = clock64();
#endif
  const bool fr = live && ((sh.free_mask >> k) & 1u);
  float* hk = part + NPAIR1 * 36 + 33 * k;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (h == hh && fr) {
#pragma unroll
      for (int q = 0; q < 27; ++q) hk[q] += e.hb[q];
#pragma unroll
      for (int i = 0; i < 6; ++i) hk[27 + i] += ahb[i];
    }
    __syncwarp();
  }
#pragma unroll 1
  for (int hh = 0; hh < 2; ++hh) {
    const unsigned fb = __shfl_sync(FULL, act, 16 * hh) & sh.free_mask;
    if (fb == 0u) continue;
    if (h == hh && fr) {
#pragma unroll
      for (int q = 0; q < 18; ++q) {
        st.ahi[k][q] = ah[q];
        st.a[k][q] = e.a[q];
      }
      st.fcam[__popc(fb & ((1u << k) - 1u))] = k;
    }
    __syncwarp();
    const int m = __popc(fb), items = m * (m + 1) / 2 * 6;
    for (int it = lane; it < items; it += 32) {
      const int p = it / 6, i = it - 6 * p;
      const int k1 = st.fcam[sh.tri_a[p]], k2 = st.fcam[sh.tri_b[p]];
      float* out = part + 36 * pair_index(k1, k2, KL1) + 6 * i;
      const float* hv = st.ahi[k1] + 3 * i;
#pragma unroll
      for (int i2 = 0; i2 < 6; ++i2) out[i2] += pair_term(hv, st.a[k2] + 3 * i2);
    }
    __syncwarp();
  }
#ifdef SSPL_BA_TRACE
  pair_cycles += clock64() - t0;
#endif
}

// the chi2 cut of listed landmark `item` (a half warp each, a lane per
// camera): mode 1 its active edges (kept only with >= 2), mode 2 its
// final inliers
__device__ void classify_step(const Work& W, const Shared1& sh, int item, int n_list, int mode) {
  const int lane = threadIdx.x & 31, h = lane >> 4, k = lane & 15;
  const bool on = item < n_list;
  const int4 info = on ? __ldcg((const int4*)W.lm_info + item) : make_int4(0, 0, 0, 0);
  const int t = info.x;
  const unsigned eb = (unsigned)info.z;
  bool keep = false;
  if ((eb >> k) & 1u) {
    float R[9], tt[3];
    load_cam(sh.T, k, R, tt);
    const float4 o = __ldcg((const float4*)W.obs + edge_slot(info.y, eb, k));
    if (t < W.PL) {
      float X[3];
      load3(W.X + 3 * (size_t)t, X);
      keep = point_keep(W, R, tt, X, o.x, o.y, o.z);
    } else {
      const int l = t - W.PL;
      float Xs[3], Xe[3];
      load3(W.X + 3 * (size_t)(W.PL + l), Xs);
      load3(W.X + 3 * (size_t)(W.PL + W.LL + l), Xe);
      keep = line_keep(W, R, tt, Xs, Xe, o.x, o.y, o.z, o.w);
    }
  }
  const unsigned bits = (__ballot_sync(FULL, keep) >> (16 * h)) & 0xffffu;
  if (on && k == 0) {
    if (mode == 1)
      W.lm_info[4 * item + 3] = __popc(bits) >= 2 ? (int)bits : 0;
    else
      W.inl_bits[t] = bits;
  }
}

// rank 0: the list of landmarks with an edge (points, then lines, each in
// id order), each entry (id, first edge slot (a point's edges take one
// each, a line's two), edge bits, first phase's active bits (>= 2
// edges)); each landmark's first slot by id; the counts; the used
// observation slots zeroed
__device__ void scan_landmarks(const Work& W, Shared1& sh) {
  const int N = W.PL + W.LL, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (N + dense_lu::THREADS - 1) / dense_lu::THREADS;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  int v[3] = {0, 0, 0};   // listed, slots, listed points
  for (int t = lo; t < hi; ++t) {
    const unsigned long long b = __ldcg(W.edge_bits + t);
    if (!b) continue;
    ++v[0];
    v[1] += __popcll(b) * (t < W.PL ? 1 : 2);
    v[2] += t < W.PL;
  }
  int incl[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int x = v[q];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    incl[q] = x;
    if (lane == 31) sh.scan[q][warp] = x;
  }
  __syncthreads();
  int base[3], total[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    base[q] = incl[q] - v[q];
    total[q] = 0;
    for (int w = 0; w < PWARPS; ++w) {
      if (w < warp) base[q] += sh.scan[q][w];
      total[q] += sh.scan[q][w];
    }
  }
  int pos = base[0], off = base[1];
  for (int t = lo; t < hi; ++t) {
    const unsigned b = (unsigned)__ldcg(W.edge_bits + t);
    if (!b) continue;
    ((int4*)W.lm_info)[pos++] = make_int4(t, off, (int)b, __popc(b) >= 2 ? (int)b : 0);
    W.lm_off[t] = off;
    off += __popc(b) * (t < W.PL ? 1 : 2);
  }
  if (tid == 0) {
    W.counts[0] = total[2];
    W.counts[1] = total[0] - total[2];
    W.counts[2] = total[1];
  }
  for (int i = tid; i < 4 * total[1]; i += dense_lu::THREADS) W.obs[i] = 0.f;
}

// the reduced camera system into W.Sg, each entry summed over the blocks'
// partials in rank order
__device__ void assemble(const Work& W, const Shared1& sh, float* dyn, int gtid) {
  cg::cluster_group cl = cg::this_cluster();
  const float* parts[dense_lu::CLUSTER];
#pragma unroll
  for (int b = 0; b < dense_lu::CLUSTER; ++b) parts[b] = cl.map_shared_rank(dyn, b);
  const auto sum = [&](int off) {
    float v = parts[0][off];
#pragma unroll
    for (int b = 1; b < dense_lu::CLUSTER; ++b) v += parts[b][off];
    return v;
  };
  const int n = 6 * sh.nblk, ld = n + 1;
  for (int idx = gtid; idx < n * ld; idx += dense_lu::CLUSTER * dense_lu::THREADS) {
    const int r = idx / ld, c = idx - r * ld;
    const int kr = sh.cam_of[r / 6], ir = r % 6, hk = NPAIR1 * 36 + 33 * kr;
    float v;
    if (c == n) {
      v = rhs_entry(sum(hk + 21 + ir), sum(hk + 27 + ir));
    } else {
      const int kc = sh.cam_of[c / 6], ic = c % 6;
      const int p = 36 * pair_index(min(kr, kc), max(kr, kc), KL1);
      v = system_entry(sum(p + (kr <= kc ? 6 * ir + ic : 6 * ic + ir)),
                       kr == kc ? sum(hk + sym6(ir, ic)) : 0.f, kr == kc, ir == ic, r == c,
                       W.lam);
    }
    __stcg(W.Sg + (size_t)r * ld + c, v);
  }
}

#ifdef SSPL_BA_TRACE
#define BA_MARK(slot)                         \
  do {                                        \
    if (rank == 0 && tid == 0) {              \
      const long long now = clock64();        \
      W.trace[slot] += now - t_mark;          \
      t_mark = now;                           \
    }                                         \
  } while (0)
#else
#define BA_MARK(slot) \
  do {                \
  } while (0)
#endif

__global__ void __launch_bounds__(dense_lu::THREADS, 1) persist_kernel(Work W,
                                                                      bool* __restrict__ inl_pt,
                                                                      bool* __restrict__ inl_ln) {
  extern __shared__ __align__(16) float dyn[];   // the warps' partial sums; the solve's
  __shared__ Shared1 sh;
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, h = lane >> 4;
  const int GT = dense_lu::CLUSTER * dense_lu::THREADS, gtid = rank * dense_lu::THREADS + tid;
  const int gw = rank * PWARPS + warp;
  const int KL = W.KL, PL = W.PL, LL = W.LL;
#ifdef SSPL_BA_TRACE
  long long t_mark = clock64();
  long long step_cycles = 0;
#endif
  long long pair_cycles = 0;
  // every block: the poses, the free cameras, the pair tables
  if (tid < KL * 16) sh.T[tid] = W.T_in[tid];
  if (tid == 0) {
    int m = 0;
    unsigned fm = 0u;
    for (int k = 0; k < KL; ++k)
      if (W.kf_free[k] && W.kf_valid[k]) {
        sh.cam_of[m++] = k;
        fm |= 1u << k;
      }
    sh.nblk = m;
    sh.free_mask = fm;
    int p = 0;
    for (int a = 0; a < m; ++a)
      for (int b = a; b < m; ++b) sh.pairs[p++] = pair_index(sh.cam_of[a], sh.cam_of[b], KL1);
    sh.npf = p;
  }
  if (tid < NPAIR1) {
    int b = 0;
    while ((b + 1) * (b + 2) / 2 <= tid) ++b;
    sh.tri_b[tid] = (unsigned char)b;
    sh.tri_a[tid] = (unsigned char)(tid - b * (b + 1) / 2);
  }
  // the landmark bits zeroed, the landmarks copied in
  for (int t = gtid; t < PL + LL; t += GT) {
    W.edge_bits[t] = 0ull;
    W.inl_bits[t] = 0ull;
  }
  for (int i = gtid; i < 3 * (PL + 2 * LL); i += GT)
    W.X[i] = i < 3 * PL ? W.X_pt[i] : i < 3 * (PL + LL) ? W.X_ls[i - 3 * PL]
                                                        : W.X_le[i - 3 * (PL + LL)];
  dense_lu::cluster_sync();
  // each edge's bit (a valid landmark's)
  for (long long i = gtid; i < (long long)KL * W.F; i += GT) {
    const int k = (int)(i / W.F), e = W.edge_mp[i];
    if (point_edge_ok(W, i, k, e) && W.mp_valid[e]) atomicOr(W.edge_bits + e, 1ull << k);
  }
  for (long long i2 = gtid; i2 < (long long)KL * W.LF; i2 += GT) {
    const int k = (int)(i2 / W.LF), e = W.edge_ln[i2];
    if (line_edge_ok(W, i2, e) && W.ln_valid[e]) atomicOr(W.edge_bits + PL + e, 1ull << k);
  }
  dense_lu::cluster_sync();
  if (rank == 0) scan_landmarks(W, sh);
  dense_lu::cluster_sync();
  // the observations into the edge slots (summed, as the dense grid sums
  // a keyframe row that binds a landmark twice)
  for (long long i = gtid; i < (long long)KL * W.F; i += GT) {
    const int k = (int)(i / W.F), e = W.edge_mp[i];
    if (!(point_edge_ok(W, i, k, e) && W.mp_valid[e])) continue;
    float* o = W.obs + 4 * (size_t)edge_slot(__ldcg(W.lm_off + e),
                                             (unsigned)__ldcg(W.edge_bits + e), k);
    atomicAdd(o, W.obs_uv[2 * i]);
    atomicAdd(o + 1, W.obs_uv[2 * i + 1]);
    atomicAdd(o + 2, 1.f / fmaxf(W.obs_sigma2[i], 1e-12f));
  }
  for (long long i2 = gtid; i2 < (long long)KL * W.LF; i2 += GT) {
    const int k = (int)(i2 / W.LF), e = W.edge_ln[i2];
    if (!(line_edge_ok(W, i2, e) && W.ln_valid[e])) continue;
    float* o = W.obs + 4 * (size_t)edge_slot(__ldcg(W.lm_off + PL + e),
                                             (unsigned)__ldcg(W.edge_bits + PL + e), k);
#pragma unroll
    for (int q = 0; q < 3; ++q) atomicAdd(o + q, W.obs_l[3 * i2 + q]);
    atomicAdd(o + 3, 1.f / fmaxf(W.ln_sigma2[i2], 1e-12f));
  }
  dense_lu::cluster_sync();
  BA_MARK(TR_SETUP);
  const int n_pt = __ldcg(W.counts), n_list = n_pt + __ldcg(W.counts + 1);
  const int n_steps = (n_pt + 1) / 2 + n_list - n_pt;
  float* part = dyn + warp * PART;
  Stage& st = sh.stg[warp];
  for (int phase = 0; phase < 2; ++phase) {
    if (phase) {
      for (int s = gw; 2 * s < n_list; s += CWARPS) classify_step(W, sh, 2 * s + h, n_list, 1);
      dense_lu::cluster_sync();
      BA_MARK(TR_CLASSIFY);
    }
    const int iters = phase ? W.iters2 : W.iters1;
    for (int it = 0; it < iters; ++it) {
      float4* p4 = (float4*)part;
      for (int q = lane; q < PART / 4; q += 32) p4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      float cacc = 0.f;
#ifdef SSPL_BA_TRACE
      const long long t0 = clock64();
#endif
      Col c;
      if (gw < n_steps) c = step_col(W, n_pt, gw, h);
      for (int s = gw; s < n_steps; s += CWARPS) {
        const Col next = s + CWARPS < n_steps ? step_col(W, n_pt, s + CWARPS, h) : c;
        landmark_step(W, sh, part, st, c, it > 0, cacc, pair_cycles);
        c = next;
      }
#ifdef SSPL_BA_TRACE
      step_cycles += clock64() - t0;
#endif
      if (lane == 0) sh.wcost[warp] = cacc;
      __syncthreads();
      BA_MARK(TR_LANDMARKS);
      // the block's sums over its warps, in warp order, into warp 0's partial
      const int npe = sh.npf * 36, nent = npe + sh.nblk * 33;
      for (int q = tid; q < nent; q += dense_lu::THREADS) {
        const int off = q < npe ? 36 * sh.pairs[q / 36] + q % 36
                                : NPAIR1 * 36 + 33 * sh.cam_of[(q - npe) / 33] + (q - npe) % 33;
        float v = dyn[off];
#pragma unroll
        for (int w = 1; w < PWARPS; ++w) v += dyn[w * PART + off];
        dyn[off] = v;
      }
      if (tid == 0) {
        float cw = sh.wcost[0];
        for (int w = 1; w < PWARPS; ++w) cw += sh.wcost[w];
        sh.bcost = cw;
      }
      dense_lu::cluster_sync();
      BA_MARK(TR_BLOCK_SUMS);
      assemble(W, sh, dyn, gtid);
      if (rank == 0 && tid == 0) {
        cg::cluster_group cl = cg::this_cluster();
        float cw = *cl.map_shared_rank(&sh.bcost, 0);
        for (int b = 1; b < dense_lu::CLUSTER; ++b) cw += *cl.map_shared_rank(&sh.bcost, b);
        W.cost[0] = cw;
      }
      dense_lu::cluster_sync();
      BA_MARK(TR_ASSEMBLY);
      const int n = 6 * sh.nblk;
      dense_lu::solve<SOLVE_NB>(W.Sg, n, W.piv, 6 * KL, dyn);
      // x in dyn[0, n) of every block: kept, the poses stepped
      for (int i = tid; i < n; i += dense_lu::THREADS) sh.xs[i] = dyn[i];
      __syncthreads();
      if (tid < sh.nblk) camera_step(sh.xs + 6 * tid, sh.T + 16 * sh.cam_of[tid]);
      __syncthreads();
      BA_MARK(TR_SOLVE);
      if (it == iters - 1) {   // the phase's last back substitution, before the cut
        for (int s = gw; s < n_steps; s += CWARPS) {
          float X[3] = {0.f, 0.f, 0.f};
          const Col cb = step_col(W, n_pt, s, h);
          if (cb.on) load3(W.X + 3 * (size_t)cb.col, X);
          backsub_col(W, sh, cb, X);
        }
        dense_lu::cluster_sync();
        BA_MARK(TR_BACKSUB);
      }
    }
  }
  for (int s = gw; 2 * s < n_list; s += CWARPS) classify_step(W, sh, 2 * s + h, n_list, 2);
  dense_lu::cluster_sync();
  BA_MARK(TR_CLASSIFY);
  for (long long i = gtid; i < (long long)KL * W.F; i += GT) {
    const int k = (int)(i / W.F), e = W.edge_mp[i];
    inl_pt[i] = point_edge_ok(W, i, k, e) && ((__ldcg(W.inl_bits + e) >> k) & 1ull);
  }
  for (long long i2 = gtid; i2 < (long long)KL * W.LF; i2 += GT) {
    const int k = (int)(i2 / W.LF), e = W.edge_ln[i2];
    inl_ln[i2] = line_edge_ok(W, i2, e) && ((__ldcg(W.inl_bits + PL + e) >> k) & 1ull);
  }
  if (rank == 0 && tid < KL * 16) W.T[tid] = sh.T[tid];
  BA_MARK(TR_EDGES);
#ifdef SSPL_BA_TRACE
  if (lane == 0) {
    atomicAdd((unsigned long long*)W.trace + TR_WARP_STEPS, (unsigned long long)step_cycles);
    atomicAdd((unsigned long long*)W.trace + TR_WARP_PAIRS, (unsigned long long)pair_cycles);
  }
#else
  (void)pair_cycles;
#endif
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

// the whole call (KL <= 16, unsharded) in one launch of one cluster
extern "C" int sspl_ba_persist(const void* ws, void* inl_pt, void* inl_ln, void* stream) {
  const Work& W = *(const Work*)ws;
  if (W.KL < 1 || W.KL > KL1 || W.col0 != 0 || W.ln_col0 != 0 || W.Sg == nullptr ||
      W.piv == nullptr || !dense_lu::fits<SOLVE_NB>(6 * W.KL))
    return (int)cudaErrorInvalidValue;
  const size_t smem = PERSIST_DYN > dense_lu::smem_bytes<SOLVE_NB>(6 * W.KL)
                          ? PERSIST_DYN : dense_lu::smem_bytes<SOLVE_NB>(6 * W.KL);
  return (int)dense_lu::launch(persist_kernel, smem, (cudaStream_t)stream, W, (bool*)inl_pt,
                               (bool*)inl_ln);
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
