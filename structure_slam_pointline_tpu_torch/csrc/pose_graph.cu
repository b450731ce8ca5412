// Kernel 18: the essential-graph Sim(3) optimization of loop correction.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/
// pose_graph.py `optimize_pose_graph` (:50), the reference's
// Optimizer::OptimizeEssentialGraph, called by models/loop_closing.py
// `correct` (:521-532). Vertices are per-keyframe Sim(3) poses, edge (i, j)
// has the residual r = sim3_log(S_ji_meas S_i S_j^-1), its two 7x7
// Jacobians come from jax.jacfwd, the normal equations are scattered into a
// dense [7K, 7K] system, solved by jnp.linalg.solve, and an LM step is
// accepted when the residual cost drops (lambda x0.5, else x5, clipped to
// [1e-12, 1e6]); 25 iterations at the loop closer's call.
//
// Here the iterations run with no host round trip, five launches each:
//   pg_jacobians one thread per (edge, tangent lane), 14 lanes per edge: the
//                residual through csrc/sim3.cuh's exp, product, inverse and
//                log on forward-mode dual numbers, one lane seeded per
//                thread, so the thread writes one column of [Ji | Jj] (lane
//                0 also the residual). This is what jacfwd computes, branch
//                for branch on the primal values.
//   pg_assemble  one block per FREE vertex v: its seven rows of H and b over
//                the free vertices only (a fixed or invalid vertex's block is
//                (1 + lambda) I with a zero right side in the reference, so
//                its step is exactly zero; the free block alone gives the
//                same step). Each of 49 threads owns one entry of a 7x7
//                block and walks the edge list in order: no atomics, the
//                same sums on every run. The damping lambda I is added last.
//   pg_solve     one thread-block cluster (dense_lu.cuh): blocked LU with
//                partial pivoting (first row on ties) of the [7 n_free,
//                7 n_free + 1] augmented system in global memory (L2-
//                resident: 0.65 MB at 57 keyframes, 12.8 MB at the
//                256-keyframe capacity) and back substitution, then rank 0
//                forms S_new = sim3_exp(dx) S for every vertex (dx = 0 off
//                the free set, so S_new = S there exactly). The cluster is
//                sized for the capacity; n_free is read on the device.
//   pg_cost      one thread per edge: w |r|^2 at S_new and at S.
//   pg_decide    one block: both sums in a fixed order, accept / reject,
//                lambda update.
// n_free lives on the device, so the wrapper never synchronizes.
//
// Bound on the card: operations. The solve is 2 (7 n_free)^3 / 3 flops
// (2 x 10^7 at 51 free keyframes, 0.3 us at 67 TFLOP/s); the edge passes
// are ~10^4 operations per edge and lane. What sets the time is the
// solve's chain of dependent pivot steps, which dense_lu.cuh keeps in
// shared memory while the cluster updates the trailing matrix.
//
// Built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_lu.cuh"
#include "sim3.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int LANES = 14;
constexpr int DECIDE_THREADS = 256;

struct PG {
  int K, E;
  const bool* free;    // [K] valid & not fixed
  const int* pos;      // [K] block row of a free vertex
  const int* nfree;    // [1]
  const int* ei;       // [E]
  const int* ej;       // [E]
  const float* Sm;     // [E, 16] measured S_ji
  const bool* evalid;  // [E]
  const float* ew;     // [E] information weight
  float* S;            // [K, 16] current vertices
  float* Snew;         // [K, 16]
  float* r;            // [E, 7]
  float* J;            // [E, 7, 14] d r / d (xi_i, xi_j)
  float* H;            // [7K (7K + 1)] augmented system, row stride 7 n_free + 1
  int* piv;            // [7K] the solve's pivot rows
  float* cost;         // [E, 2] at S_new, at S
  float* lam;          // [1]
};

template <typename T>
__device__ void load_sim3(const float* src, T* dst) {
  for (int q = 0; q < 12; ++q) dst[q] = T(src[q]);
}

// r = log(Sm S_i S_j^-1) for S_i, S_j (3x4)
template <typename T>
__device__ void edge_residual(const T* Si, const T* Sj, const T* Sm, T* r) {
  T inv[12], a[12], b[12];
  sim3::sim3_inverse(Sj, inv);
  sim3::sim3_mul(Sm, Si, a);
  sim3::sim3_mul(a, inv, b);
  sim3::sim3_log(b, r);
}

__global__ void pg_jacobians_kernel(PG P) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)P.E * LANES) return;
  const int e = (int)(g / LANES), l = (int)(g % LANES);
  if (!P.evalid[e]) return;
  Dual xi[7], Ex[12], So[12], Sm[12], res[7];
  for (int q = 0; q < 7; ++q) xi[q] = Dual(0.f, q == l % 7 ? 1.f : 0.f);
  sim3::sim3_exp(xi, Ex);
  load_sim3(P.Sm + 16 * (size_t)e, Sm);
  Dual Si[12], Sj[12];
  if (l < 7) {
    load_sim3(P.S + 16 * (size_t)P.ei[e], So);
    sim3::sim3_mul(Ex, So, Si);
    load_sim3(P.S + 16 * (size_t)P.ej[e], Sj);
  } else {
    load_sim3(P.S + 16 * (size_t)P.ej[e], So);
    sim3::sim3_mul(Ex, So, Sj);
    load_sim3(P.S + 16 * (size_t)P.ei[e], Si);
  }
  edge_residual(Si, Sj, Sm, res);
  float* Je = P.J + (size_t)e * 7 * LANES;
  for (int q = 0; q < 7; ++q) Je[q * LANES + l] = res[q].d;
  if (l == 0)
    for (int q = 0; q < 7; ++q) P.r[7 * (size_t)e + q] = res[q].v;
}

__global__ void pg_assemble_kernel(PG P) {
  const int v = blockIdx.x;
  if (!P.free[v]) return;
  const int n = 7 * P.nfree[0], ld = n + 1, p = P.pos[v];
  float* rows = P.H + (size_t)(7 * p) * ld;
  for (int idx = threadIdx.x; idx < 7 * ld; idx += blockDim.x) rows[idx] = 0.f;
  __syncthreads();
  const int t = threadIdx.x;
  const int a = t / 7, b = t % 7;
  float diag = 0.f, rhs = 0.f;
  for (int e = 0; e < P.E; ++e) {
    if (!P.evalid[e]) continue;
    const int i = P.ei[e], j = P.ej[e];
    if (i != v && j != v) continue;
    const bool vi = i == v;
    const int u = vi ? j : i;
    const int lv = vi ? 0 : 7, lu = vi ? 7 : 0;
    const float w = P.ew[e];
    const float* Je = P.J + (size_t)e * 7 * LANES;
    if (t < 49) {
      float s = 0.f;
      for (int q = 0; q < 7; ++q) s += Je[q * LANES + lv + a] * Je[q * LANES + lv + b];
      diag += w * s;
      if (P.free[u]) {
        float s2 = 0.f;
        for (int q = 0; q < 7; ++q) s2 += Je[q * LANES + lv + a] * Je[q * LANES + lu + b];
        rows[(size_t)a * ld + 7 * P.pos[u] + b] += w * s2;
      }
    }
    if (t < 7) {
      float s = 0.f;
      for (int q = 0; q < 7; ++q) s += Je[q * LANES + lv + t] * P.r[7 * (size_t)e + q];
      rhs += w * s;
    }
  }
  if (t < 49) rows[(size_t)a * ld + 7 * p + b] = diag + (a == b ? P.lam[0] : 0.f);
  if (t < 7) rows[(size_t)t * ld + n] = -rhs;
}

template <int NB>
__global__ void __launch_bounds__(dense_lu::THREADS) pg_solve_kernel(PG P) {
  extern __shared__ float dyn[];
  const int n = 7 * P.nfree[0];
  dense_lu::solve<NB>(P.H, n, P.piv, 7 * P.K, dyn);
  if (cg::this_cluster().block_rank() != 0) return;
  const float* x = dyn;   // the solve leaves x there
  for (int v = threadIdx.x; v < P.K; v += dense_lu::THREADS) {
    float d[7], E[12], S[12], Sn[12];
    for (int q = 0; q < 7; ++q) d[q] = P.free[v] ? x[7 * P.pos[v] + q] : 0.f;
    sim3::sim3_exp(d, E);
    load_sim3(P.S + 16 * (size_t)v, S);
    sim3::sim3_mul(E, S, Sn);
    float* out = P.Snew + 16 * (size_t)v;
    for (int q = 0; q < 12; ++q) out[q] = Sn[q];
    out[12] = 0.f; out[13] = 0.f; out[14] = 0.f; out[15] = 1.f;
  }
}

__global__ void pg_cost_kernel(PG P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P.E) return;
  float c[2] = {0.f, 0.f};
  if (P.evalid[e]) {
    const float* src[2] = {P.Snew, P.S};
    for (int k = 0; k < 2; ++k) {
      float Si[12], Sj[12], Sm[12], r[7];
      load_sim3(src[k] + 16 * (size_t)P.ei[e], Si);
      load_sim3(src[k] + 16 * (size_t)P.ej[e], Sj);
      load_sim3(P.Sm + 16 * (size_t)e, Sm);
      edge_residual(Si, Sj, Sm, r);
      float s = 0.f;
      for (int q = 0; q < 7; ++q) s += r[q] * r[q];
      c[k] = P.ew[e] * s;
    }
  }
  P.cost[2 * (size_t)e] = c[0];
  P.cost[2 * (size_t)e + 1] = c[1];
}

__global__ void __launch_bounds__(DECIDE_THREADS) pg_decide_kernel(PG P) {
  __shared__ float red[2][DECIDE_THREADS / 32];
  __shared__ bool accept;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float c[2] = {0.f, 0.f};
  for (int e = threadIdx.x; e < P.E; e += DECIDE_THREADS) {
    c[0] += P.cost[2 * (size_t)e];
    c[1] += P.cost[2 * (size_t)e + 1];
  }
  for (int k = 0; k < 2; ++k) {
    float v = c[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s[2] = {0.f, 0.f};
    for (int k = 0; k < 2; ++k)
      for (int w = 0; w < DECIDE_THREADS / 32; ++w) s[k] += red[k][w];
    accept = s[0] < s[1];
    const float l = P.lam[0];
    P.lam[0] = fminf(fmaxf(accept ? l * 0.5f : l * 5.f, 1e-12f), 1e6f);
  }
  __syncthreads();
  if (accept)
    for (int q = threadIdx.x; q < 16 * P.K; q += DECIDE_THREADS) P.S[q] = P.Snew[q];
}

int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

// the five launches of one LM iteration, each its own entry point
// (pg_solve's below: a cluster launch)
#define PG_ENTRY(name, grid, threads)                                  \
  extern "C" int sspl_##name(const void* pg, void* stream) {           \
    const PG& P = *(const PG*)pg;                                      \
    if (P.K < 1 || P.E < 1) return (int)cudaErrorInvalidValue;         \
    name##_kernel<<<(grid), (threads), 0, (cudaStream_t)stream>>>(P);  \
    return (int)cudaGetLastError();                                    \
  }

PG_ENTRY(pg_jacobians, blocks((long long)P.E * LANES, 128), 128)
PG_ENTRY(pg_assemble, P.K, 64)
PG_ENTRY(pg_cost, blocks(P.E, 128), 128)
PG_ENTRY(pg_decide, 1, DECIDE_THREADS)

// the panel width that fits the capacity's strip in shared memory: 32, or
// 16 past ~1400 rows (the 256-keyframe capacity: 1792)
extern "C" int sspl_pg_solve(const void* pg, void* stream) {
  const PG& P = *(const PG*)pg;
  if (P.K < 1 || P.E < 1) return (int)cudaErrorInvalidValue;
  const int cap = 7 * P.K;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dense_lu::panel_width(cap)) {
    case 32:
      return (int)dense_lu::launch(pg_solve_kernel<32>, dense_lu::smem_bytes<32>(cap), st, P);
    case 16:
      return (int)dense_lu::launch(pg_solve_kernel<16>, dense_lu::smem_bytes<16>(cap), st, P);
  }
  return (int)cudaErrorInvalidValue;
}
