// Kernel 17: the inlier-gated Sim(3) refinement of loop verification.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/
// pose_graph.py `optimize_sim3_pair` (:134), the reference's
// Optimizer::OptimizeSim3, called by models/loop_closing.py `verify`
// (:427-438). Every matched pair contributes two projection edges: point 2
// through S12 into image 1 and point 1 through S12^-1 into image 2. The
// schedule is 5 LM iterations (Huber IRLS with delta = sqrt(chi2_th), a 7x7
// solve with the scale prior and the damping, accept / reject), the chi2
// cut, then 10 more on the survivors, and the final inlier test.
//
// Here the whole schedule is ONE launch of one 512-thread block, like
// kernel 4 (csrc/pose_lm.cu). Per iteration every thread takes its pairs
// and accumulates the 28 upper-triangular terms of H and the 7 of b in
// registers; a shuffle + shared-memory tree reduces them in a fixed order.
// Thread 0 adds the scale prior (pose_graph.py:218-223) and the damping
// (:224), solves the 7x7 by Gaussian elimination with partial pivoting and
// forms S_new = sim3_exp(dx) S (csrc/sim3.cuh). A second block-wide pass
// sums the Huber-composed cost at S_new and at S; accept / reject and
// lambda stay in shared memory. The working inlier mask lives in the
// output row.
//
// The Jacobian is ANALYTIC: at xi = 0 the generators of Sim(3) act on the
// transformed point q as d q = [-hat(q) | I | q] dxi (omega, upsilon,
// sigma), so the forward edge has d e1 = -Dproj(p1) [-hat(p1) | I | p1]
// and the inverse edge, whose point is S^-1 exp(-xi) X1, has
// d e2 = -Dproj(p2) (R^T / s) [hat(X1) | -I | -X1]. That is what
// jax.jacfwd evaluates at zero (the plain version takes it with
// torch.func.jvp); the two differ by rounding.
//
// Bound on the card: operations, ~400 per pair per iteration (both
// projections, the 4x7 Jacobian, the 35 normal-equation terms, two cost
// passes) over 15 iterations and N = 1024 pairs, against 40 KB of input.
// One block on one SM and the serial 7x7 solves set the time.
//
// Built with -fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sim3.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
constexpr int NACC = 35;  // 28 upper-triangular H, 7 b

struct Params {
  const float* X1;    // [N, 3]
  const float* X2;    // [N, 3]
  const float* uv1;   // [N, 2]
  const float* uv2;   // [N, 2]
  const bool* valid;  // [N]
  const float* sig1;  // [N]
  const float* sig2;  // [N]
  int N;
  float fx, fy, cx, cy, chi2, delta;
};

struct Edge {
  float r[4];
  float J[4][7];
  float c1, c2;
};

__device__ __forceinline__ void proj_d(const float* p, const Params& P, float* uv, float* D) {
  const bool guard = fabsf(p[2]) < 1e-9f;
  const float z = guard ? 1e-9f : p[2];
  uv[0] = p[0] / z * P.fx + P.cx;
  uv[1] = p[1] / z * P.fy + P.cy;
  if (D) {
    D[0] = P.fx / z; D[1] = 0.f; D[2] = guard ? 0.f : -(P.fx * p[0] / (z * z));
    D[3] = 0.f; D[4] = P.fy / z; D[5] = guard ? 0.f : -(P.fy * p[1] / (z * z));
  }
}

// residuals (and with jac, the Jacobian) of pair n at S (3x4) / Si = S^-1
__device__ void edge_eval(const Params& P, int n, const float* S, const float* Si, float s,
                          bool jac, Edge& e) {
  const float* x2 = P.X2 + 3 * (size_t)n;
  const float* x1 = P.X1 + 3 * (size_t)n;
  float p1[3], p2[3];
  for (int i = 0; i < 3; ++i) {
    p1[i] = x2[0] * S[4 * i] + x2[1] * S[4 * i + 1] + x2[2] * S[4 * i + 2] + S[4 * i + 3];
    p2[i] = x1[0] * Si[4 * i] + x1[1] * Si[4 * i + 1] + x1[2] * Si[4 * i + 2] + Si[4 * i + 3];
  }
  float uv[2], D1[6], D2[6];
  proj_d(p1, P, uv, jac ? D1 : nullptr);
  e.r[0] = P.uv1[2 * n] - uv[0];
  e.r[1] = P.uv1[2 * n + 1] - uv[1];
  proj_d(p2, P, uv, jac ? D2 : nullptr);
  e.r[2] = P.uv2[2 * n] - uv[0];
  e.r[3] = P.uv2[2 * n + 1] - uv[1];
  e.c1 = (e.r[0] * e.r[0] + e.r[1] * e.r[1]) / fmaxf(P.sig1[n], 1e-12f);
  e.c2 = (e.r[2] * e.r[2] + e.r[3] * e.r[3]) / fmaxf(P.sig2[n], 1e-12f);
  if (!jac) return;
  // G1 = [-hat(p1) | I | p1], G2 = (R^T / s) [hat(X1) | -I | -X1], 3x7 each
  float G1[3][7], G2[3][7], Gx[3][7];
  const float H1[9] = {0.f, -p1[2], p1[1], p1[2], 0.f, -p1[0], -p1[1], p1[0], 0.f};
  const float Hx[9] = {0.f, -x1[2], x1[1], x1[2], 0.f, -x1[0], -x1[1], x1[0], 0.f};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      G1[i][j] = -H1[3 * i + j];
      G1[i][3 + j] = i == j ? 1.f : 0.f;
      Gx[i][j] = Hx[3 * i + j];
      Gx[i][3 + j] = i == j ? -1.f : 0.f;
    }
    G1[i][6] = p1[i];
    Gx[i][6] = -x1[i];
  }
  // the linear part of S^-1 is Si's 3x3 block, R^T / s
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 7; ++j)
      G2[i][j] = Si[4 * i] * Gx[0][j] + Si[4 * i + 1] * Gx[1][j] + Si[4 * i + 2] * Gx[2][j];
  for (int j = 0; j < 7; ++j) {
    for (int r = 0; r < 2; ++r) {
      e.J[r][j] = -(D1[3 * r] * G1[0][j] + D1[3 * r + 1] * G1[1][j] + D1[3 * r + 2] * G1[2][j]);
      e.J[2 + r][j] =
          -(D2[3 * r] * G2[0][j] + D2[3 * r + 1] * G2[1][j] + D2[3 * r + 2] * G2[2][j]);
    }
  }
}

__device__ __forceinline__ float rho(float c, const Params& P) {
  return c > P.chi2 ? 2.f * P.delta * sqrtf(fmaxf(c, 1e-12f)) - P.chi2 : c;
}

// block-wide sum of NV values per thread into out (all threads read it);
// per thread in pair order, then a shuffle tree, then the warps in order
template <int NV>
__device__ void block_sum(float* acc, float (*red)[NACC], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = 0; q < NV; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// the 7x7 system (upper triangle in A, rhs b), solved in place into b
__device__ void solve7(const float* Hu, float* b) {
  float A[7][7];
  int q = 0;
  for (int i = 0; i < 7; ++i)
    for (int j = i; j < 7; ++j) {
      A[i][j] = Hu[q];
      A[j][i] = Hu[q];
      ++q;
    }
  for (int c = 0; c < 7; ++c) {
    int p = c;
    for (int r = c + 1; r < 7; ++r)
      if (fabsf(A[r][c]) > fabsf(A[p][c])) p = r;
    if (p != c) {
      for (int j = 0; j < 7; ++j) {
        const float t = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = t;
      }
      const float t = b[c];
      b[c] = b[p];
      b[p] = t;
    }
    for (int r = c + 1; r < 7; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int j = c + 1; j < 7; ++j) A[r][j] = A[r][j] - f * A[c][j];
      b[r] = b[r] - f * b[c];
    }
  }
  for (int r = 6; r >= 0; --r) {
    float acc = b[r];
    for (int j = r + 1; j < 7; ++j) acc = acc - A[r][j] * b[j];
    b[r] = acc / A[r][r];
  }
}

__global__ void __launch_bounds__(THREADS)
sim3_pair_kernel(Params P, const float* __restrict__ S_init, int n_first, int n_second,
                 int fix_scale, float* __restrict__ S_out, bool* __restrict__ inl,
                 int32_t* __restrict__ n_inl) {
  __shared__ float red[NW][NACC];
  __shared__ float sums[NACC];
  __shared__ float S[12], Sn[12], Si[12], Sni[12];
  __shared__ float s_cur, s_new, s_init, lam;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int q = 0; q < 12; ++q) S[q] = S_init[q];
    s_init = sim3::sim3_scale(S);
    lam = 1e-3f;
  }
  for (int n = tid; n < P.N; n += THREADS) inl[n] = P.valid[n];
  __syncthreads();
  for (int phase = 0; phase < 2; ++phase) {
    const int iters = phase ? n_second : n_first;
    if (phase) {
      // the chi2 cut (Optimizer.cc:1980-2010)
      for (int n = tid; n < P.N; n += THREADS) {
        Edge e;
        edge_eval(P, n, S, Si, s_cur, false, e);
        inl[n] = P.valid[n] && e.c1 <= P.chi2 && e.c2 <= P.chi2;
      }
      __syncthreads();
    }
    for (int it = 0; it < iters; ++it) {
      if (tid == 0) {
        sim3::sim3_inverse(S, Si);
        s_cur = sim3::sim3_scale(S);
      }
      __syncthreads();
      float acc[NACC];
      for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
      for (int n = tid; n < P.N; n += THREADS) {
        if (!inl[n]) continue;
        Edge e;
        edge_eval(P, n, S, Si, s_cur, true, e);
        const float w1 = e.c1 > P.chi2 ? P.delta / sqrtf(fmaxf(e.c1, 1e-12f)) : 1.f;
        const float w2 = e.c2 > P.chi2 ? P.delta / sqrtf(fmaxf(e.c2, 1e-12f)) : 1.f;
        const float i1 = 1.f / fmaxf(P.sig1[n], 1e-12f), i2 = 1.f / fmaxf(P.sig2[n], 1e-12f);
        const float w[4] = {w1 * i1, w1 * i1, w2 * i2, w2 * i2};
        int q = 0;
        for (int i = 0; i < 7; ++i)
          for (int j = i; j < 7; ++j) {
            float t = 0.f;
            for (int r = 0; r < 4; ++r) t += e.J[r][i] * w[r] * e.J[r][j];
            acc[q++] += t;
          }
        for (int i = 0; i < 7; ++i) {
          float t = 0.f;
          for (int r = 0; r < 4; ++r) t += e.J[r][i] * w[r] * e.r[r];
          acc[28 + i] -= t;
        }
      }
      block_sum<NACC>(acc, red, sums);
      if (tid == 0) {
        float Hu[28], b[7];
        for (int q = 0; q < 28; ++q) Hu[q] = sums[q];
        for (int i = 0; i < 7; ++i) b[i] = sums[28 + i];
        // the scale anchor on the Horn initializer, then fix_scale, then
        // lam * (diag(H) + 1e-3 I) (pose_graph.py:218-224); entry (6, 6) of
        // the upper triangle is the last
        const float w_s = 1e3f;
        Hu[27] = Hu[27] + w_s;
        b[6] = b[6] + -(w_s * logf(fmaxf(s_cur / s_init, 1e-12f)));
        if (fix_scale) Hu[27] = Hu[27] + 1e12f;
        int q = 0;
        for (int i = 0; i < 7; ++i)
          for (int j = i; j < 7; ++j, ++q)
            if (i == j) Hu[q] = Hu[q] + lam * (Hu[q] + 1e-3f);
        solve7(Hu, b);
        float E[12];
        sim3::sim3_exp(b, E);
        sim3::sim3_mul(E, S, Sn);
        sim3::sim3_inverse(Sn, Sni);
        s_new = sim3::sim3_scale(Sn);
      }
      __syncthreads();
      // Huber-composed cost at S_new and at S
      float c[2] = {0.f, 0.f};
      for (int n = tid; n < P.N; n += THREADS) {
        if (!inl[n]) continue;
        Edge e;
        edge_eval(P, n, Sn, Sni, s_new, false, e);
        c[0] += rho(e.c1, P) + rho(e.c2, P);
        edge_eval(P, n, S, Si, s_cur, false, e);
        c[1] += rho(e.c1, P) + rho(e.c2, P);
      }
      block_sum<2>(c, red, sums);
      if (tid == 0) {
        const bool accept = sums[0] < sums[1];
        if (accept)
          for (int q = 0; q < 12; ++q) S[q] = Sn[q];
        lam = fminf(fmaxf(accept ? lam * 0.3f : lam * 8.f, 1e-8f), 1e8f);
      }
      __syncthreads();
    }
    if (tid == 0) {
      sim3::sim3_inverse(S, Si);
      s_cur = sim3::sim3_scale(S);
    }
    __syncthreads();
  }
  // the final inliers at S
  float cnt[1] = {0.f};
  for (int n = tid; n < P.N; n += THREADS) {
    Edge e;
    edge_eval(P, n, S, Si, s_cur, false, e);
    const bool ok = P.valid[n] && e.c1 <= P.chi2 && e.c2 <= P.chi2;
    inl[n] = ok;
    cnt[0] += ok ? 1.f : 0.f;
  }
  block_sum<1>(cnt, red, sums);
  if (tid < 16) S_out[tid] = tid < 12 ? S[tid] : (tid == 15 ? 1.f : 0.f);
  if (tid == 0) n_inl[0] = (int32_t)sums[0];
}

}  // namespace

extern "C" int sspl_sim3_pair(const void* S12, const void* X1, const void* X2, const void* uv1,
                              const void* uv2, const void* valid, const void* sig1,
                              const void* sig2, int N, float fx, float fy, float cx, float cy,
                              float chi2, float delta, int n_first, int n_second,
                              int fix_scale, void* S_out, void* inl, void* n_inl,
                              void* stream) {
  Params P{(const float*)X1, (const float*)X2, (const float*)uv1, (const float*)uv2,
           (const bool*)valid, (const float*)sig1, (const float*)sig2, N, fx, fy, cx, cy,
           chi2, delta};
  sim3_pair_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      P, (const float*)S12, n_first, n_second, fix_scale, (float*)S_out, (bool*)inl,
      (int32_t*)n_inl);
  return (int)cudaGetLastError();
}
