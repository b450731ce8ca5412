// Kernel 4: pose-only Gauss-Newton with chi2 rounds, one block per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/pose_opt.py
// `pose_optimize` (:114). The reference unrolls the rounds x iterations
// schedule into one XLA program and lays the per-edge Jacobians out as
// [6, R] planes for the TPU's (8, 128) tiles, contracting them on the MXU
// each iteration. Here the whole schedule is ONE launch of one 256-thread
// block: per iteration every thread projects its edges with the pose held
// in shared memory and accumulates its share of (H | g | cost) in
// registers (21 + 6 + 1 floats), a shuffle + shared-memory tree reduces
// them, thread 0 runs the unrolled damped 6x6 Cholesky of the reference
// (`_chol_solve6`, :43), clips the step to norm 0.5 and left-multiplies
// se3_exp(dx); between rounds the chi2 gates reclassify the edges with
// the reference's floor of 10 edges. Points and lines are both taken:
// a line contributes its start- and end-point rows (e = l . (u, v, 1)).
//
// Bound on the card: operations, ~170 flops per active edge per pass over
// ~30 passes, a few nanoseconds at the card's rate for the few hundred
// active edges of a frame (the input is ~40 B per landmark, ~100 KB at
// N = 2048, M = 256). The kernel is latency-bound instead: one block runs
// every pass on one SM, and the serial 6x6 solve and the ~30 block-wide
// barriers set its time. That trade keeps the whole schedule in one
// launch with no host round trip, which is what the per-frame path needs;
// spreading the edge passes over several blocks is later work.
//
// Numerics: float32 throughout, sums in another order than XLA (the
// parity check holds the pose to 1e-4 and the inlier masks to 99.5%).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int NACC = 28;  // 21 upper-triangular H, 6 g, 1 cost

struct Params {
  const float* X;       // [N + 2M, 3]: points, line starts, line ends
  const float* obs_uv;  // [N, 2]
  const bool* pt_mask;
  const float* pt_info;
  const float* line_obs;  // [M, 3]
  const bool* ln_mask;
  const float* ln_info;
  int N, M;
  float fx, fy, cx, cy;
  float chi2_mono, chi2_line, delta_pt, delta_ln;
};

struct Proj {
  float u, v, z, Ju[6], Jv[6];
};

__device__ __forceinline__ void project(const float* T, const float* Xp, float fx,
                                        float fy, float cx, float cy, Proj& p) {
  const float X0 = Xp[0], X1 = Xp[1], X2 = Xp[2];
  const float x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  const float y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float z = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const float iz = 1.f / (fabsf(z) < 1e-6f ? 1e-6f : z);
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
  return fminf(1.f, delta / sqrtf(fmaxf(chi2, 1e-12f)));
}

// acc += w * J J^T (upper triangle), g += w * J * r
__device__ __forceinline__ void accum(float* acc, const float* J, float w, float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += w * J[i] * J[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += w * J[i] * r;
}

// classification of one edge item (point i < N, else line i - N)
__device__ bool classify(const Params& P, const float* T, int i, bool first,
                         bool fallback) {
  Proj p;
  if (i < P.N) {
    project(T, P.X + 3 * i, P.fx, P.fy, P.cx, P.cy, p);
    bool in = P.pt_mask[i] && p.z > 0.f;
    if (!first && !fallback) {
      const float ru = P.obs_uv[2 * i] - p.u, rv = P.obs_uv[2 * i + 1] - p.v;
      in = in && (ru * ru + rv * rv) * P.pt_info[i] <= P.chi2_mono;
    }
    return in;
  }
  const int j = i - P.N;
  const float* l = P.line_obs + 3 * j;
  bool in = P.ln_mask[j];
  bool ep_ok = true;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    project(T, P.X + 3 * (P.N + e * P.M + j), P.fx, P.fy, P.cx, P.cy, p);
    in = in && p.z > 0.f;
    const float r = l[0] * p.u + l[1] * p.v + l[2];
    ep_ok = ep_ok && r * r * P.ln_info[j] <= P.chi2_line;
  }
  return (!first && !fallback) ? (in && ep_ok) : in;
}

__device__ void block_sum(float* acc, float (*red)[NACC], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

__device__ int block_count(int c, int* cred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if (lane == 0) cred[warp] = c;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < NW; ++w) s += cred[w];
  __syncthreads();
  return s;
}

// thread 0: damped Cholesky solve, step clip, T <- exp(dx) T
__device__ void solve_and_update(const float* tot, float lam, float* T) {
  float A[6][6], b[6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) { A[i][j] = tot[k]; A[j][i] = tot[k]; ++k; }
  for (int i = 0; i < 6; ++i) {
    b[i] = tot[21 + i];
    A[i][i] = A[i][i] + lam * A[i][i] + 1e-8f;
  }
  float L[6][6];
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int q = 0; q < j; ++q) s -= L[j][q] * L[j][q];
    L[j][j] = sqrtf(fmaxf(s, 1e-12f));
    const float inv_d = 1.f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i][j];
      for (int q = 0; q < j; ++q) t -= L[i][q] * L[j][q];
      L[i][j] = t * inv_d;
    }
  }
  float y[6], x[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int q = 0; q < i; ++q) s -= L[i][q] * y[q];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int q = i + 1; q < 6; ++q) s -= L[q][i] * x[q];
    x[i] = s / L[i][i];
  }
  float nrm = 0.f;
  for (int i = 0; i < 6; ++i) nrm += x[i] * x[i];
  nrm = sqrtf(nrm);
  const float sc = fminf(1.f, 0.5f / fmaxf(nrm, 1e-9f));
  for (int i = 0; i < 6; ++i) x[i] *= sc;
  // se3_exp with the reference's small-angle branch (utils/lie.py)
  const float w0 = x[0], w1 = x[1], w2 = x[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  float Ac, Bc, Cc;
  if (th2 < 1e-4f) {
    Ac = 1.f - th2 / 6.f; Bc = 0.5f - th2 / 24.f; Cc = 1.f / 6.f - th2 / 120.f;
  } else {
    const float th = sqrtf(th2);
    Ac = sinf(th) / th; Bc = (1.f - cosf(th)) / th2; Cc = (th - sinf(th)) / (th2 * th);
  }
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float E[3][4];
  for (int i = 0; i < 3; ++i) {
    float tv = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      E[i][j] = id + Ac * W[i][j] + Bc * W2[i][j];
      tv += (id + Bc * W[i][j] + Cc * W2[i][j]) * x[3 + j];
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

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(Params P, const float* __restrict__ T_init, int rounds, int iters,
               float lam, float* __restrict__ T_out, bool* __restrict__ pt_in,
               bool* __restrict__ ln_in, float* __restrict__ cost_out) {
  __shared__ float T[16];
  __shared__ float red[NW][NACC];
  __shared__ float tot[NACC];
  __shared__ int cred[NW];
  const int n_items = P.N + P.M;
  if (threadIdx.x < 16) T[threadIdx.x] = T_init[threadIdx.x];
  __syncthreads();
  float cost = 0.f;
  for (int rnd = 0; rnd < rounds; ++rnd) {
    int c = 0;
    for (int i = threadIdx.x; i < n_items; i += THREADS) {
      const bool in = classify(P, T, i, rnd == 0, false);
      if (i < P.N) pt_in[i] = in; else ln_in[i - P.N] = in;
      c += in;
    }
    if (block_count(c, cred) < 10) {
      for (int i = threadIdx.x; i < n_items; i += THREADS) {
        const bool in = classify(P, T, i, rnd == 0, true);
        if (i < P.N) pt_in[i] = in; else ln_in[i - P.N] = in;
      }
    }
    for (int it = 0; it < iters; ++it) {
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
      for (int i = threadIdx.x; i < n_items; i += THREADS) {
        Proj p;
        if (i < P.N) {
          if (!pt_in[i]) continue;
          project(T, P.X + 3 * i, P.fx, P.fy, P.cx, P.cy, p);
          const float ru = P.obs_uv[2 * i] - p.u, rv = P.obs_uv[2 * i + 1] - p.v;
          const float chi2 = (ru * ru + rv * rv) * P.pt_info[i];
          const float w = huber(chi2, P.delta_pt) * P.pt_info[i];
          accum(acc, p.Ju, w, ru);
          accum(acc, p.Jv, w, rv);
          acc[27] += fminf(chi2, P.chi2_mono * 4.f);
        } else {
          const int j = i - P.N;
          if (!ln_in[j]) continue;
          const float* l = P.line_obs + 3 * j;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            project(T, P.X + 3 * (P.N + e * P.M + j), P.fx, P.fy, P.cx, P.cy, p);
            const float r = l[0] * p.u + l[1] * p.v + l[2];
            const float chi2 = r * r * P.ln_info[j];
            const float w = huber(chi2, P.delta_ln) * P.ln_info[j];
            float Jl[6];
#pragma unroll
            for (int q = 0; q < 6; ++q) Jl[q] = l[0] * p.Ju[q] + l[1] * p.Jv[q];
            accum(acc, Jl, w, -r);
            acc[27] += fminf(chi2, P.chi2_line * 4.f);
          }
        }
      }
      block_sum(acc, red, tot);
      if (threadIdx.x == 0) {
        cost = tot[27];
        solve_and_update(tot, lam, T);
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n_items; i += THREADS) {
    const bool in = classify(P, T, i, false, false);
    if (i < P.N) pt_in[i] = in; else ln_in[i - P.N] = in;
  }
  if (threadIdx.x < 16) T_out[threadIdx.x] = T[threadIdx.x];
  if (threadIdx.x == 0) *cost_out = cost;
}

}  // namespace

extern "C" int sspl_pose_lm(const void* T_init, const void* X, const void* obs_uv,
                            const void* pt_mask, const void* pt_info,
                            const void* line_obs, const void* ln_mask,
                            const void* ln_info, int N, int M, float fx, float fy,
                            float cx, float cy, int rounds, int iters,
                            float chi2_mono, float chi2_line, float delta_pt,
                            float delta_ln, float lam, void* T_out, void* pt_in,
                            void* ln_in, void* cost, void* stream) {
  Params P{(const float*)X, (const float*)obs_uv, (const bool*)pt_mask,
           (const float*)pt_info, (const float*)line_obs, (const bool*)ln_mask,
           (const float*)ln_info, N, M, fx, fy, cx, cy, chi2_mono, chi2_line,
           delta_pt, delta_ln};
  pose_lm_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      P, (const float*)T_init, rounds, iters, lam, (float*)T_out, (bool*)pt_in,
      (bool*)ln_in, (float*)cost);
  return (int)cudaGetLastError();
}
