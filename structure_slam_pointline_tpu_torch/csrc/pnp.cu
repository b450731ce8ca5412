// Kernel 15: batched RANSAC PnP over the relocalization candidates.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/pnp.py
// `ransac_pnp` (:34), vmapped over the candidates at
// models/relocalization.py:62: per hypothesis a 6-point DLT whose null
// vector comes from one batched [I, 12, 12] jnp.linalg.svd, R from the SVD
// of the 3x3 block with a det fix, t by the mean singular value, a
// cheirality sign flip over the six points, then one [I, N] reprojection
// pass and the first-index argmax. Three launches:
//
//   A (pnp_hypotheses): one thread per (candidate, hypothesis). It builds
//     the 12x12 DLT in float64 from the six sampled rows, forms A^T A and
//     takes the eigenvector of its smallest eigenvalue by cyclic Jacobi, in
//     float64 (float32 A^T A would square the condition number). The null
//     vector's sign is normalized so that det(P[:, :3]) > 0 (the port's one
//     departure from the reference, whose SVD may return either sign; see
//     ops/pnp.py). R is the orthonormal factor of M = P[:, :3]: with
//     det M > 0 the reference's det fix leaves R = U V^T, which this thread
//     takes from the eigenpairs of M^T M (u_i = M v_i / s_i for the two
//     largest, u_3 = det(V) u_1 x u_2), so R does not depend on the signs an
//     SVD routine picks. scale = mean singular value, t = P[:, 3] / scale,
//     and the flip when the six points' depth signs sum below zero, as
//     pnp.py:62-73. Out: [R | t] as float32.
//   B (pnp_count): one block per hypothesis counts its inliers over the N
//     points in float32, the plain version's operation order
//     (err <= CHI2_2D * sigma2, zc > 0, the mask; pnp.py:76-83).
//   C (pnp_select): one block per candidate takes the first index of the
//     largest count, writes T_cw, the count and that hypothesis' inlier row.
//
// Bound on the card: operations. Launch A does ~10^5 float64 operations per
// hypothesis (a Jacobi sweep over 66 pairs of a 12x12, about eight sweeps),
// against 4096 hypotheses at the relocalization shape; launches B and C read
// 12 B per point and hypothesis from L2. Built with -fmad=false, so the
// float32 scoring rounds each product and sum as the torch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int COUNT_THREADS = 128;
constexpr int SELECT_THREADS = 256;
constexpr int MAX_SWEEPS = 30;

struct Cam {
  float fx, fy, cx, cy;
};

// eigen-decomposition of a symmetric n x n matrix (row-major, in place) by
// cyclic Jacobi; V receives the eigenvectors as columns
template <int n>
__device__ void jacobi_eig(double* a, double* V) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) V[i * n + j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p * n + q];
        const double app = a[p * n + p], aqq = a[q * n + q];
        if (fabs(apq) <= 1e-300 || fabs(apq) <= 1e-17 * sqrt(fabs(app * aqq))) continue;
        rotated = true;
        const double theta = (aqq - app) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < n; ++k) {
          const double akp = a[k * n + p], akq = a[k * n + q];
          a[k * n + p] = c * akp - s * akq;
          a[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {
          const double apk = a[p * n + k], aqk = a[q * n + k];
          a[p * n + k] = c * apk - s * aqk;
          a[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          const double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
    if (!rotated) break;
  }
}

__device__ double det3(const double* m) {  // row-major 3x3
  return m[0] * (m[4] * m[8] - m[5] * m[7]) - m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

__global__ void pnp_hypotheses_kernel(const float* __restrict__ pts_w,
                                      const float* __restrict__ uv,
                                      const int32_t* __restrict__ sets, int C, int I, int N,
                                      Cam cam, float* __restrict__ hyp) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= C * I) return;
  const int c = g / I;
  const int32_t* s = sets + (size_t)g * 6;
  double X[6][3];
  double A[12][12];
  for (int k = 0; k < 6; ++k) {
    const int n = s[k];
    const float* p = pts_w + ((size_t)c * N + n) * 3;
    const float xu = (uv[2 * n] - cam.cx) / cam.fx;
    const float xv = (uv[2 * n + 1] - cam.cy) / cam.fy;
    double Xh[4] = {p[0], p[1], p[2], 1.0};
    for (int j = 0; j < 3; ++j) X[k][j] = Xh[j];
    for (int j = 0; j < 4; ++j) {
      // row k: [0, -Xh, v Xh]; row 6 + k: [Xh, 0, -u Xh] (pnp.py:55-57)
      A[k][j] = 0.0;
      A[k][4 + j] = -Xh[j];
      A[k][8 + j] = (double)xv * Xh[j];
      A[6 + k][j] = Xh[j];
      A[6 + k][4 + j] = 0.0;
      A[6 + k][8 + j] = -(double)xu * Xh[j];
    }
  }
  double G[144], V[144];
  for (int i = 0; i < 12; ++i)
    for (int j = i; j < 12; ++j) {
      double acc = 0.0;
      for (int r = 0; r < 12; ++r) acc += A[r][i] * A[r][j];
      G[i * 12 + j] = acc;
      G[j * 12 + i] = acc;
    }
  jacobi_eig<12>(G, V);
  int kmin = 0;
  for (int k = 1; k < 12; ++k)
    if (G[k * 12 + k] < G[kmin * 12 + kmin]) kmin = k;
  double P[12];
  double nrm = 0.0;
  for (int r = 0; r < 12; ++r) {
    P[r] = V[r * 12 + kmin];
    nrm += P[r] * P[r];
  }
  nrm = 1.0 / sqrt(nrm);
  double M[9];
  for (int r = 0; r < 12; ++r) P[r] *= nrm;
  for (int r = 0; r < 3; ++r)
    for (int j = 0; j < 3; ++j) M[r * 3 + j] = P[r * 4 + j];
  if (det3(M) < 0.0) {
    for (int r = 0; r < 12; ++r) P[r] = -P[r];
    for (int k = 0; k < 9; ++k) M[k] = -M[k];
  }
  // polar factor of M from the eigenpairs of M^T M
  double S[9], W3[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      S[i * 3 + j] = M[i] * M[j] + M[3 + i] * M[3 + j] + M[6 + i] * M[6 + j];
  jacobi_eig<3>(S, W3);
  int ord[3] = {0, 1, 2};
  for (int a = 0; a < 2; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (S[ord[b] * 4] > S[ord[a] * 4]) {
        const int tmp = ord[a];
        ord[a] = ord[b];
        ord[b] = tmp;
      }
  double v[3][3], u[3][3], sv[3];
  for (int k = 0; k < 3; ++k) {
    sv[k] = sqrt(fmax(S[ord[k] * 4], 0.0));
    for (int r = 0; r < 3; ++r) v[k][r] = W3[r * 3 + ord[k]];
  }
  for (int k = 0; k < 2; ++k) {
    const double inv = 1.0 / fmax(sv[k], 1e-300);
    for (int r = 0; r < 3; ++r)
      u[k][r] = (M[r * 3] * v[k][0] + M[r * 3 + 1] * v[k][1] + M[r * 3 + 2] * v[k][2]) * inv;
  }
  const double Vm[9] = {v[0][0], v[1][0], v[2][0], v[0][1], v[1][1], v[2][1],
                        v[0][2], v[1][2], v[2][2]};
  const double dv = det3(Vm) < 0.0 ? -1.0 : 1.0;
  u[2][0] = dv * (u[0][1] * u[1][2] - u[0][2] * u[1][1]);
  u[2][1] = dv * (u[0][2] * u[1][0] - u[0][0] * u[1][2]);
  u[2][2] = dv * (u[0][0] * u[1][1] - u[0][1] * u[1][0]);
  double R[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[i * 3 + j] = u[0][i] * v[0][j] + u[1][i] * v[1][j] + u[2][i] * v[2][j];
  const double scale = fmax((sv[0] + sv[1] + sv[2]) / 3.0, 1e-12);
  double t[3] = {P[3] / scale, P[7] / scale, P[11] / scale};
  double zs = 0.0;
  for (int k = 0; k < 6; ++k) {
    const double z = R[6] * X[k][0] + R[7] * X[k][1] + R[8] * X[k][2] + t[2];
    zs += (z > 0.0) - (z < 0.0);
  }
  const double f = zs < 0.0 ? -1.0 : 1.0;
  float* out = hyp + (size_t)g * 12;
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) out[r * 4 + j] = (float)(f * R[r * 3 + j]);
    out[r * 4 + 3] = (float)(f * t[r]);
  }
}

// inlier test of point n under hypothesis h (row-major [R | t]), float32,
// the plain version's order of operations
__device__ __forceinline__ bool inlier(const float* h, const float* p, const float* uvn,
                                       bool m, Cam cam, float thresh) {
  const float pc0 = h[0] * p[0] + h[1] * p[1] + h[2] * p[2] + h[3];
  const float pc1 = h[4] * p[0] + h[5] * p[1] + h[6] * p[2] + h[7];
  const float zc = h[8] * p[0] + h[9] * p[1] + h[10] * p[2] + h[11];
  const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  const float up = pc0 / zs * cam.fx + cam.cx;
  const float vp = pc1 / zs * cam.fy + cam.cy;
  const float du = up - uvn[0], dv = vp - uvn[1];
  const float err = du * du + dv * dv;
  return err <= thresh && zc > 0.f && m;
}

__global__ void __launch_bounds__(COUNT_THREADS)
pnp_count_kernel(const float* __restrict__ hyp, const float* __restrict__ pts_w,
                 const float* __restrict__ uv, const bool* __restrict__ mask, int I, int N,
                 Cam cam, float thresh, int32_t* __restrict__ counts) {
  __shared__ float h[12];
  __shared__ int warp_sum[COUNT_THREADS / 32];
  const int g = blockIdx.x, c = g / I;
  if (threadIdx.x < 12) h[threadIdx.x] = hyp[(size_t)g * 12 + threadIdx.x];
  __syncthreads();
  int cnt = 0;
  for (int n = threadIdx.x; n < N; n += COUNT_THREADS)
    cnt += inlier(h, pts_w + ((size_t)c * N + n) * 3, uv + 2 * n, mask[(size_t)c * N + n],
                  cam, thresh);
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < COUNT_THREADS / 32; ++w) s += warp_sum[w];
    counts[g] = s;
  }
}

__global__ void __launch_bounds__(SELECT_THREADS)
pnp_select_kernel(const float* __restrict__ hyp, const int32_t* __restrict__ counts,
                  const float* __restrict__ pts_w, const float* __restrict__ uv,
                  const bool* __restrict__ mask, int I, int N, Cam cam, float thresh,
                  float* __restrict__ T_cw, bool* __restrict__ inl,
                  int32_t* __restrict__ n_best) {
  __shared__ int bv[SELECT_THREADS], bi[SELECT_THREADS];
  __shared__ float h[12];
  const int c = blockIdx.x;
  int v = -1, idx = 0;
  for (int i = threadIdx.x; i < I; i += SELECT_THREADS) {
    const int ci = counts[(size_t)c * I + i];
    if (ci > v) {  // strict: a thread's first index keeps a tie
      v = ci;
      idx = i;
    }
  }
  bv[threadIdx.x] = v;
  bi[threadIdx.x] = idx;
  __syncthreads();
  for (int s = SELECT_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int v2 = bv[threadIdx.x + s], i2 = bi[threadIdx.x + s];
      if (v2 > bv[threadIdx.x] || (v2 == bv[threadIdx.x] && i2 < bi[threadIdx.x])) {
        bv[threadIdx.x] = v2;
        bi[threadIdx.x] = i2;
      }
    }
    __syncthreads();
  }
  const int best = bi[0];
  if (threadIdx.x < 12) h[threadIdx.x] = hyp[((size_t)c * I + best) * 12 + threadIdx.x];
  __syncthreads();
  if (threadIdx.x < 16) {
    const int r = threadIdx.x / 4, q = threadIdx.x % 4;
    T_cw[(size_t)c * 16 + threadIdx.x] = r < 3 ? h[r * 4 + q] : (q == 3 ? 1.f : 0.f);
  }
  if (threadIdx.x == 0) n_best[c] = bv[0];
  for (int n = threadIdx.x; n < N; n += SELECT_THREADS)
    inl[(size_t)c * N + n] = inlier(h, pts_w + ((size_t)c * N + n) * 3, uv + 2 * n,
                                    mask[(size_t)c * N + n], cam, thresh);
}

}  // namespace

extern "C" int sspl_pnp_hypotheses(const void* pts_w, const void* uv, const void* sets, int C,
                                   int I, int N, float fx, float fy, float cx, float cy,
                                   void* hyp, void* stream) {
  const int threads = 64;
  const int n = C * I;
  pnp_hypotheses_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pts_w, (const float*)uv, (const int32_t*)sets, C, I, N,
      Cam{fx, fy, cx, cy}, (float*)hyp);
  return (int)cudaGetLastError();
}

extern "C" int sspl_pnp_count(const void* hyp, const void* pts_w, const void* uv,
                              const void* mask, int C, int I, int N, float fx, float fy,
                              float cx, float cy, float thresh, void* counts, void* stream) {
  pnp_count_kernel<<<C * I, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)hyp, (const float*)pts_w, (const float*)uv, (const bool*)mask, I, N,
      Cam{fx, fy, cx, cy}, thresh, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int sspl_pnp_select(const void* hyp, const void* counts, const void* pts_w,
                               const void* uv, const void* mask, int C, int I, int N, float fx,
                               float fy, float cx, float cy, float thresh, void* T_cw,
                               void* inl, void* n_best, void* stream) {
  pnp_select_kernel<<<C, SELECT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)hyp, (const int32_t*)counts, (const float*)pts_w, (const float*)uv,
      (const bool*)mask, I, N, Cam{fx, fy, cx, cy}, thresh, (float*)T_cw, (bool*)inl,
      (int32_t*)n_best);
  return (int)cudaGetLastError();
}
