// Kernel 15: batched RANSAC PnP over the relocalization candidates.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/pnp.py
// `ransac_pnp` (:34), vmapped over the candidates at
// models/relocalization.py:62: per hypothesis a 6-point DLT whose null
// vector comes from one batched [I, 12, 12] jnp.linalg.svd, R from the SVD
// of the 3x3 block with a det fix, t by the mean singular value, a
// cheirality sign flip over the six points, then one [I, N] reprojection
// pass and the first-index argmax. Two launches:
//
//   A (pnp_hypotheses): one warp per (candidate, hypothesis), WARPS warps
//     a block. The lanes form the 12x12 Gram A^T A of the DLT directly
//     from the six sampled points (A's entries made on the fly, never
//     stored; rows summed in order 0..11), in float64 (float32 A^T A would
//     square the condition number), in the warp's slice of shared memory.
//     Its eigenvector of the smallest eigenvalue comes from a parallel
//     cyclic Jacobi in float64: round-robin order, 6 disjoint (p, q) pairs
//     a step and 11 steps a sweep; lanes 0-5 take the step's rotations
//     from the matrix as it stood, then each of 21 lanes applies J^T a J
//     to one 2x2 block of the step's 6 x 6 grid of pair blocks (columns,
//     then rows; the upper triangle's blocks, mirrored), and the lanes
//     rotate V's column pairs: one __syncwarp a step. The skip test
//     (|apq| <= 1e-17 sqrt(|app aqq|)) and the 30-sweep cap are the
//     serial Jacobi's. Lane 0 then does the rest of the hypothesis in
//     order: the null vector's sign normalized so that det(P[:, :3]) > 0
//     (the port's one departure from the reference, whose SVD may return
//     either sign; see ops/pnp.py), R the orthonormal factor of M =
//     P[:, :3] (with det M > 0 the reference's det fix leaves R = U V^T,
//     taken from the eigenpairs of M^T M: u_i = M v_i / s_i for the two
//     largest, u_3 = det(V) u_1 x u_2, so R does not depend on the signs an
//     SVD routine picks), scale = mean singular value, t = P[:, 3] /
//     scale, and the flip when the six points' depth signs sum below zero
//     (pnp.py:62-73); out: [R | t] as float32. The same warp then scores
//     it: the lanes go over the N points in float32, the plain version's
//     order of operations (err <= CHI2_2D * sigma2, zc > 0, the mask;
//     pnp.py:76-83), and a shuffle reduction gives the count.
//   B (pnp_select): one block per candidate takes the first index of the
//     largest count, writes T_cw, the count and that hypothesis' inlier row.
//
// Bound on the card: operations, float64. A hypothesis needs at least a
// 12x12 null vector (elimination, ~1,300 float64 operations); the Jacobi
// here runs sweeps of 11 steps until no pair rotates, each step a chain of
// a square root, a division and a reciprocal square root for the
// rotations, then the block and V updates, so a warp is latency-bound and,
// at thousands of hypotheses, an SM issue-bound. A warp per hypothesis
// keeps the matrix in shared memory (2.3 KB a warp) instead of one
// thread's 3.4 KB stack, and at 64 registers a thread (4 blocks an SM) the
// 4096 hypotheses of the relocalization shape run in one wave. That cap
// costs spills: ptxas reports a 272-byte stack frame, 252 B of spill
// stores and 204 B of loads for launch A. At 3 blocks an SM (~85
// registers) they fall to 112 / 96 B, but 4096 hypotheses take two waves
// and the launch is ~1.2x slower (tools/kernel_ab.py). The scoring reads
// 12 B per point and hypothesis from L1/L2. Built with -fmad=false, so the float32
// scoring rounds each product and sum as the torch ops do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // hypotheses per block of launch A
constexpr int SELECT_THREADS = 256;
constexpr int MAX_SWEEPS = 30;
constexpr unsigned FULL = 0xffffffffu;

struct Cam {
  float fx, fy, cx, cy;
};

// eigen-decomposition of a symmetric n x n matrix (row-major, in place) by
// cyclic Jacobi in one thread; V receives the eigenvectors as columns
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

// the step-r pair of slot i (r = 0..10, i = 0..5) of the round-robin
// ordering of 12 indices: {11, r} and {r + i, r - i} mod 11; every pair
// once in 11 steps, the six pairs of a step disjoint
__device__ __forceinline__ void rr_pair(int r, int i, int& p, int& q) {
  const int a = i == 0 ? 11 : (r + i) % 11;
  const int b = i == 0 ? r : (r + 11 - i) % 11;
  p = min(a, b);
  q = max(a, b);
}

// the 21 blocks (bi <= bj) of the upper triangle of a 6 x 6 block grid
__constant__ int c_blk[21][2] = {{0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {1, 1},
                                 {1, 2}, {1, 3}, {1, 4}, {1, 5}, {2, 2}, {2, 3}, {2, 4},
                                 {2, 5}, {3, 3}, {3, 4}, {3, 5}, {4, 4}, {4, 5}, {5, 5}};

// entry (r, col) of the 12x12 DLT (pnp.py:55-57): row k [0, -Xh, v Xh],
// row 6 + k [Xh, 0, -u Xh]
__device__ __forceinline__ double dlt(const double (*X)[4], const double (*xn)[2], int r,
                                      int col) {
  const int k = r % 6, blk = col >> 2;
  const double x = X[k][col & 3];
  if (r < 6) return blk == 0 ? 0.0 : (blk == 1 ? -x : xn[k][1] * x);
  return blk == 0 ? x : (blk == 1 ? 0.0 : -xn[k][0] * x);
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

// lane 0: [R | t] (float32, row-major 3x4) from the Jacobi result
__device__ void pose_from_null(const double* a, const double* V, const double (*X)[4],
                               float* out) {
  int kmin = 0;
  for (int k = 1; k < 12; ++k)
    if (a[k * 12 + k] < a[kmin * 12 + kmin]) kmin = k;
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
  for (int a2 = 0; a2 < 2; ++a2)
    for (int b = a2 + 1; b < 3; ++b)
      if (S[ord[b] * 4] > S[ord[a2] * 4]) {
        const int tmp = ord[a2];
        ord[a2] = ord[b];
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
  const double t[3] = {P[3] / scale, P[7] / scale, P[11] / scale};
  double zs = 0.0;
  for (int k = 0; k < 6; ++k) {
    const double z = R[6] * X[k][0] + R[7] * X[k][1] + R[8] * X[k][2] + t[2];
    zs += (z > 0.0) - (z < 0.0);
  }
  const double f = zs < 0.0 ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) out[r * 4 + j] = (float)(f * R[r * 3 + j]);
    out[r * 4 + 3] = (float)(f * t[r]);
  }
}

__global__ void __launch_bounds__(WARPS * 32, 4)
pnp_hypotheses_kernel(const float* __restrict__ pts_w, const float* __restrict__ uv,
                      const int32_t* __restrict__ sets, const bool* __restrict__ mask, int C,
                      int I, int N, Cam cam, float thresh, float* __restrict__ hyp,
                      int32_t* __restrict__ counts) {
  __shared__ double s_a[WARPS][144];
  __shared__ double s_v[WARPS][144];
  __shared__ double s_x[WARPS][6][4];   // the six points, homogeneous
  __shared__ double s_xn[WARPS][6][2];  // their normalized pixels (float32 -> float64)
  __shared__ float s_h[WARPS][12];
  __shared__ int8_t s_pq[11][6][2];  // the round-robin pairs (p, q) of step r, slot i
  if (threadIdx.x < 66) {
    int p, q;
    rr_pair(threadIdx.x / 6, threadIdx.x % 6, p, q);
    s_pq[threadIdx.x / 6][threadIdx.x % 6][0] = (int8_t)p;
    s_pq[threadIdx.x / 6][threadIdx.x % 6][1] = (int8_t)q;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= C * I) return;  // whole warps: the block does not synchronize again
  const int c = g / I;
  double* a = s_a[warp];
  double* V = s_v[warp];
  if (lane < 6) {
    const int n = sets[(size_t)g * 6 + lane];
    const float* p = pts_w + ((size_t)c * N + n) * 3;
    s_xn[warp][lane][0] = (uv[2 * n] - cam.cx) / cam.fx;
    s_xn[warp][lane][1] = (uv[2 * n + 1] - cam.cy) / cam.fy;
    s_x[warp][lane][0] = p[0];
    s_x[warp][lane][1] = p[1];
    s_x[warp][lane][2] = p[2];
    s_x[warp][lane][3] = 1.0;
  }
  __syncwarp();
  for (int e = lane; e < 144; e += 32) {
    const int i = e / 12, j = e % 12;
    double acc = 0.0;
    for (int r = 0; r < 12; ++r)
      acc += dlt(s_x[warp], s_xn[warp], r, i) * dlt(s_x[warp], s_xn[warp], r, j);
    a[e] = acc;
    V[e] = i == j ? 1.0 : 0.0;
  }
  __syncwarp();

  // lane l < 21 owns upper block l of the step's 6 x 6 grid of 2x2 blocks
  // (rows of pair bi, columns of pair bj, bi <= bj)
  const int bi = c_blk[lane < 21 ? lane : 0][0], bj = c_blk[lane < 21 ? lane : 0][1];
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < 11; ++r) {
      // lanes 0-5: the rotation of pair `lane`, the identity when skipped
      double cs = 1.0, sn = 0.0;
      bool rot = false;
      if (lane < 6) {
        const int p = s_pq[r][lane][0], q = s_pq[r][lane][1];
        const double apq = a[p * 12 + q];
        const double app = a[p * 12 + p], aqq = a[q * 12 + q];
        rot = !(fabs(apq) <= 1e-300 || fabs(apq) <= 1e-17 * sqrt(fabs(app * aqq)));
        if (rot) {
          // the serial Jacobi's t = sign(theta) / (|theta| + sqrt(theta^2 +
          // 1)), theta = d / (2 apq), with numerator and denominator times
          // |2 apq|: one square root, one division and one reciprocal
          // square root in a row instead of three divisions and two roots
          const double d = aqq - app, two = 2.0 * apq;
          const double t = (d >= 0.0 ? two : -two) / (fabs(d) + sqrt(d * d + two * two));
          cs = rsqrt(t * t + 1.0);
          sn = t * cs;
        }
      }
      if (__ballot_sync(FULL, rot) == 0) continue;
      rotated = true;
      __syncwarp();
      // a <- J^T a J, a 2x2 block per lane: its columns by pair bj's
      // rotation, then its rows by pair bi's; mirrored below the diagonal
      const double ci = __shfl_sync(FULL, cs, bi), si = __shfl_sync(FULL, sn, bi);
      const double cj = __shfl_sync(FULL, cs, bj), sj = __shfl_sync(FULL, sn, bj);
      if (lane < 21) {
        const int pi = s_pq[r][bi][0], qi = s_pq[r][bi][1];
        const int pj = s_pq[r][bj][0], qj = s_pq[r][bj][1];
        const double b00 = a[pi * 12 + pj], b01 = a[pi * 12 + qj];
        const double b10 = a[qi * 12 + pj], b11 = a[qi * 12 + qj];
        const double x00 = cj * b00 - sj * b01, x01 = sj * b00 + cj * b01;
        const double x10 = cj * b10 - sj * b11, x11 = sj * b10 + cj * b11;
        const double y00 = ci * x00 - si * x10, y01 = ci * x01 - si * x11;
        const double y10 = si * x00 + ci * x10, y11 = si * x01 + ci * x11;
        a[pi * 12 + pj] = y00;
        a[pi * 12 + qj] = y01;
        a[qi * 12 + pj] = y10;
        a[qi * 12 + qj] = y11;
        if (bi != bj) {
          a[pj * 12 + pi] = y00;
          a[qj * 12 + pi] = y01;
          a[pj * 12 + qi] = y10;
          a[qj * 12 + qi] = y11;
        }
      }
      // V <- V J: entry e = 6 k + j is row k, columns of pair j
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int e = lane + 32 * m, j = e % 6;
        const double cv = __shfl_sync(FULL, cs, j), sv = __shfl_sync(FULL, sn, j);
        if (e < 72) {
          const int p = s_pq[r][j][0], q = s_pq[r][j][1];
          const int k = e / 6;
          const double vkp = V[k * 12 + p], vkq = V[k * 12 + q];
          V[k * 12 + p] = cv * vkp - sv * vkq;
          V[k * 12 + q] = sv * vkp + cv * vkq;
        }
      }
      __syncwarp();
    }
    if (!rotated) break;
  }

  float* h = s_h[warp];
  if (lane == 0) {
    pose_from_null(a, V, s_x[warp], h);
    float* out = hyp + (size_t)g * 12;
    for (int k = 0; k < 12; ++k) out[k] = h[k];
  }
  __syncwarp();
  int cnt = 0;
  for (int n = lane; n < N; n += 32)
    cnt += inlier(h, pts_w + ((size_t)c * N + n) * 3, uv + 2 * n, mask[(size_t)c * N + n],
                  cam, thresh);
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL, cnt, off);
  if (lane == 0) counts[g] = cnt;
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

extern "C" int sspl_pnp_hypotheses(const void* pts_w, const void* uv, const void* sets,
                                   const void* mask, int C, int I, int N, float fx, float fy,
                                   float cx, float cy, float thresh, void* hyp, void* counts,
                                   void* stream) {
  const int blocks = (C * I + WARPS - 1) / WARPS;
  pnp_hypotheses_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)pts_w, (const float*)uv, (const int32_t*)sets, (const bool*)mask, C, I, N,
      Cam{fx, fy, cx, cy}, thresh, (float*)hyp, (int32_t*)counts);
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
