// Kernel 16: batched Sim(3) RANSAC for loop verification.
//
// Replaces the JAX package's structure_slam_pointline_tpu/optim/
// sim3_solver.py `ransac_sim3` (:81, with `horn_sim3` :35), called by
// models/loop_closing.py `verify` (:402-406): per hypothesis Horn's
// closed-form alignment of three sampled pairs (centroids, the 3x3
// cross-covariance M, Horn's symmetric 4x4 N, its top eigenvector from one
// batched jnp.linalg.eigh), then an [I, N] pass that projects each side's
// points through the candidate into the other camera, and the first-index
// argmax of the counts. Three launches:
//
//   A (sim3_hypotheses): one thread per hypothesis gathers its three pairs
//     and forms the centroids, M and N in float64. It takes N's eigenvector
//     of the largest eigenvalue by cyclic Jacobi, in float64. R is quadratic
//     in the quaternion, so the eigenvector's sign does not matter. Then
//     s = sqrt(sum |q1|^2 / max(sum |q2|^2, 1e-12)) (1 with fix_scale) and
//     t = c1 - s R c2, as sim3_solver.py:61-76. Out: s and [R | t], float32.
//   B (sim3_count): one block per hypothesis counts over the N pairs the
//     points whose forward error (p2 through S12 into camera 1) and inverse
//     error (p1 through S12^-1 into camera 2) are both below the chi2 bound
//     (sim3_solver.py:94-109: the 1e-9 depth guard, the 1e-12 floor of
//     1/s), in float32, each product and sum in the plain version's order.
//   C (sim3_select): one block takes the first index of the largest count,
//     writes S12 = [s R | t], the count and that hypothesis' inlier row.
//
// Bound on the card: operations, and small ones: ~2 x 10^4 float64
// operations per hypothesis in launch A (a 4x4 Jacobi converges in a few
// sweeps), ~60 float32 operations per pair and hypothesis in launch B, over
// I = 128 hypotheses and N = 1024 pairs at the loop-verification shape;
// the 12 KB of inputs sit in L2 after the first block. The three launches
// and their gaps set the time.
//
// Built with -fmad=false.

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

// cyclic Jacobi on a symmetric 4x4 (row-major, in place); V receives the
// eigenvectors as columns
__device__ void jacobi4(double* a, double* V) {
  for (int i = 0; i < 16; ++i) V[i] = (i % 5 == 0) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < 3; ++p) {
      for (int q = p + 1; q < 4; ++q) {
        const double apq = a[p * 4 + q];
        const double app = a[p * 4 + p], aqq = a[q * 4 + q];
        if (fabs(apq) <= 1e-300 || fabs(apq) <= 1e-17 * sqrt(fabs(app * aqq))) continue;
        rotated = true;
        const double theta = (aqq - app) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 4; ++k) {
          const double akp = a[k * 4 + p], akq = a[k * 4 + q];
          a[k * 4 + p] = c * akp - s * akq;
          a[k * 4 + q] = s * akp + c * akq;
        }
        for (int k = 0; k < 4; ++k) {
          const double apk = a[p * 4 + k], aqk = a[q * 4 + k];
          a[p * 4 + k] = c * apk - s * aqk;
          a[q * 4 + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 4; ++k) {
          const double vkp = V[k * 4 + p], vkq = V[k * 4 + q];
          V[k * 4 + p] = c * vkp - s * vkq;
          V[k * 4 + q] = s * vkp + c * vkq;
        }
      }
    }
    if (!rotated) break;
  }
}

__global__ void hypotheses_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                                  const int32_t* __restrict__ sets, int I, int fix_scale,
                                  float* __restrict__ scale, float* __restrict__ hyp) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= I) return;
  double a[3][3], b[3][3];
  for (int m = 0; m < 3; ++m) {
    const int n = sets[3 * h + m];
    for (int j = 0; j < 3; ++j) {
      a[m][j] = p1[3 * (size_t)n + j];
      b[m][j] = p2[3 * (size_t)n + j];
    }
  }
  double c1[3], c2[3];
  for (int j = 0; j < 3; ++j) {
    c1[j] = (a[0][j] + a[1][j] + a[2][j]) / 3.0;
    c2[j] = (b[0][j] + b[1][j] + b[2][j]) / 3.0;
  }
  double M[3][3] = {};
  double n1 = 0.0, n2 = 0.0;
  for (int m = 0; m < 3; ++m) {
    double q1[3], q2[3];
    for (int j = 0; j < 3; ++j) {
      q1[j] = a[m][j] - c1[j];
      q2[j] = b[m][j] - c2[j];
      n1 += q1[j] * q1[j];
      n2 += q2[j] * q2[j];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) M[i][j] += q2[i] * q1[j];   // maps 2 -> 1
  }
  const double Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const double Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const double Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  double N[16] = {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
                  Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
                  Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
                  Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz};
  double V[16];
  jacobi4(N, V);
  int kmax = 0;
  for (int k = 1; k < 4; ++k)
    if (N[k * 5] > N[kmax * 5]) kmax = k;
  double q[4];
  double nrm = 0.0;
  for (int r = 0; r < 4; ++r) {
    q[r] = V[r * 4 + kmax];
    nrm += q[r] * q[r];
  }
  nrm = 1.0 / sqrt(nrm);
  const double w = q[0] * nrm, x = q[1] * nrm, y = q[2] * nrm, z = q[3] * nrm;
  const double R[9] = {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                       2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                       2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)};
  const double s = fix_scale ? 1.0 : sqrt(n1 / fmax(n2, 1e-12));
  float* out = hyp + 12 * (size_t)h;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) out[4 * i + j] = (float)R[3 * i + j];
    out[4 * i + 3] =
        (float)(c1[i] - s * (R[3 * i] * c2[0] + R[3 * i + 1] * c2[1] + R[3 * i + 2] * c2[2]));
  }
  scale[h] = (float)s;
}

__device__ __forceinline__ void proj(float x, float y, float z, const Cam& cam, float& u,
                                     float& v) {
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  u = x / zs * cam.fx + cam.cx;
  v = y / zs * cam.fy + cam.cy;
}

// both reprojection tests of pair n under hypothesis (s, [R | t])
__device__ __forceinline__ bool pair_ok(const float* __restrict__ p1,
                                        const float* __restrict__ p2, const bool* __restrict__ mask,
                                        float s, const float* H, int n, const Cam& cam,
                                        float th1, float th2) {
  if (!mask[n]) return false;
  const float* a = p1 + 3 * (size_t)n;
  const float* b = p2 + 3 * (size_t)n;
  float u1, v1, u2, v2;
  proj(a[0], a[1], a[2], cam, u1, v1);
  proj(b[0], b[1], b[2], cam, u2, v2);
  // p2 through S12: (s R) p2 + t
  float q[3];
  for (int i = 0; i < 3; ++i)
    q[i] = s * H[4 * i] * b[0] + s * H[4 * i + 1] * b[1] + s * H[4 * i + 2] * b[2] + H[4 * i + 3];
  float u, v;
  proj(q[0], q[1], q[2], cam, u, v);
  const float e1 = (u - u1) * (u - u1) + (v - v1) * (v - v1);
  // p1 through S12^-1: (R^T / s) (p1 - t)
  const float si = 1.f / fmaxf(s, 1e-12f);
  const float d[3] = {a[0] - H[3], a[1] - H[7], a[2] - H[11]};
  for (int i = 0; i < 3; ++i)
    q[i] = si * H[i] * d[0] + si * H[4 + i] * d[1] + si * H[8 + i] * d[2] + 0.f;
  proj(q[0], q[1], q[2], cam, u, v);
  const float e2 = (u - u2) * (u - u2) + (v - v2) * (v - v2);
  return e1 < th1 && e2 < th2;
}

__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
             const bool* __restrict__ mask, const float* __restrict__ scale,
             const float* __restrict__ hyp, int N, Cam cam, float th1, float th2,
             int32_t* __restrict__ counts) {
  __shared__ int red[COUNT_THREADS / 32];
  const int h = blockIdx.x;
  float H[12];
  for (int q = 0; q < 12; ++q) H[q] = hyp[12 * (size_t)h + q];
  const float s = scale[h];
  int c = 0;
  for (int n = threadIdx.x; n < N; n += COUNT_THREADS)
    c += pair_ok(p1, p2, mask, s, H, n, cam, th1, th2) ? 1 : 0;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < COUNT_THREADS / 32; ++w) t += red[w];
    counts[h] = t;
  }
}

__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
              const bool* __restrict__ mask, const float* __restrict__ scale,
              const float* __restrict__ hyp, const int32_t* __restrict__ counts, int I, int N,
              Cam cam, float th1, float th2, float* __restrict__ S12, bool* __restrict__ inl,
              int32_t* __restrict__ n_best) {
  __shared__ int best_s;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int h = 1; h < I; ++h)
      if (counts[h] > counts[b]) b = h;
    best_s = b;
  }
  __syncthreads();
  const int b = best_s;
  float H[12];
  for (int q = 0; q < 12; ++q) H[q] = hyp[12 * (size_t)b + q];
  const float s = scale[b];
  for (int n = threadIdx.x; n < N; n += SELECT_THREADS)
    inl[n] = pair_ok(p1, p2, mask, s, H, n, cam, th1, th2);
  if (threadIdx.x < 16) {
    const int i = threadIdx.x / 4, j = threadIdx.x % 4;
    float v;
    if (i == 3) v = j == 3 ? 1.f : 0.f;
    else v = j == 3 ? H[4 * i + 3] : s * H[4 * i + j];
    S12[threadIdx.x] = v;
  }
  if (threadIdx.x == 0) n_best[0] = counts[b];
}

}  // namespace

extern "C" int sspl_sim3_hypotheses(const void* p1, const void* p2, const void* sets, int I,
                                    int fix_scale, void* scale, void* hyp, void* stream) {
  hypotheses_kernel<<<(I + 63) / 64, 64, 0, (cudaStream_t)stream>>>(
      (const float*)p1, (const float*)p2, (const int32_t*)sets, I, fix_scale, (float*)scale,
      (float*)hyp);
  return (int)cudaGetLastError();
}

extern "C" int sspl_sim3_count(const void* p1, const void* p2, const void* mask,
                               const void* scale, const void* hyp, int I, int N, float fx,
                               float fy, float cx, float cy, float th1, float th2,
                               void* counts, void* stream) {
  count_kernel<<<I, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)p1, (const float*)p2, (const bool*)mask, (const float*)scale,
      (const float*)hyp, N, Cam{fx, fy, cx, cy}, th1, th2, (int32_t*)counts);
  return (int)cudaGetLastError();
}

extern "C" int sspl_sim3_select(const void* p1, const void* p2, const void* mask,
                                const void* scale, const void* hyp, const void* counts, int I,
                                int N, float fx, float fy, float cx, float cy, float th1,
                                float th2, void* S12, void* inl, void* n_best, void* stream) {
  select_kernel<<<1, SELECT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)p1, (const float*)p2, (const bool*)mask, (const float*)scale,
      (const float*)hyp, (const int32_t*)counts, I, N, Cam{fx, fy, cx, cy}, th1, th2,
      (float*)S12, (bool*)inl, (int32_t*)n_best);
  return (int)cudaGetLastError();
}
