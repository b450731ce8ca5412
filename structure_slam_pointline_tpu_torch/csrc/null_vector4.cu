// Kernel 10: unit null vectors of stacked [r, 4] systems by a fixed-sweep
// cyclic Jacobi on the 4x4 Gram matrix, one system per thread.
//
// Replaces the JAX package's structure_slam_pointline_tpu/utils/linalg.py
// `null_vector_4` (:108, with `jacobi_eigh_4x4`'s sweep, :17-89). A second
// entry, `sspl_jacobi_eigh4` (counted apart as `jacobi_eigh4`), replaces
// `jacobi_eigh_4x4` (:89-105): the same sweeps on [N, 4, 4] matrices as
// given (all 16 entries, as the reference reads them), returning the
// unsorted diagonal and the eigenvector columns. The
// reference keeps the 16 entries of every system as separate [N] vectors,
// so each rotation is a few dozen whole-array passes on the TPU's vector
// unit (~hundreds of torch ops per call as plain torch). Here one thread
// holds its system's Gram matrix and eigenvector matrix in registers and
// runs every sweep without leaving them: the Gram sums in row order, five
// sweeps of the six (p, q) rotations in the reference's order and
// formulas, then the smallest eigenvalue's column by pairwise strict
// minima (ties keep the first column).
//
// Numerics: the plain version (utils/linalg.py) is a chain of float32
// torch ops, each rounded on its own, and torch's CUDA atan2 / cos / sin
// are the CUDA math library's atan2f / cosf / sinf built with nvcc's
// default -fmad=true. So this file is built with -fmad=true (kernels.py),
// for the math library to compile as it does inside torch, and every
// product and sum of the formulas below goes through the __fmul_rn /
// __fadd_rn / __fsub_rn intrinsics, which are never fused, so each rounds
// exactly where the plain version's op does.
//
// Bound on the card: operations, ~2,000 per system (the Gram, 30
// rotations with one atan2f, cosf and sinf each), against 64 B read and
// 16 B written per [4, 4] system.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <int P, int Q>
__device__ __forceinline__ void rotate(float (&m)[4][4], float (&V)[4][4]) {
  const float app = m[P][P], aqq = m[Q][Q], apq = m[P][Q];
  const float theta = mul(0.5f, atan2f(mul(2.0f, apq), sub(app, aqq)));
  const float c = cosf(theta);
  const float s = sinf(theta);
  const float cc = mul(c, c), ss = mul(s, s), sc = mul(s, c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    const float mrp = m[r][P], mrq = m[r][Q];
    m[r][P] = add(mul(c, mrp), mul(s, mrq));
    m[r][Q] = sub(mul(c, mrq), mul(s, mrp));
    m[P][r] = m[r][P];
    m[Q][r] = m[r][Q];
  }
  const float sc2 = mul(2.0f, sc);
  m[P][P] = add(add(mul(cc, app), mul(sc2, apq)), mul(ss, aqq));
  m[Q][Q] = add(sub(mul(ss, app), mul(sc2, apq)), mul(cc, aqq));
  m[P][Q] = m[Q][P] = add(mul(sub(cc, ss), apq), mul(sc, sub(aqq, app)));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float vrp = V[r][P], vrq = V[r][Q];
    V[r][P] = add(mul(c, vrp), mul(s, vrq));
    V[r][Q] = sub(mul(c, vrq), mul(s, vrp));
  }
}

// `sweeps` cyclic sweeps over the six (p, q) pairs in the reference's order
__device__ __forceinline__ void jacobi(float (&m)[4][4], float (&V)[4][4], int sweeps) {
  for (int sw = 0; sw < sweeps; ++sw) {
    rotate<0, 1>(m, V);
    rotate<0, 2>(m, V);
    rotate<0, 3>(m, V);
    rotate<1, 2>(m, V);
    rotate<1, 3>(m, V);
    rotate<2, 3>(m, V);
  }
}

__global__ void null_vector4_kernel(const float* __restrict__ A, int N, int r,
                                    int sweeps, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* a = A + (size_t)n * r * 4;
  float m[4][4], V[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float s = mul(a[i], a[j]);
      for (int q = 1; q < r; ++q) s = add(s, mul(a[4 * q + i], a[4 * q + j]));
      m[i][j] = m[j][i] = s;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) V[i][j] = i == j ? 1.f : 0.f;
  jacobi(m, V, sweeps);
  float best_val = m[0][0];
  float best[4] = {V[0][0], V[1][0], V[2][0], V[3][0]};
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (m[j][j] < best_val) {
      best_val = m[j][j];
#pragma unroll
      for (int q = 0; q < 4; ++q) best[q] = V[q][j];
    }
  }
  float4 o = make_float4(best[0], best[1], best[2], best[3]);
  reinterpret_cast<float4*>(out)[n] = o;
}

__global__ void jacobi_eigh4_kernel(const float* __restrict__ M, int N, int sweeps,
                                    float* __restrict__ vals, float* __restrict__ vecs) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* a = M + (size_t)n * 16;
  float m[4][4], V[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[i][j] = a[4 * i + j];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  jacobi(m, V, sweeps);
  reinterpret_cast<float4*>(vals)[n] = make_float4(m[0][0], m[1][1], m[2][2], m[3][3]);
  float4* v = reinterpret_cast<float4*>(vecs) + (size_t)n * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = make_float4(V[i][0], V[i][1], V[i][2], V[i][3]);
}

}  // namespace

extern "C" int sspl_jacobi_eigh4(const void* M, int N, int sweeps, void* vals, void* vecs,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    jacobi_eigh4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)M, N, sweeps, (float*)vals, (float*)vecs);
  return (int)cudaGetLastError();
}

extern "C" int sspl_null_vector4(const void* A, int N, int r, int sweeps, void* out,
                                 void* stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    null_vector4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)A, N, r, sweeps, (float*)out);
  return (int)cudaGetLastError();
}
