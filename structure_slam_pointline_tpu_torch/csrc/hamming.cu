// Kernel 3: masked Hamming best / second-best per row, one warp per row.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/hamming.py
// `hamming_matrix` (:32, descriptors unpacked to +-1 int8 and one MXU
// matmul) together with the row reductions of ops/matching.py
// `masked_match` (:35: argmin, one-hot re-mask, second argmin). Here the
// [M, N] int32 distance matrix is never written: each warp owns a query
// row, its lanes stride over the columns with XOR + popcount of the 8
// words, fold every candidate into a per-lane top-2 of (value, column)
// pairs, and a shuffle tree merges the 32 lists. Column descriptors are
// staged through shared memory in chunks shared by the block's 8 rows.
//
// Semantics are the reference's exactly, including ties and empty rows:
//   d_j = allow ? popcount(a ^ b_j) : 1 << 20
//   best_j = first argmin d, best = d[best_j]
//   d'_j = d_j (j != best_j), best + 2^20 (j == best_j)
//   second_j = first argmin d', second = d'[second_j]
// The lists and the re-mask live in csrc/top2.cuh, shared with kernel 22:
// comparing (value, index) pairs everywhere keeps jnp.argmin's first-index
// rule; second is the smaller of the runner-up pair and
// (best + 2^20, best_j), which covers rows with fewer than two columns.
//
// Bound on the card: operations, narrowly. Each (row, column) pair costs
// ~27 integer ops on the CUDA cores (0.4 ps at 67 T/s) against one byte
// of candidate mask (0.3 ps at 3.35 TB/s); descriptors add 32 B per row
// and column. Batched calls ([B, M, N], the keyframe pipeline's neighbour
// and fuse directions) are one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "top2.cuh"

namespace {

constexpr int ROWS = 8;     // warps (rows) per block
constexpr int CHUNK = 512;  // columns staged per pass
constexpr int BIG = top2::BIG;

__global__ void hamming_best2_kernel(const int32_t* __restrict__ A,
                                     const int32_t* __restrict__ Bd,
                                     const uint8_t* __restrict__ allow,
                                     int M, int N, int batch_a, int batch_b,
                                     int32_t* __restrict__ best,
                                     int32_t* __restrict__ best_j,
                                     int32_t* __restrict__ second,
                                     int32_t* __restrict__ second_j) {
  __shared__ uint4 bs[CHUNK][2];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS + warp;
  const bool row_ok = m < M;
  const int32_t* arow = A + ((size_t)(batch_a ? b : 0) * M + (row_ok ? m : 0)) * 8;
  const int32_t* bcol = Bd + (size_t)(batch_b ? b : 0) * N * 8;
  const uint8_t* mrow = allow + ((size_t)b * M + (row_ok ? m : 0)) * N;
  uint32_t a[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) a[w] = (uint32_t)arow[w];

  top2::Top2 t = top2::empty();
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    const int nc = min(CHUNK, N - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      const uint4* src = reinterpret_cast<const uint4*>(bcol + (size_t)(c0 + i) * 8);
      bs[i][0] = src[0];
      bs[i][1] = src[1];
    }
    __syncthreads();
    if (!row_ok) continue;
    for (int i = lane; i < nc; i += 32) {
      const int j = c0 + i;
      int d = BIG;
      if (mrow[j]) {
        uint4 p = bs[i][0], q = bs[i][1];
        d = __popc(a[0] ^ p.x) + __popc(a[1] ^ p.y) + __popc(a[2] ^ p.z) +
            __popc(a[3] ^ p.w) + __popc(a[4] ^ q.x) + __popc(a[5] ^ q.y) +
            __popc(a[6] ^ q.z) + __popc(a[7] ^ q.w);
      }
      top2::push(t, d, j);
    }
  }
  if (!row_ok) return;
  top2::warp_merge(t);
  if (lane == 0) {
    const size_t o = (size_t)b * M + m;
    int sv, sj;
    top2::finish(t, sv, sj);  // the best column, re-masked
    best[o] = t.v0;
    best_j[o] = t.j0;
    second[o] = sv;
    second_j[o] = sj;
  }
}

}  // namespace

extern "C" int sspl_hamming_best2(const void* a, const void* b, const void* allow,
                                  int B, int M, int N, int batch_a, int batch_b,
                                  void* best, void* best_j, void* second,
                                  void* second_j, void* stream) {
  dim3 grid((M + ROWS - 1) / ROWS, B);
  hamming_best2_kernel<<<grid, ROWS * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const uint8_t*)allow, M, N, batch_a,
      batch_b, (int32_t*)best, (int32_t*)best_j, (int32_t*)second,
      (int32_t*)second_j);
  return (int)cudaGetLastError();
}
