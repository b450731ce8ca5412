// Kernels 13 and 14: the BoW vocabulary-tree transform and the keyframe
// database score.
//
// Kernel 13 (`sspl_bow_transform`) replaces the JAX package's
// structure_slam_pointline_tpu/ops/bow.py `_transform_impl` (:104, one
// Hamming matrix against each node's children per level, then argmin) and
// `transform` (:118, the word histogram normalized by its total). One block
// per descriptor set (a keyframe or the query frame): each thread walks its
// descriptors down the tree, comparing (distance, child) pairs so the first
// child wins a tie as jnp.argmin's does (distances are small integers and
// ties are common), counts the word in a shared-memory histogram (integer
// atomics, so the order does not matter), and the block then writes
// counts / total for every word. Counts and total are integers below 2^24,
// exact in float32, and the division is one IEEE division (__fdiv_rn):
// words and vectors equal the reference's bit for bit. Invalid descriptors
// get word -1 and stay out of the histogram (mode="drop" at :122).
//
// Kernel 14 (`sspl_bow_query`) replaces `l1_score` / `query_database`
// (:129-144): s_k = 1 - 0.5 * sum_w |q_w - b_kw|, then the kf_valid,
// exclude and min_score masks. One block per keyframe row; thread t adds
// words t, t + 256, ... in order, then a halving tree in shared memory adds
// the 256 partial sums. The plain version (ops/bow.query_database_plain)
// sums in this same order, so the two agree exactly.
//
// Bound on the card: bytes for both. The transform reads 32 B per
// descriptor and 2 KB of node rows per level, and writes 4 B per word of
// the vector (16 KB per set at 4096 words), against ~100 integer ops per
// descriptor and level; the query reads the [K, W] float32 index once.
// Built with -fmad=false (kernels.py), so no product and sum are fused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TRANSFORM_THREADS = 256;
constexpr int QUERY_THREADS = 256;
constexpr int MAX_WORDS = 8192;     // shared histogram (32 KB)
constexpr int MAX_BRANCHING = 16;

__global__ void __launch_bounds__(TRANSFORM_THREADS)
bow_transform_kernel(const uint32_t* __restrict__ nodes, int branching, int depth,
                     const uint32_t* __restrict__ desc, const bool* __restrict__ valid,
                     int N, int32_t* __restrict__ words, float* __restrict__ bow) {
  __shared__ int hist[MAX_WORDS];
  __shared__ int total;
  int W = 1;
  for (int l = 0; l < depth; ++l) W *= branching;
  const int b = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) hist[w] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const size_t row = (size_t)b * N + i;
    uint32_t d[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) d[w] = desc[row * 8 + w];
    int node = 0, off = 0, width = 1;
    for (int l = 0; l < depth; ++l) {
      const uint32_t* cen = nodes + ((size_t)(off + node) * branching) * 8;
      int best = 1 << 30, child = 0;
      for (int c = 0; c < branching; ++c) {
        int dist = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) dist += __popc(d[w] ^ cen[c * 8 + w]);
        if (dist < best) {   // strict: the first child keeps a tie
          best = dist;
          child = c;
        }
      }
      node = node * branching + child;
      off += width;
      width *= branching;
    }
    const bool ok = valid[row];
    words[row] = ok ? node : -1;
    if (ok) {
      atomicAdd(&hist[node], 1);
      atomicAdd(&total, 1);
    }
  }
  __syncthreads();
  const float tot = fmaxf((float)total, 1e-9f);
  float* out = bow + (size_t)b * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) out[w] = __fdiv_rn((float)hist[w], tot);
}

__global__ void __launch_bounds__(QUERY_THREADS)
bow_query_kernel(const float* __restrict__ q, const float* __restrict__ kf_bows,
                 const bool* __restrict__ kf_valid, const bool* __restrict__ exclude,
                 int W, float min_score, float* __restrict__ scores) {
  __shared__ float part[QUERY_THREADS];
  const int k = blockIdx.x;
  const float* row = kf_bows + (size_t)k * W;
  float s = 0.f;
  for (int w = threadIdx.x; w < W; w += QUERY_THREADS) s = __fadd_rn(s, fabsf(__fsub_rn(q[w], row[w])));
  part[threadIdx.x] = s;
  __syncthreads();
  for (int h = QUERY_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float sc = __fsub_rn(1.f, __fmul_rn(0.5f, part[0]));
    if (!kf_valid[k] || exclude[k]) sc = -1.f;
    scores[k] = sc >= min_score ? sc : -1.f;
  }
}

}  // namespace

extern "C" int sspl_bow_transform(const void* nodes, int branching, int depth,
                                  const void* desc, const void* valid, int B, int N,
                                  void* words, void* bow, void* stream) {
  int W = 1;
  for (int l = 0; l < depth; ++l) W *= branching;
  if (W > MAX_WORDS || branching > MAX_BRANCHING || branching < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  bow_transform_kernel<<<B, TRANSFORM_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)nodes, branching, depth, (const uint32_t*)desc, (const bool*)valid, N,
      (int32_t*)words, (float*)bow);
  return (int)cudaGetLastError();
}

extern "C" int sspl_bow_query(const void* q, const void* kf_bows, const void* kf_valid,
                              const void* exclude, int K, int W, float min_score,
                              void* scores, void* stream) {
  bow_query_kernel<<<K, QUERY_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kf_bows, (const bool*)kf_valid, (const bool*)exclude, W,
      min_score, (float*)scores);
  return (int)cudaGetLastError();
}
