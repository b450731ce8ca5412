// Kernel 9: observer bitmasks from the keyframe-major edge grid, and the
// keyframe votes of matched local-map rows.
//
// Replaces the JAX package's structure_slam_pointline_tpu/world/map_store.py
// `compute_obs_bits` (:235, a uint32 scatter-add of 2^(k mod 32) into word
// k // 32 of row e over the [K, F] grid) and `votes_from_bits` (:253, the
// bits unpacked to a [M, K] 0/1 matrix and one bf16 MXU matvec with the
// matched mask).
//
// obs_bits: one thread per (keyframe, feature) edge of the [K, F] grid;
// an edge with e >= 0 does a 32-bit unsigned atomicAdd of 1 << (k & 31)
// into word k >> 5 of row e, and e < 0 (or e >= P) is dropped. It ADDS, as
// the reference does (`.at[].add`): add equals OR only while a keyframe row
// binds each landmark once, and with a duplicated (k, e) pair both carry
// into the next bit, mod 2^32, exactly as the reference's uint32 add.
// Integer adds commute, so the result does not depend on the order in
// which the atomics land. The output is zeroed by the wrapper.
//
// votes_from_bits: one warp per keyframe column k; the lanes stride over
// the M rows, add bit k of matched rows, and a shuffle tree sums the lane
// counts; invalid keyframes get 0. Integer sums: exact, like the
// reference's float32 accumulation of 0/1 products below 2^24.
//
// Bound on the card: bytes. obs_bits reads the [K, F] int32 grid once
// (2 MB at 256 x 2048) and writes the [P, K/32] words (1 MB at 32768 x
// 8); votes reads [M, K/32] words (64 KB at 2048 x 8) once per column
// warp, from L2 after the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void obs_bits_kernel(const int32_t* __restrict__ kf_kp_mp, int K, int F,
                                int P, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * F) return;
  const int e = kf_kp_mp[i];
  if (e < 0 || e >= P) return;
  const int k = (int)(i / F);
  const int KW = (K + 31) >> 5;
  atomicAdd(out + (size_t)e * KW + (k >> 5), 1u << (k & 31));
}

__global__ void votes_kernel(const uint32_t* __restrict__ rows,
                             const bool* __restrict__ matched,
                             const bool* __restrict__ kf_valid, int M, int KW, int K,
                             int32_t* __restrict__ votes) {
  const int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  const int word = k >> 5, bit = k & 31;
  int c = 0;
  for (int m = lane; m < M; m += 32)
    if (matched[m]) c += (rows[(size_t)m * KW + word] >> bit) & 1u;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
  if (lane == 0) votes[k] = kf_valid[k] ? c : 0;
}

}  // namespace

extern "C" int sspl_obs_bits(const void* kf_kp_mp, int K, int F, int P, void* out,
                             void* stream) {
  const long long n = (long long)K * F;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  if (blocks > 0)
    obs_bits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)kf_kp_mp, K, F, P, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int sspl_votes_from_bits(const void* rows, const void* matched,
                                    const void* kf_valid, int M, int KW, int K,
                                    void* votes, void* stream) {
  const int warps = 8;
  const int blocks = (K + warps - 1) / warps;
  if (blocks > 0)
    votes_kernel<<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, (const bool*)matched, (const bool*)kf_valid, M, KW, K,
        (int32_t*)votes);
  return (int)cudaGetLastError();
}
