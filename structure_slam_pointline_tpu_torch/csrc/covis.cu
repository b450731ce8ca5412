// Kernel 24: covisibility counts from the keyframe edge grids.
//
// Replaces the JAX package's structure_slam_pointline_tpu/world/
// map_store.py `covisibility_matrix` (:210: [K, P] and [K, L] indicator
// matrices and their products on the MXU) and `covisibility_weights`
// (:189: a seen-mask of one keyframe's landmarks gathered at every edge).
// Two entries:
//
//   covis_matrix  [K, K] int32 landmarks shared by each pair of valid
//                 keyframes, points and lines, zero diagonal. A launch
//                 builds each landmark's observers as K-bit masks from the
//                 grids (atomicOr: a landmark counts once per keyframe,
//                 as the indicator's set to 1 does; the masks are built
//                 here, not read from mp_obs_bits, which is stale between
//                 keyframe events); a second launch gives each landmark a
//                 thread that adds 1 to C[i, j] and C[j, i] for every pair
//                 of its valid observers (integer atomics: exact, in any
//                 order). Landmarks whose valid flag is off still count, as
//                 in the reference.
//   covis_row     [K] int32 edges of each keyframe whose landmark keyframe
//                 kf_id also observes, points and lines (a feature count:
//                 a repeated id counts twice, as in the reference), 0 at
//                 kf_id and at invalid keyframes. A block per keyframe row
//                 marks kf_id's landmarks in a shared bitmask, then counts
//                 its own row against it.
//
// Integer work: bit-equal to the plain versions (world/map_store.py
// covisibility_matrix_plain / covisibility_weights_plain).
//
// Bound on the card: bytes. The matrix: both edge grids read, the [K, K]
// counts written (the observer masks, [P + L, K / 32] words, stay in L2);
// the row: both grids read once, [K] written (each block re-reads kf_id's
// row from L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct CovisWork {
  int K, F, LF, P, L, kf_id;
  const int32_t* pt;        // [K, F] point ids by feature
  const int32_t* ln;        // [K, LF] line ids by feature
  const uint8_t* kf_valid;  // [K]
  uint32_t* bits;           // [P + L, KW] observer masks (matrix)
  int32_t* out;             // [K, K] (matrix) or [K] (row)
};

__global__ void mark_kernel(const CovisWork w, int KW) {
  const long long n_pt = (long long)w.K * w.F, n = n_pt + (long long)w.K * w.LF;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    int k, id;
    if (e < n_pt) {
      k = (int)(e / w.F);
      id = w.pt[e];
      if (id < 0 || id >= w.P) continue;
    } else {
      k = (int)((e - n_pt) / w.LF);
      id = w.ln[e - n_pt];
      if (id < 0 || id >= w.L) continue;
      id += w.P;
    }
    atomicOr(&w.bits[(size_t)id * KW + (k >> 5)], 1u << (k & 31));
  }
}

__global__ void pairs_kernel(const CovisWork w, int KW) {
  extern __shared__ uint32_t vmask[];  // [KW] valid keyframes
  for (int i = threadIdx.x; i < KW; i += blockDim.x) vmask[i] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < w.K; k += blockDim.x)
    if (w.kf_valid[k]) atomicOr(&vmask[k >> 5], 1u << (k & 31));
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= w.P + w.L) return;
  const uint32_t* obs = w.bits + (size_t)p * KW;
  for (int wi = 0; wi < KW; ++wi) {
    uint32_t bi = obs[wi] & vmask[wi];
    while (bi) {
      const int i = wi * 32 + __ffs(bi) - 1;
      bi &= bi - 1;
      uint32_t bj = bi;
      for (int wj = wi; wj < KW; ++wj) {
        if (wj > wi) bj = obs[wj] & vmask[wj];
        while (bj) {
          const int j = wj * 32 + __ffs(bj) - 1;
          bj &= bj - 1;
          atomicAdd(&w.out[(size_t)i * w.K + j], 1);
          atomicAdd(&w.out[(size_t)j * w.K + i], 1);
        }
      }
    }
  }
}

__global__ void row_kernel(const CovisWork w) {
  extern __shared__ uint32_t seen[];  // [PW + LW]
  const int j = blockIdx.x;
  if (j == w.kf_id || !w.kf_valid[j]) {
    if (threadIdx.x == 0) w.out[j] = 0;
    return;
  }
  const int PW = (w.P + 31) >> 5, LW = (w.L + 31) >> 5;
  __shared__ int count;
  for (int i = threadIdx.x; i < PW + LW; i += blockDim.x) seen[i] = 0;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int32_t* mp = w.pt + (size_t)w.kf_id * w.F;
  const int32_t* ml = w.ln + (size_t)w.kf_id * w.LF;
  for (int f = threadIdx.x; f < w.F; f += blockDim.x) {
    const int id = mp[f];
    if (id >= 0 && id < w.P) atomicOr(&seen[id >> 5], 1u << (id & 31));
  }
  for (int f = threadIdx.x; f < w.LF; f += blockDim.x) {
    const int id = ml[f];
    if (id >= 0 && id < w.L) atomicOr(&seen[PW + (id >> 5)], 1u << (id & 31));
  }
  __syncthreads();
  int c = 0;
  const int32_t* rp = w.pt + (size_t)j * w.F;
  const int32_t* rl = w.ln + (size_t)j * w.LF;
  for (int f = threadIdx.x; f < w.F; f += blockDim.x) {
    const int id = rp[f];
    c += id >= 0 && id < w.P && ((seen[id >> 5] >> (id & 31)) & 1u);
  }
  for (int f = threadIdx.x; f < w.LF; f += blockDim.x) {
    const int id = rl[f];
    c += id >= 0 && id < w.L && ((seen[PW + (id >> 5)] >> (id & 31)) & 1u);
  }
  atomicAdd(&count, c);
  __syncthreads();
  if (threadIdx.x == 0) w.out[j] = count;
}

}  // namespace

extern "C" int sspl_covis_matrix(const void* work, void* stream) {
  const CovisWork w = *(const CovisWork*)work;
  cudaStream_t s = (cudaStream_t)stream;
  const int KW = (w.K + 31) / 32;
  cudaError_t e = cudaMemsetAsync(w.bits, 0, sizeof(uint32_t) * (size_t)(w.P + w.L) * KW, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(w.out, 0, sizeof(int32_t) * (size_t)w.K * w.K, s);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)w.K * (w.F + w.LF);
  const int nb = (int)((n + THREADS - 1) / THREADS);
  mark_kernel<<<nb, THREADS, 0, s>>>(w, KW);
  pairs_kernel<<<(w.P + w.L + THREADS - 1) / THREADS, THREADS, sizeof(uint32_t) * KW, s>>>(
      w, KW);
  return (int)cudaGetLastError();
}

extern "C" int sspl_covis_row(const void* work, void* stream) {
  const CovisWork w = *(const CovisWork*)work;
  const size_t smem = sizeof(uint32_t) * ((w.P + 31) / 32 + (w.L + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  row_kernel<<<w.K, THREADS, smem, (cudaStream_t)stream>>>(w);
  return (int)cudaGetLastError();
}
