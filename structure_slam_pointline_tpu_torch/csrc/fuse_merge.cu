// Kernel 23: the sequential merges of the projection fuses and their
// finish.
//
// Replaces the JAX package's structure_slam_pointline_tpu/models/
// local_mapping.py fuse merge loops (the fori_loop bodies of
// `fuse_projected_points`, :842-872, and `fuse_projected_lines`,
// :945-971) with their finish (`_compose_redirect` :710, the redirect and
// validity passes, `_dedup_row_table` :722), and models/loop_closing.py
// `_loop_fuse`'s merge loop (:160-180, with `_dedup_rows` :125). The
// reference carries the whole [K, F] table, the [P] redirect and the [P]
// validity through a loop of whole-array scatters, and its dedup writes a
// [K, P + 1] first-feature table. Three entries:
//
//   fuse_merge  one block walks the directions in the reference's order
//               (the local fuse's last W directions all write the new
//               keyframe's row, so each reads the row the previous one
//               left). In a direction every read (the redirect, the
//               validity, the target row and its presence bits in shared
//               memory) sees the state from before it, as XLA's scatters
//               do: the block decides every candidate row, syncs, then
//               writes. Colliding writes follow utils/indexing.py
//               set_drop, last write wins: the largest row index, picked
//               by an atomicMax into a scratch slot (the redirect's in
//               L2, the row's in shared memory). The local rule merges a
//               feature bound to another live landmark (the one with more
//               observations, counted before the fuse, survives) and adds
//               a match on an unbound feature whose landmark the row does
//               not hold yet.
//   loop_merge  the same walk with the loop rule: a feature bound to a
//               landmark outside the pool is redirected to the pool's
//               landmark (the pool's membership bits in shared memory);
//               an unbound feature gains the pool landmark.
//   fuse_finish three launches compose the redirect (r <- r[r], double
//               buffered), then a block per keyframe row applies it,
//               clears bindings to dead landmarks (the local fuses), and
//               keeps the first feature of each landmark id: the row's
//               (id, feature) pairs sorted in shared memory (bitonic),
//               a pair dropped when the one before it has the same id. No
//               [K, P + 1] table.
//
// All integer work, so the kernels are bit-equal to the plain versions
// (models/local_mapping.py fuse_merge_plain / fuse_finish_plain,
// models/loop_closing.py loop_merge_plain). An index the reference's
// gathers would clamp is clamped here too.
//
// Bound on the card: bytes, the [K, F] table copied, then read and
// written once by the finish (~2 MB each way at 256 x 2048), the pools'
// redirect and validity once. The merge walk is one block: its cost is
// latency, ~6 barriers a direction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MERGE_THREADS = 1024;
constexpr int ROW_THREADS = 256;
constexpr int COMPOSE_THREADS = 256;

struct MergeWork {
  int D;           // directions, in order
  int M;           // candidate rows of a direction
  int K, F;        // the table
  int P;           // the landmark pool
  int loop;        // 0: the local rule, 1: the loop rule
  const int32_t* table_in;  // [K, F] before the fuse
  int32_t* table;           // [K, F] out
  const uint8_t* valid_in;  // [P]
  uint8_t* valid;           // [P] out
  int32_t* redirect;        // [P] out
  const int32_t* obs;       // [P] observations before the fuse (local)
  const int32_t* a_ids;     // [D] source rows of the candidates (local)
  const int32_t* b_ids;     // [D] target rows
  const uint8_t* present;   // [D] (loop)
  const int32_t* pool_ids;  // [M] (loop)
  const int32_t* feat;      // [D, M] matched feature
  const uint8_t* hits;      // [D, M]
  int32_t* win;             // [P] scratch
  int32_t* dec;             // [M, 3] scratch: kind (1 redirect, 2 add), index, value
};

struct FinishWork {
  int K, F, P, clear_invalid;
  const int32_t* table_in;  // [K, F]
  int32_t* table;           // [K, F] out
  const uint8_t* valid;     // [P]
  const int32_t* redirect;  // [P]
  int32_t* r1;              // [P] scratch, the composed redirect at the end
  int32_t* r2;              // [P] scratch
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ bool bit(const uint32_t* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(MERGE_THREADS) merge_kernel(const MergeWork w) {
  extern __shared__ uint32_t smem[];
  const int PW = (w.P + 31) >> 5;
  uint32_t* present = smem;         // [PW] the target row's landmarks (local)
  uint32_t* pool = smem + PW;       // [PW] the pool's landmarks (loop)
  int32_t* win_f = (int32_t*)(smem + 2 * PW);  // [F] last add per feature
  const int tid = threadIdx.x, nt = blockDim.x;
  const int P = w.P, F = w.F, M = w.M;

  for (int p = tid; p < P; p += nt) {
    w.redirect[p] = p;
    w.valid[p] = w.valid_in[p];
    w.win[p] = -1;
  }
  for (int i = tid; i < PW; i += nt) pool[i] = 0;
  __syncthreads();
  if (w.loop)
    for (int r = tid; r < M; r += nt) {
      const int id = w.pool_ids[r];
      if (id >= 0 && id < P) atomicOr(&pool[id >> 5], 1u << (id & 31));
    }

  for (int d = 0; d < w.D; ++d) {
    const int b = w.b_ids[d];
    int32_t* row = w.table + (size_t)b * F;
    for (int i = tid; i < PW; i += nt) present[i] = 0;
    for (int f = tid; f < F; f += nt) win_f[f] = -1;
    __syncthreads();
    if (!w.loop)
      for (int f = tid; f < F; f += nt) {
        const int id = row[f];
        if (id >= 0 && id < P) atomicOr(&present[id >> 5], 1u << (id & 31));
      }
    __syncthreads();
    // decide every candidate row against the state before this direction
    for (int r = tid; r < M; r += nt) {
      int kind = 0, index = 0, value = 0;
      const int fr = w.feat[(size_t)d * M + r];
      const int f = clampi(fr, 0, F - 1);
      const bool hit_in = w.hits[(size_t)d * M + r];
      const int cur = row[f];
      if (!w.loop) {
        const int id = w.table_in[(size_t)w.a_ids[d] * F + r];
        int cand = id >= 0 ? w.redirect[clampi(id, 0, P - 1)] : -1;
        if (cand >= 0 && !w.valid[clampi(cand, 0, P - 1)]) cand = -1;
        const bool hit = hit_in && cand >= 0;
        const int cur_r = cur >= 0 ? w.redirect[clampi(cur, 0, P - 1)] : -1;
        if (hit && cur_r >= 0 && cur_r != cand) {
          const bool keep_cand = w.obs[cand] >= w.obs[cur_r];
          kind = 1;
          index = keep_cand ? cur_r : cand;
          value = keep_cand ? cand : cur_r;
        } else if (hit && cur_r < 0 && !bit(present, cand)) {
          kind = 2;
          index = f;
          value = cand;
        }
      } else {
        const bool hit = hit_in && w.present[d];
        const int pid = w.pool_ids[r];
        if (hit && cur >= 0 && cur != pid && !bit(pool, clampi(cur, 0, P - 1))) {
          kind = 1;
          index = cur;
          value = pid;
        } else if (hit && cur < 0 && fr >= 0 && fr < F) {
          kind = 2;
          index = fr;
          value = pid;
        }
      }
      if (kind == 1 && index < P) atomicMax(&w.win[index], r);
      if (kind == 2) atomicMax(&win_f[index], r);
      w.dec[3 * r] = kind;
      w.dec[3 * r + 1] = index;
      w.dec[3 * r + 2] = value;
    }
    __syncthreads();
    for (int r = tid; r < M; r += nt) {
      const int kind = w.dec[3 * r], index = w.dec[3 * r + 1], value = w.dec[3 * r + 2];
      if (kind == 1 && index < P) {
        w.valid[index] = 0;
        if (w.win[index] == r) w.redirect[index] = value;
      } else if (kind == 2 && win_f[index] == r) {
        row[index] = value;
      }
    }
    __syncthreads();
    for (int r = tid; r < M; r += nt)
      if (w.dec[3 * r] == 1 && w.dec[3 * r + 1] < P) w.win[w.dec[3 * r + 1]] = -1;
    __syncthreads();
  }
}

__global__ void compose_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                               int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P) out[p] = in[clampi(in[p], 0, P - 1)];
}

__global__ void __launch_bounds__(ROW_THREADS) finish_rows_kernel(const FinishWork w, int NP) {
  extern __shared__ unsigned long long keys[];  // [NP]
  const int k = blockIdx.x, tid = threadIdx.x;
  const int F = w.F, P = w.P;
  const int32_t* in = w.table_in + (size_t)k * F;
  int32_t* row = w.table + (size_t)k * F;
  for (int f = tid; f < NP; f += blockDim.x) {
    unsigned long long key = ~0ull;
    if (f < F) {
      int v = in[f];
      if (v >= 0) v = w.r1[clampi(v, 0, P - 1)];
      if (w.clear_invalid && v >= 0 && !w.valid[clampi(v, 0, P - 1)]) v = -1;
      if (v >= 0)
        key = ((unsigned long long)(uint32_t)v << 32) | (uint32_t)f;
      else
        row[f] = -1;
    }
    keys[f] = key;
  }
  __syncthreads();
  for (int size = 2; size <= NP; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < NP; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const unsigned long long a = keys[i], b = keys[j];
          if ((a > b) == up) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  for (int s = tid; s < NP; s += blockDim.x) {
    const unsigned long long key = keys[s];
    if (key == ~0ull) continue;
    const uint32_t id = (uint32_t)(key >> 32);
    const bool dup = s > 0 && (uint32_t)(keys[s - 1] >> 32) == id;
    row[(uint32_t)key] = dup ? -1 : (int32_t)id;
  }
}

int smem_ok(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

int merge(const MergeWork* wp, void* stream) {
  const MergeWork w = *wp;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyAsync(w.table, w.table_in, sizeof(int32_t) * w.K * w.F,
                                  cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(uint32_t) * (2 * ((w.P + 31) / 32) + w.F);
  const int err = smem_ok((const void*)merge_kernel, smem);
  if (err) return err;
  merge_kernel<<<1, MERGE_THREADS, smem, s>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_fuse_merge(const void* work, void* stream) {
  return merge((const MergeWork*)work, stream);
}

extern "C" int sspl_loop_merge(const void* work, void* stream) {
  return merge((const MergeWork*)work, stream);
}

extern "C" int sspl_fuse_finish(const void* work, void* stream) {
  const FinishWork w = *(const FinishWork*)work;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (w.P + COMPOSE_THREADS - 1) / COMPOSE_THREADS;
  compose_kernel<<<nb, COMPOSE_THREADS, 0, s>>>(w.redirect, w.r1, w.P);
  compose_kernel<<<nb, COMPOSE_THREADS, 0, s>>>(w.r1, w.r2, w.P);
  compose_kernel<<<nb, COMPOSE_THREADS, 0, s>>>(w.r2, w.r1, w.P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int NP = 1;
  while (NP < w.F) NP <<= 1;
  const size_t smem = sizeof(unsigned long long) * NP;
  const int err = smem_ok((const void*)finish_rows_kernel, smem);
  if (err) return err;
  finish_rows_kernel<<<w.K, ROW_THREADS, smem, s>>>(w, NP);
  return (int)cudaGetLastError();
}
