// Kernel 11: spatially uniform keypoint selection over pyramid levels, in
// two launches.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/fast.py
// `select_keypoints_levels` (:197) and, for one level without a raw map,
// `select_keypoints` (:92, the LSD anchors of ops/lsd.py:287). The
// reference masks every level's score map, pads it to whole cells, runs
// `cell_cap` rounds of argmax + suppress over a [cells, cell^2] matrix of
// all levels, then one lax.top_k per level over the flattened cell lists,
// and gathers parabola offsets from whole-image rolled maps (~100 ops per
// call as plain torch).
//
// Launch A (kp_select_cells): one warp per cell, over every level's cells
// together. The warp stages its cell's ranked scores in shared memory (the
// border and threshold masks and the +1e4 strong bonus in float32, -inf
// outside the image and below the floor), then takes the top `cap` by
// repeated argmax with the FIRST index on ties: each lane scans its
// pixels in index order, a shuffle tree merges (value, index) pairs, and
// the winner is set to -inf. A cell with nothing left yields index 0 and
// -inf, as jnp.argmax of an all -inf row does.
// Launch B (kp_select_rank): one block per level. It sorts that level's
// cells x cap candidates in shared memory with a bitonic network, by
// value descending then flat index ascending (lax.top_k's order; padding
// sorts last), and writes the first min(k, candidates) slots: validity,
// response with the bonus undone, and xy = cell position + the parabola
// offsets read from the raw map's wrapped neighbours (jnp.roll), all in
// the reference's float32 op order. Slots past the candidates are zero.
//
// The batch entries (`sspl_kp_select_cells_batch`, `sspl_kp_select_rank_batch`)
// run the same two launches over B frames, the frame on the grid's y axis:
// each level's map is a [B, h, w] stack (per-frame stride h * w), the
// candidates and the selected slots are [B, ...] with per-frame strides of
// every level's cells x cap and of the summed budgets (the reference's vmap
// in parallel/batch_frontend.py:36); each frame's result is bit-equal to the
// single-frame entries'.
//
// Bound on the card: bytes, the level maps read once (score and, for the
// few chosen pixels, raw: ~3.8 MB over 8 levels of 640x480) and the
// selected slots written. The sort (a few thousand entries per level) and
// the argmax rounds are far below the card's operation rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 16;
constexpr int WPB = 4;  // warps (cells) per block of launch A

struct Levels {
  const float* map[MAXL];  // launch A: scores; launch B: raw maps (or null)
  int h[MAXL], w[MAXL], ncx[MAXL], cell_off[MAXL + 1], k[MAXL], out_off[MAXL];
  int L;
};

__device__ __forceinline__ bool first_of(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void cells_kernel(Levels lv, int cell, int cap, float threshold,
                             float min_threshold, int border, float* __restrict__ top_s,
                             int* __restrict__ top_i) {
  extern __shared__ float buf_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WPB + warp;
  if (c >= lv.cell_off[lv.L]) return;
  const size_t f = blockIdx.y;
  top_s += f * lv.cell_off[lv.L] * cap;
  top_i += f * lv.cell_off[lv.L] * cap;
  int li = 0;
  while (c >= lv.cell_off[li + 1]) ++li;
  const int n = cell * cell;
  float* buf = buf_all + warp * n;
  const int cl = c - lv.cell_off[li];
  const int y0 = (cl / lv.ncx[li]) * cell, x0 = (cl % lv.ncx[li]) * cell;
  const int h = lv.h[li], w = lv.w[li];
  const float* score = lv.map[li] + f * h * w;
  for (int p = lane; p < n; p += 32) {
    const int y = y0 + p / cell, x = x0 + p % cell;
    float v = -INFINITY;
    if (y < h && x < w) {
      const float sc = score[(size_t)y * w + x];
      const bool inb = y >= border && y < h - border && x >= border && x < w - border;
      const float s = (inb && sc >= min_threshold) ? sc : 0.f;
      const float bonus = s >= threshold ? 1e4f : 0.f;
      v = s > 0.f ? s + bonus : -INFINITY;
    }
    buf[p] = v;
  }
  __syncwarp();
  for (int r = 0; r < cap; ++r) {
    float bv = -INFINITY;
    int bi = INT32_MAX;
    if (lane < n) {
      bv = buf[lane];
      bi = lane;
      for (int p = lane + 32; p < n; p += 32)
        if (buf[p] > bv) { bv = buf[p]; bi = p; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (first_of(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) {
      top_s[(size_t)c * cap + r] = bv;
      top_i[(size_t)c * cap + r] = bi;
    }
    __syncwarp();
    if ((bi & 31) == lane) buf[bi] = -INFINITY;
    __syncwarp();
  }
}

__device__ __forceinline__ float parabola(float r, float n, float p) {
  const float d = fmaxf(2.0f * r - n - p, 1e-3f);
  return fminf(fmaxf(0.5f * (n - p) / d, -0.5f), 0.5f);
}

__global__ void rank_kernel(Levels lv, int cell, int cap, const float* __restrict__ top_s,
                            const int* __restrict__ top_i, float* __restrict__ xy,
                            float* __restrict__ resp, bool* __restrict__ valid) {
  extern __shared__ unsigned char smem[];
  const int li = blockIdx.x;
  const size_t f = blockIdx.y;
  const int n_out = lv.out_off[lv.L - 1] + lv.k[lv.L - 1];
  top_s += f * lv.cell_off[lv.L] * cap;
  top_i += f * lv.cell_off[lv.L] * cap;
  xy += 2 * f * n_out;
  resp += f * n_out;
  valid += f * n_out;
  const int nc = lv.cell_off[li + 1] - lv.cell_off[li];
  const int n = nc * cap;
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + np2);
  const float* ts = top_s + (size_t)lv.cell_off[li] * cap;
  const int* ti = top_i + (size_t)lv.cell_off[li] * cap;
  for (int t = threadIdx.x; t < np2; t += blockDim.x) {
    sv[t] = t < n ? ts[t] : -INFINITY;
    si[t] = t;
  }
  __syncthreads();
  for (int size = 2; size <= np2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < np2; t += blockDim.x) {
        const int u = t ^ stride;
        if (u > t) {
          const float va = sv[t], vb = sv[u];
          const int ia = si[t], ib = si[u];
          const bool fwd = (t & size) == 0;
          if (fwd ? first_of(vb, ib, va, ia) : first_of(va, ia, vb, ib)) {
            sv[t] = vb; sv[u] = va;
            si[t] = ib; si[u] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
  const int h = lv.h[li], w = lv.w[li], ncx = lv.ncx[li];
  const int k = lv.k[li], kk = min(k, n);
  const float* raw = lv.map[li] != nullptr ? lv.map[li] + f * h * w : nullptr;
  float* oxy = xy + 2 * (size_t)lv.out_off[li];
  float* oresp = resp + lv.out_off[li];
  bool* ovalid = valid + lv.out_off[li];
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    if (t >= kk) {
      oxy[2 * t] = 0.f;
      oxy[2 * t + 1] = 0.f;
      oresp[t] = 0.f;
      ovalid[t] = false;
      continue;
    }
    const float key = sv[t];
    const int idx = si[t];
    const int cl = idx / cap;
    const float s = ts[idx];
    const int pix = ti[idx];
    const int ay = (cl / ncx) * cell + pix / cell;
    const int ax = (cl % ncx) * cell + pix % cell;
    ovalid[t] = isfinite(key) && s > 0.f;
    oresp[t] = s >= 1e4f ? s - 1e4f : s;
    float fx = (float)ax, fy = (float)ay;
    if (raw != nullptr) {
      const int sy = min(max(ay, 0), h - 1), sx = min(max(ax, 0), w - 1);
      const float* row = raw + (size_t)sy * w;
      const float r0 = row[sx];
      fx = fx + parabola(r0, row[(sx + 1) % w], row[(sx + w - 1) % w]);
      fy = fy + parabola(r0, raw[(size_t)((sy + 1) % h) * w + sx],
                         raw[(size_t)((sy + h - 1) % h) * w + sx]);
    }
    oxy[2 * t] = fx;
    oxy[2 * t + 1] = fy;
  }
}

bool fill_levels(Levels& lv, const void* const* maps, const int* hs, const int* ws,
                 const int* cell_off, int L, int cell) {
  if (L < 1 || L > MAXL) return false;
  lv.L = L;
  for (int l = 0; l < L; ++l) {
    lv.map[l] = (const float*)maps[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.ncx[l] = (ws[l] + cell - 1) / cell;
    lv.k[l] = 0;
    lv.out_off[l] = 0;
  }
  for (int l = 0; l <= L; ++l) lv.cell_off[l] = cell_off[l];
  return true;
}

}  // namespace

namespace {

int select_cells(const void* scores, const void* hs, const void* ws, const void* cell_off,
                 int L, int cell, int cap, float threshold, float min_threshold, int border,
                 int B, void* top_s, void* top_i, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, (const void* const*)scores, (const int*)hs, (const int*)ws,
                   (const int*)cell_off, L, cell))
    return (int)cudaErrorInvalidValue;
  const int nc = lv.cell_off[L];
  const size_t smem = (size_t)WPB * cell * cell * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cells_kernel<<<dim3((nc + WPB - 1) / WPB, B), WPB * 32, smem, (cudaStream_t)stream>>>(
      lv, cell, cap, threshold, min_threshold, border, (float*)top_s, (int*)top_i);
  return (int)cudaGetLastError();
}

int select_rank(const void* raws, const void* hs, const void* ws, const void* cell_off,
                const void* ks, const void* out_off, int L, int cell, int cap, int B,
                const void* top_s, const void* top_i, void* xy, void* resp, void* valid,
                void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!fill_levels(lv, (const void* const*)raws, (const int*)hs, (const int*)ws,
                   (const int*)cell_off, L, cell))
    return (int)cudaErrorInvalidValue;
  int np2_max = 1;
  for (int l = 0; l < L; ++l) {
    lv.k[l] = ((const int*)ks)[l];
    lv.out_off[l] = ((const int*)out_off)[l];
    const int n = (lv.cell_off[l + 1] - lv.cell_off[l]) * cap;
    while (np2_max < n) np2_max <<= 1;
  }
  const size_t smem = (size_t)np2_max * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rank_kernel<<<dim3(L, B), 1024, smem, (cudaStream_t)stream>>>(
      lv, cell, cap, (const float*)top_s, (const int*)top_i, (float*)xy, (float*)resp,
      (bool*)valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_kp_select_cells(const void* scores, const void* hs, const void* ws,
                                    const void* cell_off, int L, int cell, int cap,
                                    float threshold, float min_threshold, int border,
                                    void* top_s, void* top_i, void* stream) {
  return select_cells(scores, hs, ws, cell_off, L, cell, cap, threshold, min_threshold, border,
                      1, top_s, top_i, stream);
}

extern "C" int sspl_kp_select_rank(const void* raws, const void* hs, const void* ws,
                                   const void* cell_off, const void* ks,
                                   const void* out_off, int L, int cell, int cap,
                                   const void* top_s, const void* top_i, void* xy,
                                   void* resp, void* valid, void* stream) {
  return select_rank(raws, hs, ws, cell_off, ks, out_off, L, cell, cap, 1, top_s, top_i, xy,
                     resp, valid, stream);
}

extern "C" int sspl_kp_select_cells_batch(const void* scores, const void* hs, const void* ws,
                                          const void* cell_off, int L, int cell, int cap,
                                          float threshold, float min_threshold, int border,
                                          int B, void* top_s, void* top_i, void* stream) {
  return select_cells(scores, hs, ws, cell_off, L, cell, cap, threshold, min_threshold, border,
                      B, top_s, top_i, stream);
}

extern "C" int sspl_kp_select_rank_batch(const void* raws, const void* hs, const void* ws,
                                         const void* cell_off, const void* ks,
                                         const void* out_off, int L, int cell, int cap, int B,
                                         const void* top_s, const void* top_i, void* xy,
                                         void* resp, void* valid, void* stream) {
  return select_rank(raws, hs, ws, cell_off, ks, out_off, L, cell, cap, B, top_s, top_i, xy,
                     resp, valid, stream);
}
