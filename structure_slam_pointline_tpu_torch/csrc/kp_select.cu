// Kernel 11: spatially uniform keypoint selection over pyramid levels, in
// one launch per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/fast.py
// `select_keypoints_levels` (:197) and, for one level without a raw map,
// `select_keypoints` (:92, the LSD anchors of ops/lsd.py:412). The
// reference masks every level's score map, pads it to whole cells, runs
// `cell_cap` rounds of argmax + suppress over a [cells, cell^2] matrix of
// all levels, then one lax.top_k per level over the flattened cell lists,
// and gathers parabola offsets from whole-image rolled maps (~100 ops per
// call as plain torch).
//
// Each level owns a run of blocks of 1024 threads (Plan::blk_off), and each
// block `cpb` cells of it:
//   cells      a warp per cell stages the cell's ranked scores in shared
//              memory (the border and threshold masks and the +1e4 strong
//              bonus in float32, -inf outside the image and below the
//              floor), then takes the top `cap` by repeated argmax with
//              the FIRST index on ties: each lane scans its pixels in index
//              order, a shuffle tree merges (value, index) pairs, and the
//              winner is set to -inf. A cell with nothing left yields
//              index 0 and -inf for every later round, as jnp.argmax of an
//              all -inf row does, without scanning. The lists go to a
//              scratch in device memory.
//   selection  the level's last block to finish (a per-level counter,
//              reset by that block for the next call) selects the level's
//              top k of its cells x cap candidates in lax.top_k's order,
//              value descending, then flat index ascending: a radix select
//              of 4 passes of 8 bits over order-preserving keys (histograms
//              in shared memory, one warp finds each pass's bin) gives the
//              k-th key; a block scan places the keys above it and, of
//              those equal to it, the lowest indices; each chosen one's
//              place among the chosen is counted by ballots. Only the k
//              chosen (<= 256 on the main path) are ordered, no sort of a
//              level's thousands of candidates.
// The outputs: the first min(k, candidates) slots get validity, the
// response with the bonus undone, and xy = cell position + the parabola
// offsets read from the raw map's wrapped neighbours (jnp.roll), all in the
// reference's float32 op order; slots past the candidates are zero.
//
// The batch entry (`sspl_kp_select_batch`) runs the same launch over B
// frames, the frame on the grid's y axis: each level's map is a [B, h, w]
// stack (per-frame stride h * w), the scratch, the counters and the
// selected slots are [B, ...] with per-frame strides (the reference's vmap
// in parallel/batch_frontend.py:36); each frame's result is bit-equal to the
// single-frame entry's.
//
// Bound on the card: bytes, the level maps read once (score and, for the
// few chosen pixels, raw: ~3.8 MB over 8 levels of 640x480) and the
// selected slots written. The argmax rounds and the selection are far
// below the card's operation rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 16;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CAND = 16384;        // a level's candidates, keys held in shared memory
constexpr int CELL_SMEM = 32 * 1024;   // the cell warps' buffers in a block (8 cells of 32 px)
constexpr unsigned FULL = 0xffffffffu;

// the host's description of one call (ops/fast.py _SelWork)
struct Work {
  const float* score[MAXL];  // [B, h, w] NMS'd score maps per level
  const float* raw[MAXL];    // raw maps for the sub-pixel offsets, or null
  int h[MAXL], w[MAXL], k[MAXL], out_off[MAXL];
  int cell_off[MAXL + 1];    // each level's first cell (prefix of ceil(h/cell) * ceil(w/cell))
  int L, cell, cap, border, B;
  float threshold, min_threshold;
  float* top_s;              // scratch [B, cells x cap] scores and pixel indices
  int* top_i;
  unsigned* done;            // [B, L] blocks finished, zero between calls
  float* xy;                 // outputs [B, n_out, 2], [B, n_out], [B, n_out]
  float* resp;
  uint8_t* valid;
};

struct Plan {
  Work w;
  int ncx[MAXL];
  int blk_off[MAXL + 1];     // each level's first block
  int cpb;                   // cells per block
  int n_out;
};

__device__ __forceinline__ bool first_of(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// float -> uint32 in the same order (-0 as +0, which compare equal)
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float parabola(float r, float n, float p) {
  const float d = fmaxf(2.0f * r - n - p, 1e-3f);
  return fminf(fmaxf(0.5f * (n - p) / d, -0.5f), 0.5f);
}

// exclusive scan of one int per thread over the block
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += o;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  return incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// one cell's top `cap` by repeated argmax (a warp); c the global cell
__device__ void cell_top(const Work& w, int li, int c, int cl, int ncx, size_t f, float* buf,
                         float* top_s, int* top_i) {
  const int lane = threadIdx.x & 31, cell = w.cell, cap = w.cap, n = cell * cell;
  const int y0 = (cl / ncx) * cell, x0 = (cl % ncx) * cell;
  const int h = w.h[li], wd = w.w[li];
  const float* score = w.score[li] + f * h * wd;
  const float threshold = w.threshold, min_threshold = w.min_threshold;
  const int border = w.border;
#pragma unroll 4
  for (int p = lane; p < n; p += 32) {
    const int y = y0 + p / cell, x = x0 + p % cell;
    float v = -INFINITY;
    if (y < h && x < wd) {
      const float sc = score[(size_t)y * wd + x];
      const bool inb = y >= border && y < h - border && x >= border && x < wd - border;
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
#pragma unroll 8
      for (int p = lane + 32; p < n; p += 32)
        if (buf[p] > bv) {
          bv = buf[p];
          bi = p;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (first_of(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bv == -INFINITY) {  // nothing left: (-inf, 0) for this and every later round
      for (int q = r + lane; q < cap; q += 32) {
        top_s[(size_t)c * cap + q] = -INFINITY;
        top_i[(size_t)c * cap + q] = 0;
      }
      break;
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

// the level's top min(k, n) of its n candidates, written to its slots
__device__ void select_level(const Plan& p, int li, size_t f, const float* ts, const int* ti,
                             unsigned char* smem) {
  const Work& w = p.w;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cap = w.cap, cell = w.cell;
  const int n = (w.cell_off[li + 1] - w.cell_off[li]) * cap;
  const int k = w.k[li], kk = min(k, n);
  const int h = w.h[li], wd = w.w[li], ncx = p.ncx[li];
  const float* raw = w.raw[li] != nullptr ? w.raw[li] + f * h * wd : nullptr;
  float* oxy = w.xy + 2 * (f * p.n_out + w.out_off[li]);
  float* oresp = w.resp + f * p.n_out + w.out_off[li];
  uint8_t* ovalid = w.valid + f * p.n_out + w.out_off[li];
  for (int s = kk + t; s < k; s += THREADS) {
    oxy[2 * s] = 0.f;
    oxy[2 * s + 1] = 0.f;
    oresp[s] = 0.f;
    ovalid[s] = 0;
  }
  if (kk == 0) return;
  uint32_t* su = reinterpret_cast<uint32_t*>(smem);  // [n] keys
  uint32_t* cu = su + n;                             // [kk] chosen keys, index order
  int* ci = reinterpret_cast<int*>(cu + kk);         // [kk] chosen indices
  int* hist = ci + kk;                               // [256]
  int* sums = hist + 256;                            // [32]
  int* pick = sums + 32;                             // [2]: bin, need
  for (int q = t; q < n; q += THREADS) su[q] = order_key(__ldcg(ts + q));

  // radix select: the kk-th largest key, 8 bits a pass from the top
  uint32_t prefix = 0, pmask = 0;
  int need = kk;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int q = t; q < 256; q += THREADS) hist[q] = 0;
    __syncthreads();
    // one atomic per distinct bin of a warp's 32 keys (most keys share
    // a few bins: the bonus, the floor, -inf)
    for (int q0 = warp * 32; q0 < n; q0 += THREADS) {
      const int q = q0 + lane;
      const uint32_t u = q < n ? su[q] : 0u;
      const bool in = q < n && (u & pmask) == prefix;
      const unsigned bin = in ? (u >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(FULL, bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l; counts from the top
      int c[8], s = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = hist[255 - 8 * lane - e];
        s += c[e];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
      }
      int acc = incl - s;
      if (acc < need && need <= incl) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (acc < need && need <= acc + c[e]) {
            pick[0] = 255 - 8 * lane - e;
            pick[1] = need - acc;
          }
          acc += c[e];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)pick[0] << shift;
    pmask |= 255u << shift;
    need = pick[1];
  }
  // the chosen: keys above the kk-th, and the `need` lowest indices of
  // those equal to it, placed in index order by a block scan of
  // (above, equal) counts packed in 16 bits each
  const int per = (n + THREADS - 1) / THREADS, q0 = min(t * per, n), q1 = min(q0 + per, n);
  int gt = 0, eq = 0;
  for (int q = q0; q < q1; ++q) {
    gt += su[q] > prefix;
    eq += su[q] == prefix;
  }
  const int before = block_exclusive_scan((gt << 16) | eq, sums);
  gt = before >> 16;
  eq = before & 0xffff;
  for (int q = q0; q < q1; ++q) {
    const uint32_t u = su[q];
    if (u > prefix || (u == prefix && eq < need)) {
      const int pos = gt + min(eq, need);
      cu[pos] = u;
      ci[pos] = q;
    }
    gt += u > prefix;
    eq += u == prefix;
  }
  __syncthreads();
  // each chosen one's slot: the chosen keys above it, or equal at a lower
  // index, counted by T threads a chosen one (shares added by shuffles)
  int T = 1;
  while (T < 32 && 2 * T * kk <= THREADS) T *= 2;
  for (int q0 = 0; q0 < kk * T; q0 += THREADS) {
    const int q = q0 + t, s = q / T, part = q & (T - 1);
    int r = 0;
    if (s < kk) {
      const uint32_t us = cu[s];
#pragma unroll 4
      for (int x = part; x < kk; x += T) r += cu[x] > us || (cu[x] == us && x < s);
    }
    for (int off = 1; off < T; off <<= 1) r += __shfl_xor_sync(FULL, r, off);
    if (s >= kk || part != 0) continue;
    const int idx = ci[s];
    const int cl = idx / cap;
    const float sc = __ldcg(ts + idx);
    const int pix = __ldcg(ti + idx);
    const int ay = (cl / ncx) * cell + pix / cell;
    const int ax = (cl % ncx) * cell + pix % cell;
    ovalid[r] = isfinite(sc) && sc > 0.f;
    oresp[r] = sc >= 1e4f ? sc - 1e4f : sc;
    float fx = (float)ax, fy = (float)ay;
    if (raw != nullptr) {
      const int sy = min(max(ay, 0), h - 1), sx = min(max(ax, 0), wd - 1);
      const float* row = raw + (size_t)sy * wd;
      const float r0 = row[sx];
      fx = fx + parabola(r0, row[(sx + 1) % wd], row[(sx + wd - 1) % wd]);
      fy = fy + parabola(r0, raw[(size_t)((sy + 1) % h) * wd + sx],
                         raw[(size_t)((sy + h - 1) % h) * wd + sx]);
    }
    oxy[2 * r] = fx;
    oxy[2 * r + 1] = fy;
  }
}

__global__ void __launch_bounds__(THREADS) select_kernel(const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const Work& w = p.w;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  int li = 0;
  while (b >= p.blk_off[li + 1]) ++li;
  const size_t f = blockIdx.y;
  const int per_frame = w.cell_off[w.L] * w.cap;
  float* top_s = w.top_s + f * per_frame;
  int* top_i = w.top_i + f * per_frame;
  const int c0 = w.cell_off[li], nc = w.cell_off[li + 1] - c0;
  const int cl = (b - p.blk_off[li]) * p.cpb + warp;
  if (warp < p.cpb && cl < nc)
    cell_top(w, li, c0 + cl, cl, p.ncx[li], f,
             reinterpret_cast<float*>(smem) + warp * w.cell * w.cell, top_s, top_i);
  // the level's last block to finish selects
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nb = p.blk_off[li + 1] - p.blk_off[li];
    unsigned* done = w.done + f * w.L + li;
    last = nb == 1 || atomicAdd(done, 1u) == (unsigned)(nb - 1);
    if (last && nb > 1) *done = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  select_level(p, li, f, top_s + (size_t)c0 * w.cap, top_i + (size_t)c0 * w.cap, smem);
}

// the plan of one call and its dynamic shared memory; a CUDA error code
int make_plan(const Work& w, int batch, Plan& p, size_t& smem) {
  if (w.L < 1 || w.L > MAXL || w.cell < 1 || w.cell > 64 || w.cap < 1 ||
      w.cap > w.cell * w.cell || w.B != batch || w.B < 1 || w.B > 65535)
    return (int)cudaErrorInvalidValue;
  p.w = w;
  const int fit = CELL_SMEM / (w.cell * w.cell * (int)sizeof(float));
  p.cpb = fit < 1 ? 1 : fit > WARPS ? WARPS : fit;
  p.blk_off[0] = 0;
  size_t sel_smem = 0;
  for (int l = 0; l < w.L; ++l) {
    const int nc = w.cell_off[l + 1] - w.cell_off[l];
    const int n = nc * w.cap;
    if (nc < 1 || n > MAX_CAND || w.k[l] < 0 || w.h[l] < 1 || w.w[l] < 1)
      return (int)cudaErrorInvalidValue;
    p.ncx[l] = (w.w[l] + w.cell - 1) / w.cell;
    p.blk_off[l + 1] = p.blk_off[l] + (nc + p.cpb - 1) / p.cpb;
    const size_t s = (size_t)n * 4 + (size_t)(w.k[l] < n ? w.k[l] : n) * 8 + (256 + 32 + 2) * 4;
    if (s > sel_smem) sel_smem = s;
  }
  p.n_out = w.out_off[w.L - 1] + w.k[w.L - 1];
  const size_t cell_smem = (size_t)p.cpb * w.cell * w.cell * sizeof(float);
  smem = cell_smem > sel_smem ? cell_smem : sel_smem;
  return 0;
}

int launch(const void* work, int batch, void* stream) {
  Plan p;
  size_t smem = 0;
  const int err = make_plan(*(const Work*)work, batch, p, smem);
  if (err != 0) return err;
  static size_t smem_set = 48 * 1024;  // the attribute already set
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  select_kernel<<<dim3(p.blk_off[p.w.L], p.w.B), THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_kp_select(const void* work, void* stream) { return launch(work, 1, stream); }

extern "C" int sspl_kp_select_batch(const void* work, void* stream) {
  return launch(work, ((const Work*)work)->B, stream);
}
