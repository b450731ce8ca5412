// Kernel 25: the bf16 image pyramid and its blurred planes, every level of
// a frame or of a [B, H, W] stack of frames in one launch.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/pyramid.py
// `build_pyramid` (:57, each level `jax.image.resize(..., "bilinear")` of
// the previous one: two contractions with dense antialiased weight
// matrices) and `blur` (:41, 2 x 7 rolled taps, each a bf16 product and a
// bf16 add, "effectively free" on the TPU's vector unit). The plain
// version (ops/pyramid.py build_blurred_pyramid_plain) runs two float32
// matmuls per level and 56 small elementwise ops per blurred plane.
//
// One cooperative launch of a persistent grid (the co-resident blocks, at
// most 2 a multiprocessor and the largest phase's tiles) runs the levels as
// phases with a grid barrier between them: phase p resizes level p from
// level p - 1 and blurs level p - 1 (complete since the barrier before
// it), so a frame of 8 levels takes 8 phases and 7 barriers. A block takes
// the phase's tiles round robin:
//  - a resize tile (TR x TC outputs of level p, 32 x 32 at the pyramid's
//    1.2 scale; the host picks smaller tiles where a source window would
//    pass 64 x 64, and passes each tile row's and column's window) stages
//    its source window of level p - 1 in shared memory with 8-byte loads,
//    its taps beside it, runs the row pass over the window's columns and
//    the column pass over the tile, and writes the tile with 4-byte stores
//    (2-byte ones where a pair straddles the tile's edge);
//  - a blur tile (32 x 32 of level p - 1) stages its 38 x 38 wrapped halo
//    the same way (the wrapped columns one by one), runs the 7 vertical
//    taps over tile rows x halo columns and the 7 horizontal taps over the
//    tile, and writes the blurred tile with the same stores.
// The same launch serves the one-op forms `resize_bilinear` (one resize
// phase, no blur) and `blur` (one blur phase).
//
// Numerics, every value as the plain version rounds it:
// - the resize: out = bf16(sum_x bf16(sum_y wr[y] * prev[y, x]) * wc[x])
//   with the bf16-rounded weights; the products of bf16 values are exact
//   in float32, and only the non-zero taps (a contiguous run of at most
//   TAPS per output index, from the host's table) are added, in increasing
//   source index from +0, the order of the float32 matmul's running sum;
// - the blur: acc = bf16(acc + bf16(w_i * v)), i = 0..6 from +0, the taps'
//   weights rounded to bf16, rows then columns, borders wrapped (torch.roll);
// - built with -fmad=false, so no product is fused into an add.
//
// Bound on the card: bytes. Each level is read once by the next and once
// by its blur (the halo re-reads stay in L2), each level and blurred plane
// written once: ~2.3 MB a 640 x 480 frame over 8 levels. What sets the
// time at one frame is the chain of 8 dependent phases, each at least one
// tile long (levels 4-7 hold a few dozen tiles each): a lone tile takes
// ~8,000 cycles whatever its block's threads, of which the blur's
// 7-tap chains are ~3,000, and the 7 grid barriers ~20% of the call
// (PERF.md, -DSSPL_PYR_TRACE).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_LEVELS = 16;
constexpr int TAPS = 8;           // resize taps per output index (at most)
constexpr int ENTRY = 2 + TAPS;   // (first, count, w[TAPS]) per output index
constexpr int TILE = 32;          // blur tiles; resize tiles at most
constexpr int SRC = 64;           // a resize tile's source window, at most, per axis
constexpr int RAD = 3;            // blur radius (7 taps)
constexpr int HALO = TILE + 2 * RAD;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;  // the persistent grid's blocks a multiprocessor, at most
constexpr int MAX_SPANS = 640;    // tile rows and columns of all levels' resizes, at most

// the host's description of one call (ops/pyramid.py _PyrWork)
struct Work {
  int B, n_levels, first, blur;  // levels first..n_levels-1; blur: write blurred planes
  int H[MAX_LEVELS], W[MAX_LEVELS];
  int row_tab[MAX_LEVELS], col_tab[MAX_LEVELS];  // level l's entries in tab
  int tr[MAX_LEVELS], tc[MAX_LEVELS];            // level l's resize tile (rows, columns)
  int row_span[MAX_LEVELS], col_span[MAX_LEVELS];  // level l's tiles' windows in span
  const uint16_t* level[MAX_LEVELS];  // level 0 is the input; bf16 bits [B, H, W]
  uint16_t* out[MAX_LEVELS];          // levels written (l >= 1)
  uint16_t* blurred[MAX_LEVELS];
  const float* tab;                   // [entries, ENTRY] resize taps
  float taps[2 * RAD + 1];            // bf16-rounded blur weights
  long long* trace;  // built with -DSSPL_PYR_TRACE: block 0's clock64 per phase,
                     // [2 p] its own tiles, [2 p + 1] the barrier after them
  // a resize tile's source window per tile row and tile column (first
  // source index, count), so a tile starts its window's loads at once
  short2 span[MAX_SPANS];
};

union Smem {
  struct {
    float win[SRC][SRC + 1];    // the source window of level p - 1
    float rows[TILE][SRC + 1];  // the row pass over the window's columns
    float tab[2 * TILE][ENTRY]; // the tile's rows' taps, then its columns'
  } rs;
  struct {
    float lv[HALO][HALO + 1];   // the level's tile and wrapped halo
    float vx[TILE][HALO + 1];   // the vertical taps over halo columns
  } bl;
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float from_bits(uint32_t b) { return __uint_as_float(b << 16); }

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

constexpr int NW = SRC / 4 + 1;           // 8-byte words that cover a window row, at most
constexpr int HW = HALO / 4 + 2;          // ... a halo row
constexpr int NPAIR = TILE / 2 + 2;       // 4-byte pairs that cover a tile row, at most

// columns [xa, xa + n) of nr plane rows (window row i is plane row
// row_of(i), width W), as floats, by 8-byte loads of the aligned words
// that cover them (a word past either end lies in the same 8-byte granule
// as an element of the row, so inside the allocation). `stage_load`
// starts a thread's K loads (L2: the level was written by other blocks)
// and `stage_commit` writes them to dst[i * ld + x - xa], so the loads of
// a tile are in flight together
template <int K>
struct Staged {
  uint2 v[K];
  int e0[K], row[K];
};

template <int WORDS, int K, typename RowOf>
__device__ __forceinline__ Staged<K> stage_load(const uint16_t* __restrict__ plane, int W, int nr,
                                                RowOf row_of, int xa, int n) {
  Staged<K> s;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int it = threadIdx.x + u * THREADS, i = it / WORDS, w = it - i * WORDS;
    s.row[u] = -1;
    s.e0[u] = 0;
    s.v[u] = make_uint2(0u, 0u);
    if (i < nr && n > 0) {
      const uint16_t* p = plane + (size_t)row_of(i) * W + xa;
      const uintptr_t aw = ((uintptr_t)p & ~(uintptr_t)7) + 8 * (uintptr_t)w;
      if (aw < (uintptr_t)(p + n)) {
        s.v[u] = __ldcg((const uint2*)aw);
        s.e0[u] = (int)((intptr_t)(aw - (uintptr_t)p) / 2);
        s.row[u] = i;
      }
    }
  }
  return s;
}

template <int K>
__device__ __forceinline__ void stage_commit(const Staged<K>& s, int n, float* dst, int ld) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (s.row[u] < 0) continue;
    const uint32_t q[4] = {s.v[u].x & 0xffffu, s.v[u].x >> 16, s.v[u].y & 0xffffu,
                           s.v[u].y >> 16};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = s.e0[u] + j;
      if (e >= 0 && e < n) dst[s.row[u] * ld + e] = from_bits(q[j]);
    }
  }
}

// a th x tw tile of bf16 values (val(r, c)) to plane rows r0.., columns
// c0.. of width W: 4-byte stores of the pairs inside the tile, 2-byte
// stores of the elements whose pair straddles its edge; each thread
// computes its pairs' values before it stores any
template <typename Val>
__device__ __forceinline__ void store_tile(uint16_t* __restrict__ plane, int W, int r0, int c0,
                                           int th, int tw, Val val) {
  constexpr int K = (TILE * NPAIR + THREADS - 1) / THREADS;
  uint16_t lo[K], hi[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int it = threadIdx.x + u * THREADS, r = it / NPAIR, q = it - r * NPAIR;
    lo[u] = hi[u] = 0;
    if (r < th) {
      const int lead = (int)((((uintptr_t)(plane + (size_t)(r0 + r) * W + c0)) >> 1) & 1);
      const int c = 2 * q - lead;
      if (c >= 0 && c < tw) lo[u] = val(r, c);
      if (c + 1 >= 0 && c + 1 < tw) hi[u] = val(r, c + 1);
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int it = threadIdx.x + u * THREADS, r = it / NPAIR, q = it - r * NPAIR;
    if (r >= th) continue;
    uint16_t* row = plane + (size_t)(r0 + r) * W + c0;
    const int lead = (int)(((uintptr_t)row >> 1) & 1);   // row[0] is a pair's second half
    const int c = 2 * q - lead;                           // the pair's first element
    const bool in0 = c >= 0 && c < tw, in1 = c + 1 >= 0 && c + 1 < tw;
    if (in0 && in1)
      *(uint32_t*)(row + c) = (uint32_t)lo[u] | ((uint32_t)hi[u] << 16);
    else if (in0)
      row[c] = lo[u];
    else if (in1)
      row[c + 1] = hi[u];
  }
}

// level l's tile (r0, c0) of frame b, resized from level l - 1: its rows'
// and columns' taps go to shared memory with the source window they span
// (the host's spans), all loads in flight together
__device__ void resize_tile(const Work& w, int l, int b, int r0, int c0, Smem& sm) {
  const int H = w.H[l], W = w.W[l], Hp = w.H[l - 1], Wp = w.W[l - 1];
  const int th = min(w.tr[l], H - r0), tw = min(w.tc[l], W - c0);
  const float* rt = w.tab + (size_t)(w.row_tab[l] + r0) * ENTRY;
  const float* ct = w.tab + (size_t)(w.col_tab[l] + c0) * ENTRY;
  const uint16_t* prev = w.level[l - 1] + (size_t)b * Hp * Wp;
  const short2 ys = w.span[w.row_span[l] + r0 / w.tr[l]];
  const short2 xs = w.span[w.col_span[l] + c0 / w.tc[l]];
  const int y0 = ys.x, nr = ys.y, x0 = xs.x, nc = xs.y;
  constexpr int KT = (2 * TILE * ENTRY + THREADS - 1) / THREADS;
  float tv[KT];
#pragma unroll
  for (int u = 0; u < KT; ++u) {
    const int it = threadIdx.x + u * THREADS;
    tv[u] = it < th * ENTRY ? __ldg(rt + it)
            : it >= TILE * ENTRY && it < TILE * ENTRY + tw * ENTRY ? __ldg(ct + it - TILE * ENTRY)
                                                                   : 0.0f;
  }
  const auto win = stage_load<NW, (SRC * NW + THREADS - 1) / THREADS>(
      prev, Wp, nr, [&](int i) { return y0 + i; }, x0, nc);
  stage_commit(win, nc, &sm.rs.win[0][0], SRC + 1);
#pragma unroll
  for (int u = 0; u < KT; ++u) {
    const int it = threadIdx.x + u * THREADS;
    if (it < 2 * TILE * ENTRY) (&sm.rs.tab[0][0])[it] = tv[u];
  }
  __syncthreads();
  // rows: bf16(sum_y wr[y] prev[y, x]) over the window's columns, a column
  // a thread, its rows' chains side by side
  constexpr int RG = THREADS / SRC;   // row groups
  const int c = threadIdx.x % SRC, rg = threadIdx.x / SRC;
  if (c < nc) {
#pragma unroll
    for (int k = 0; k < TILE / RG; ++k) {
      const int r = rg + RG * k;
      if (r >= th) break;
      const float* e = sm.rs.tab[r];
      const int f = (int)e[0] - y0, cnt = (int)e[1];
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < TAPS; ++t)
        if (t < cnt) s = __fadd_rn(s, __fmul_rn(e[2 + t], sm.rs.win[f + t][c]));
      sm.rs.rows[r][c] = bf(s);
    }
  }
  __syncthreads();
  // columns: bf16(sum_x rows[x] wc[x]) over the tile, written as the level
  uint16_t* out = w.out[l] + (size_t)b * H * W;
  store_tile(out, W, r0, c0, th, tw, [&](int r, int cc) {
    const float* e = sm.rs.tab[TILE + cc];
    const int f = (int)e[0] - x0, cnt = (int)e[1];
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
      if (t < cnt) s = __fadd_rn(s, __fmul_rn(sm.rs.rows[r][f + t], e[2 + t]));
    return bits(s);
  });
}

// level l's blurred tile (r0, c0) of frame b
__device__ void blur_tile(const Work& w, int l, int b, int r0, int c0, Smem& sm) {
  const int H = w.H[l], W = w.W[l];
  const uint16_t* src = w.level[l] + (size_t)b * H * W;
  const auto row_of = [&](int i) { return wrap(r0 - RAD + i, H); };
  // the halo's columns c0 - 3 .. c0 + 34: the part inside the level by
  // words, the wrapped columns (at the level's left and right edges) one
  // by one
  const int xa = max(c0 - RAD, 0), xb = min(c0 + TILE + RAD, W);
  const auto inner = stage_load<HW, (HALO * HW + THREADS - 1) / THREADS>(src, W, HALO, row_of,
                                                                         xa, xb - xa);
  const bool edge = c0 - RAD < 0 || c0 + TILE + RAD > W;
  constexpr int KE = (HALO * HALO + THREADS - 1) / THREADS;
  uint16_t v[KE];
  if (edge) {
#pragma unroll
    for (int u = 0; u < KE; ++u) {
      const int it = threadIdx.x + u * THREADS, i = it / HALO, hc = it - i * HALO;
      const int x = c0 - RAD + hc;
      if (i < HALO && (x < 0 || x >= W)) v[u] = __ldcg(src + (size_t)row_of(i) * W + wrap(x, W));
    }
  }
  stage_commit(inner, xb - xa, &sm.bl.lv[0][xa - (c0 - RAD)], HALO + 1);
  if (edge) {
#pragma unroll
    for (int u = 0; u < KE; ++u) {
      const int it = threadIdx.x + u * THREADS, i = it / HALO, hc = it - i * HALO;
      const int x = c0 - RAD + hc;
      if (i < HALO && (x < 0 || x >= W)) sm.bl.lv[i][hc] = from_bits(v[u]);
    }
  }
  __syncthreads();
  const float* tp = w.taps;
  // torch.roll(img, i - 3): tap i reads row y + 3 - i, halo row r + 6 - i
  constexpr int KV = (TILE * HALO + THREADS - 1) / THREADS;
#pragma unroll
  for (int u = 0; u < KV; ++u) {
    const int it = threadIdx.x + u * THREADS, r = it / HALO, c = it - r * HALO;
    if (r >= TILE) break;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t <= 2 * RAD; ++t)
      acc = bf(__fadd_rn(acc, bf(__fmul_rn(tp[t], sm.bl.lv[r + 2 * RAD - t][c]))));
    sm.bl.vx[r][c] = acc;
  }
  __syncthreads();
  uint16_t* out = w.blurred[l] + (size_t)b * H * W;
  store_tile(out, W, r0, c0, min(TILE, H - r0), min(TILE, W - c0), [&](int r, int c) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t <= 2 * RAD; ++t)
      acc = bf(__fadd_rn(acc, bf(__fmul_rn(tp[t], sm.bl.vx[r][c + 2 * RAD - t]))));
    return bits(acc);
  });
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// phase p: level p resized (1 <= p, first <= p < n_levels) and level p - 1
// blurred (with blur, first <= p - 1); each count is per frame
__host__ __device__ inline int resize_tiles(const Work& w, int p) {
  if (p < 1 || p < w.first || p >= w.n_levels) return 0;
  return cdiv(w.H[p], w.tr[p]) * cdiv(w.W[p], w.tc[p]);
}

__host__ __device__ inline int blur_tiles(const Work& w, int p) {
  const int l = p - 1;
  if (!w.blur || l < w.first || l >= w.n_levels) return 0;
  return cdiv(w.H[l], TILE) * cdiv(w.W[l], TILE);
}

__global__ void __launch_bounds__(THREADS) pyramid_kernel(const Work w) {
  __shared__ Smem sm;
  const int p0 = max(w.first, 1), p1 = w.blur ? w.n_levels : w.n_levels - 1;
#ifdef SSPL_PYR_TRACE
  long long t_mark = clock64();
#endif
  for (int p = p0; p <= p1; ++p) {
    if (p > p0) {
#ifdef SSPL_PYR_TRACE
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const long long now = clock64();
        w.trace[2 * (p - 1)] += now - t_mark;
        t_mark = now;
      }
#endif
      cg::this_grid().sync();
#ifdef SSPL_PYR_TRACE
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const long long now = clock64();
        w.trace[2 * (p - 1) + 1] += now - t_mark;
        t_mark = now;
      }
#endif
    }
    const int nr = resize_tiles(w, p), nb = blur_tiles(w, p);
    const int total = w.B * (nr + nb);
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      if (t < w.B * nr) {
        const int b = t / nr, k = t - b * nr, tx = cdiv(w.W[p], w.tc[p]);
        resize_tile(w, p, b, (k / tx) * w.tr[p], (k % tx) * w.tc[p], sm);
      } else {
        const int u = t - w.B * nr, b = u / nb, k = u - b * nb, l = p - 1;
        const int tx = cdiv(w.W[l], TILE);
        blur_tile(w, l, b, (k / tx) * TILE, (k % tx) * TILE, sm);
      }
      __syncthreads();   // the next tile reuses the shared memory
    }
  }
#ifdef SSPL_PYR_TRACE
  if (blockIdx.x == 0 && threadIdx.x == 0) w.trace[2 * p1] += clock64() - t_mark;
#endif
}

}  // namespace

// levels first..n_levels-1 of one call in one launch: level 0 is blurred
// only (when blur is set); level l >= 1 is resized from level l - 1 and,
// with blur, blurred
extern "C" int sspl_pyramid(const void* work, void* stream) {
  const Work w = *(const Work*)work;
  if (w.n_levels > MAX_LEVELS || w.n_levels < 1 || w.B <= 0) return (int)cudaErrorInvalidValue;
  for (int l = 1; l < w.n_levels; ++l)
    if (w.tr[l] < 1 || w.tr[l] > TILE || w.tc[l] < 1 || w.tc[l] > TILE)
      return (int)cudaErrorInvalidValue;
  // the grid: co-resident blocks, at most BLOCKS_PER_SM a multiprocessor
  // (a grid barrier's cost grows with its blocks), per device
  static int co_resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (co_resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pyramid_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    co_resident[dev] = sms * min(per_sm, BLOCKS_PER_SM);
  }
  int most = 1;
  for (int p = max(w.first, 1); p <= w.n_levels; ++p)
    most = max(most, w.B * (resize_tiles(w, p) + blur_tiles(w, p)));
  const int grid = min(most, co_resident[dev]);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&w};
  e = cudaLaunchCooperativeKernel((const void*)pyramid_kernel, dim3(grid),
                                              dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
