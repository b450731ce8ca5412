// Kernel 25: the bf16 image pyramid and its blurred planes, one launch per
// level for a frame or a [B, H, W] stack of frames (grid z).
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/pyramid.py
// `build_pyramid` (:57, each level `jax.image.resize(..., "bilinear")` of
// the previous one: two contractions with dense antialiased weight
// matrices) and `blur` (:41, 2 x 7 rolled taps, each a bf16 product and a
// bf16 add, "effectively free" on the TPU's vector unit). The plain
// version (ops/pyramid.py build_blurred_pyramid_plain) runs two float32
// matmuls per level and 56 small elementwise ops per blurred plane.
//
// One launch writes level l and its blurred plane. A block owns a 32 x 32
// tile of the new level: it resizes the tile and a 3-pixel wrapped halo
// from level l - 1 (read from device memory or L2), keeps them in shared
// memory, runs the 7 vertical taps over tile rows x halo columns and the
// 7 horizontal taps over the tile, and writes both planes once. Level 0 is
// blurred only. The same launch serves the one-op forms `resize_bilinear`
// (no blur) and `blur` (no resize).
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
// Bound on the card: bytes. Each level is read once by the next (its
// halo re-reads stay in L2), each level and blurred plane written once:
// ~2.3 MB a 640 x 480 frame over 8 levels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TAPS = 8;           // resize taps per output index (at most)
constexpr int ENTRY = 2 + TAPS;   // (first, count, w[TAPS]) per output index
constexpr int TILE = 32;
constexpr int RAD = 3;            // blur radius (7 taps)
constexpr int HALO = TILE + 2 * RAD;
constexpr int THREADS = 256;

// the host's description of one call (ops/pyramid.py _PyrWork)
struct Work {
  int B, n_levels, first, blur;  // levels first..n_levels-1; blur: write blurred planes
  int H[MAX_LEVELS], W[MAX_LEVELS];
  int row_tab[MAX_LEVELS], col_tab[MAX_LEVELS];  // level l's entries in tab
  const uint16_t* level[MAX_LEVELS];  // level 0 is the input; bf16 bits [B, H, W]
  uint16_t* out[MAX_LEVELS];          // levels written (l >= 1)
  uint16_t* blurred[MAX_LEVELS];
  const float* tab;                   // [entries, ENTRY] resize taps
  float taps[2 * RAD + 1];            // bf16-rounded blur weights
};

__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float((uint32_t)(*p) << 16);
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// level l's pixel (y, x) resized from `prev` [Hp, Wp]: rows contracted
// first, each sum rounded to bf16
__device__ __forceinline__ float resize_at(const uint16_t* __restrict__ prev, int Wp,
                                           const float* __restrict__ rt,
                                           const float* __restrict__ ct) {
  const int y0 = (int)rt[0], ny = (int)rt[1];
  const int x0 = (int)ct[0], nx = (int)ct[1];
  float out = 0.0f;
  for (int i = 0; i < nx; ++i) {
    const uint16_t* col = prev + x0 + i;
    float s = 0.0f;
    for (int k = 0; k < ny; ++k)
      s = __fadd_rn(s, __fmul_rn(rt[2 + k], ld(col + (size_t)(y0 + k) * Wp)));
    out = __fadd_rn(out, __fmul_rn(bf(s), ct[2 + i]));
  }
  return bf(out);
}

template <bool RESIZE, bool BLUR>
__global__ void __launch_bounds__(THREADS) level_kernel(const Work w, int l) {
  __shared__ float lv[HALO][HALO + 1];   // the level's tile and wrapped halo
  __shared__ float vx[TILE][HALO + 1];   // the vertical taps over halo columns
  const int H = w.H[l], W = w.W[l];
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const size_t plane = (size_t)H * W;
  const int b = blockIdx.z;
  const uint16_t* prev = nullptr;
  int Hp = 0, Wp = 0;
  const float* rtab = nullptr;
  const float* ctab = nullptr;
  if (RESIZE) {
    Hp = w.H[l - 1];
    Wp = w.W[l - 1];
    prev = w.level[l - 1] + (size_t)b * Hp * Wp;
    rtab = w.tab + (size_t)w.row_tab[l] * ENTRY;
    ctab = w.tab + (size_t)w.col_tab[l] * ENTRY;
  }
  const uint16_t* src = RESIZE ? nullptr : w.level[l] + (size_t)b * plane;
  const int span = BLUR ? HALO : TILE;
  const int off = BLUR ? RAD : 0;
  for (int i = threadIdx.x; i < span * span; i += THREADS) {
    const int hr = i / span, hc = i - hr * span;
    const int y = r0 + hr - off, x = c0 + hc - off;
    const int gy = wrap(y, H), gx = wrap(x, W);
    float v;
    if (RESIZE)
      v = resize_at(prev, Wp, rtab + (size_t)gy * ENTRY, ctab + (size_t)gx * ENTRY);
    else
      v = ld(src + (size_t)gy * W + gx);
    lv[hr][hc] = v;
    const bool inner = hr >= off && hr < off + TILE && hc >= off && hc < off + TILE;
    if (RESIZE && inner && y < H && x < W)
      w.out[l][(size_t)b * plane + (size_t)y * W + x] = bits(v);
  }
  if (!BLUR) return;
  __syncthreads();
  const float* tp = w.taps;
  // torch.roll(img, i - 3): tap i reads row y + 3 - i, halo row r + 6 - i
  for (int i = threadIdx.x; i < TILE * HALO; i += THREADS) {
    const int r = i / HALO, c = i - r * HALO;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t <= 2 * RAD; ++t) acc = bf(__fadd_rn(acc, bf(__fmul_rn(tp[t], lv[r + 2 * RAD - t][c]))));
    vx[r][c] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int r = i / TILE, c = i - r * TILE;
    const int y = r0 + r, x = c0 + c;
    if (y >= H || x >= W) continue;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t <= 2 * RAD; ++t) acc = bf(__fadd_rn(acc, bf(__fmul_rn(tp[t], vx[r][c + 2 * RAD - t]))));
    w.blurred[l][(size_t)b * plane + (size_t)y * W + x] = bits(acc);
  }
}

template <bool RESIZE, bool BLUR>
int launch(const Work& w, int l, cudaStream_t s) {
  dim3 grid((w.W[l] + TILE - 1) / TILE, (w.H[l] + TILE - 1) / TILE, w.B);
  level_kernel<RESIZE, BLUR><<<grid, THREADS, 0, s>>>(w, l);
  return (int)cudaGetLastError();
}

}  // namespace

// levels first..n_levels-1 of one call: level 0 is blurred only (when
// blur is set); level l >= 1 is resized from level l - 1 and, with blur,
// blurred in the same launch
extern "C" int sspl_pyramid(const void* work, void* stream) {
  const Work w = *(const Work*)work;
  cudaStream_t s = (cudaStream_t)stream;
  if (w.n_levels > MAX_LEVELS || w.B <= 0) return (int)cudaErrorInvalidValue;
  for (int l = w.first; l < w.n_levels; ++l) {
    int e;
    if (l == 0)
      e = w.blur ? launch<false, true>(w, 0, s) : 0;
    else
      e = w.blur ? launch<true, true>(w, l, s) : launch<true, false>(w, l, s);
    if (e) return e;
  }
  return 0;
}
