// Kernel 1: FAST-9/16 corner score + 3x3 non-maximum suppression, every
// pyramid level of a frame (or of a [B, H, W] stack) in one launch.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/fast.py
// `fast_score` (:39, 16 rolled copies of the level and a doubling
// sliding-window min) and `nms3` (:73, a reduce_window max pool), which the
// reference runs once per level (ops/extract.py:61-64).
//
// The host's level table (`Work`, ops/fast.py _FastWork) holds each level's
// H, W, source plane and the two output maps (float32 views of one buffer,
// each on a 16-byte boundary); the launcher adds each level's tile count
// and block prefix. A block finds its level from the prefix, its tile from
// the rest, and its frame on grid y (per-frame stride H * W). A tile is
// 60 x 30 output pixels for 256 threads:
//   stage   the tile plus a 4 px halo (3 for the Bresenham circle, 1 for
//           the NMS ring) as bf16 pairs in two copies, one starting on even
//           columns and one on odd, so every circle read is one aligned
//           32-bit shared load. Interior tiles load 32-bit words of the
//           level (two per pair, neighbouring lanes on neighbouring words)
//           and split them with byte permutes; border tiles load element by
//           element through the circle's wrap (jnp.roll).
//   score   the tile plus its 1 px ring, 64 x 32 pixels, is exactly 1024
//           pixel pairs: a lane per pair column, each warp 4 rows, one pass
//           with every thread live. Two pixels a thread in packed bf16: 16
//           differences (__hsub2), the 9-arc minima and maxima by doubling
//           (m2, m4, m8, then m9, as the reference's window_min), the
//           bright and dark maxima. The border zeroing, the jitter and the
//           -inf outside the image per pixel in float32; the horizontal 3-max
//           of the NMS input across lanes by shuffles. The raw score, the
//           jittered score and its horizontal max go to shared memory.
//   write   a warp per output row, a lane per aligned pixel pair of the
//           maps (pairs start on even elements of the map, so a row of odd
//           width shifts them by one): the vertical 3-max, the NMS test,
//           float2 stores (scalar stores for a pair half outside the tile).
//
// Bound on the card: bytes, narrowly. Per pixel it reads one bf16 value
// and writes two float32 maps (10 B/px, 3.0 ps/px at 3.35 TB/s); the arcs
// by doubling need ~183 subtract / min / max operations a pixel (2.7 ps/px
// at 67 TFLOP/s; the reference's 9-term arcs ~320), and the packed form
// issues ~90 instructions a pixel. Device memory sees only the level once
// and the two maps once.
//
// Numerics follow the reference op for op (checked against XLA:CPU): every
// difference is the bf16 rounding of the exact difference (__hsub2 rounds
// to nearest once), the NMS jitter is the bf16 product
// bf16((y*131 + x*31) % 251) * bf16(1e-5), and score + jitter is rounded to
// bf16. The circle offsets wrap at the image border like jnp.roll (no
// pixel inside the 3 px border reads a wrapped value, and the border's
// scores are zeroed); the NMS window does not wrap (reduce_window pads with
// -inf).
//
// A [B, H, W] stack (the data-parallel frontend, parallel/batch_frontend.py,
// the reference's vmap at structure_slam_pointline_tpu/parallel/
// batch_frontend.py:36) is the same launch with B on grid y, counted apart
// by the wrapper as `fast_nms_batch`: each frame's maps bit-equal to its
// single-frame call's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 60;           // output tile width
constexpr int TY = 30;           // output tile height
constexpr int QW = 64;           // score columns: x0-2 .. x0+61 (32 pairs)
constexpr int QH = TY + 2;       // score rows: y0-1 .. y0+TY
constexpr int SR = TY + 8;       // staged rows: y0-4 .. y0+TY+3
constexpr int SP = QW / 2 + 4;   // staged pairs a row: from column x0-6
constexpr int OP = TX / 2 + 1;   // output pairs a row (one more for odd starts)
constexpr unsigned FULL = 0xffffffffu;

// the host's description of one call (ops/fast.py _FastWork)
struct Work {
  const void* img[MAXL];   // [B, h, w] bf16 levels
  float* raw[MAXL];        // [B, h, w] outputs
  float* nms[MAXL];
  int h[MAXL], w[MAXL];
  int L, B;
};

// the launch's parameters: the table plus each level's tiles
struct Plan {
  Work w;
  int tiles_x[MAXL];
  int blk_off[MAXL + 1];
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// the Bresenham circle of radius 3, clockwise, the reference's order: x
// offsets 0 1 2 3 3 3 2 1 0 -1 -2 -3 -3 -3 -2 -1; the y offset of point k
// is the x offset of point k + 4
__host__ __device__ constexpr int circle_dx(int k) {
  return (k & 15) < 4 ? (k & 15) : (k & 15) < 6 ? 3 : (k & 15) < 12 ? 8 - (k & 15)
         : (k & 15) < 14 ? -3 : (k & 15) - 16;
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS) fast_nms_kernel(const Plan p) {
  __shared__ uint32_t even_s[SR][SP];   // pairs (x0-6+2j, x0-5+2j)
  __shared__ uint32_t odd_s[SR][SP];    // pairs (x0-5+2j, x0-4+2j)
  __shared__ __align__(8) float raw_s[QH][QW];    // raw score
  __shared__ __align__(8) float sc_s[QH][QW];     // jittered score (NMS input), -inf outside
  __shared__ __align__(8) float hmax_s[QH][QW];   // its max over columns c-1..c+1

  int l = 0;
  const int blk = blockIdx.x;
  while (l + 1 < p.w.L && blk >= p.blk_off[l + 1]) ++l;
  const int t = blk - p.blk_off[l];
  const int H = p.w.h[l], W = p.w.w[l];
  const int x0 = (t % p.tiles_x[l]) * TX;
  const int y0 = (t / p.tiles_x[l]) * TY;
  const size_t frame = (size_t)blockIdx.y * H * W;
  const uint16_t* img = static_cast<const uint16_t*>(p.w.img[l]) + frame;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // stage: rows y0-4 .. y0+TY+3, columns x0-6 .. x0+66
  const bool inner = x0 >= 8 && x0 + 68 <= W && y0 >= 4 && y0 + TY + 4 <= H;
  for (int i = tid; i < SR * SP; i += THREADS) {
    const int r = i / SP, j = i - r * SP;
    const int gy = y0 - 4 + r, gx = x0 - 6 + 2 * j;
    uint32_t ev, od;
    if (inner) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(img + (size_t)gy * W + gx);
      const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
      const uint32_t w0 = __ldg(q), w1 = __ldg(q + 1);
      const uint32_t mid = __byte_perm(w0, w1, 0x5432);
      // element gx on an even 2-byte slot: w0 = (gx, gx+1); else w1 = (gx+1, gx+2)
      ev = (a & 2) ? mid : w0;
      od = (a & 2) ? w1 : mid;
    } else {
      const size_t row = (size_t)wrap(gy, H) * W;
      const uint32_t e0 = img[row + wrap(gx, W)];
      const uint32_t e1 = img[row + wrap(gx + 1, W)];
      const uint32_t e2 = img[row + wrap(gx + 2, W)];
      ev = e0 | (e1 << 16);
      od = e1 | (e2 << 16);
    }
    even_s[r][j] = ev;
    odd_s[r][j] = od;
  }
  __syncthreads();

  const __nv_bfloat16 jscale = __float2bfloat16_rn(1e-5f);
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);

  // score: pair column `lane` (pixels x0-2+2*lane, +1), rows warp + 8 m
#pragma unroll 1
  for (int qr = warp; qr < QH; qr += WARPS) {
    const int r = qr + 3;   // staged row of the score row
    const __nv_bfloat162 c = as_bf2(even_s[r][lane + 2]);
    __nv_bfloat162 d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int dx = circle_dx(k), dy = circle_dx(k + 4);   // constants once unrolled
      const uint32_t v = (dx & 1) ? odd_s[r + dy][lane + (dx + 3) / 2]
                                  : even_s[r + dy][lane + 2 + dx / 2];
      d[k] = __hsub2(as_bf2(v), c);
    }
    __nv_bfloat162 lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      lo2[k] = __hmin2(d[k], d[(k + 1) & 15]);
      hi2[k] = __hmax2(d[k], d[(k + 1) & 15]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      lo4[k] = __hmin2(lo2[k], lo2[(k + 2) & 15]);
      hi4[k] = __hmax2(hi2[k], hi2[(k + 2) & 15]);
    }
    __nv_bfloat162 bright, dark;   // max of the arcs' minima; min of their maxima
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const __nv_bfloat162 lo9 = __hmin2(__hmin2(lo4[k], lo4[(k + 4) & 15]), d[(k + 8) & 15]);
      const __nv_bfloat162 hi9 = __hmax2(__hmax2(hi4[k], hi4[(k + 4) & 15]), d[(k + 8) & 15]);
      bright = k ? __hmax2(bright, lo9) : lo9;
      dark = k ? __hmin2(dark, hi9) : hi9;
    }
    const __nv_bfloat162 s2 = __hmax2(__hmax2(bright, __hneg2(dark)), zero2);

    const int gy = y0 - 1 + qr;
    float s[2], raw[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gx = x0 - 2 + 2 * lane + e;
      float v = __bfloat162float(e ? s2.y : s2.x);
      const bool inside = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
      v = inside ? v : 0.f;
      raw[e] = v;
      if (v > 0.f) {
        const float k = (float)((gy * 131 + gx * 31) % 251);
        const float jit = __bfloat162float(__hmul(__float2bfloat16_rn(k), jscale));
        v = bf(v + jit);
      }
      const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
      s[e] = in_img ? v : -INFINITY;
      raw[e] = in_img ? raw[e] : 0.f;
    }
    float left = __shfl_up_sync(FULL, s[1], 1);
    float right = __shfl_down_sync(FULL, s[0], 1);
    left = lane == 0 ? -INFINITY : left;     // column x0-3: never needed
    right = lane == 31 ? -INFINITY : right;  // column x0+62: never needed
    *reinterpret_cast<float2*>(&raw_s[qr][2 * lane]) = make_float2(raw[0], raw[1]);
    *reinterpret_cast<float2*>(&sc_s[qr][2 * lane]) = make_float2(s[0], s[1]);
    *reinterpret_cast<float2*>(&hmax_s[qr][2 * lane]) =
        make_float2(fmaxf(fmaxf(left, s[0]), s[1]), fmaxf(fmaxf(s[0], s[1]), right));
  }
  __syncthreads();

  // write: output row y0 + oy a warp, aligned pixel pair `lane` of it
  float* raw_out = p.w.raw[l] + frame;
  float* nms_out = p.w.nms[l] + frame;
  const int x_end = min(x0 + TX, W);
  for (int oy = warp; oy < TY; oy += WARPS) {
    const int gy = y0 + oy;
    if (gy >= H || lane >= OP) continue;
    const size_t row = (size_t)gy * W;
    const int par = (int)((frame + row + x0) & 1);   // the map's pairs start on even elements
    const int xa = x0 - par + 2 * lane;
    const int qr = oy + 1;
    float rv[2], nv[2];
    bool own[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gx = xa + e;
      own[e] = gx >= x0 && gx < x_end;
      const int c = gx - x0 + 2;   // score column, 1 .. 62 for gx in x0-1 .. x0+60
      const int cc = min(max(c, 1), QW - 2);
      const float pooled = fmaxf(fmaxf(hmax_s[qr - 1][cc], hmax_s[qr][cc]), hmax_s[qr + 1][cc]);
      rv[e] = raw_s[qr][cc];
      nv[e] = sc_s[qr][cc] >= pooled ? rv[e] : 0.f;
    }
    const long long o = (long long)row + xa;   // xa is x0 - 1 for an odd start
    if (own[0] && own[1]) {
      *reinterpret_cast<float2*>(raw_out + o) = make_float2(rv[0], rv[1]);
      *reinterpret_cast<float2*>(nms_out + o) = make_float2(nv[0], nv[1]);
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (own[e]) {
          raw_out[o + e] = rv[e];
          nms_out[o + e] = nv[e];
        }
      }
    }
  }
}

int launch(const void* work, void* stream) {
  Plan p;
  p.w = *static_cast<const Work*>(work);
  if (p.w.L < 1 || p.w.L > MAXL || p.w.B < 1 || p.w.B > 65535) return (int)cudaErrorInvalidValue;
  p.blk_off[0] = 0;
  for (int l = 0; l < p.w.L; ++l) {
    if (p.w.h[l] < 1 || p.w.w[l] < 1 || !p.w.img[l] || !p.w.raw[l] || !p.w.nms[l])
      return (int)cudaErrorInvalidValue;
    // the maps' float2 stores need 8-byte aligned bases
    if ((reinterpret_cast<uintptr_t>(p.w.raw[l]) | reinterpret_cast<uintptr_t>(p.w.nms[l])) & 7)
      return (int)cudaErrorMisalignedAddress;
    p.tiles_x[l] = (p.w.w[l] + TX - 1) / TX;
    p.blk_off[l + 1] = p.blk_off[l] + p.tiles_x[l] * ((p.w.h[l] + TY - 1) / TY);
  }
  for (int l = p.w.L; l < MAXL; ++l) p.blk_off[l + 1] = p.blk_off[l];
  fast_nms_kernel<<<dim3(p.blk_off[p.w.L], p.w.B), THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_fast_nms(const void* work, void* stream) { return launch(work, stream); }
