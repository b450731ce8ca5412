// Kernel 1: FAST-9/16 corner score + 3x3 non-maximum suppression.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/fast.py
// `fast_score` (:39, 16 rolled copies of the level and a doubling
// sliding-window min) and `nms3` (:73, a reduce_window max pool) with one
// stencil kernel per pyramid level: one thread per output pixel, the
// level tile plus a 4 px halo (3 for the Bresenham circle, 1 for the NMS
// window) staged once in shared memory, the raw score of the tile plus a
// 1 px ring computed into shared memory, then the 3x3 max read from it.
//
// Bound on the card: operations, narrowly. Per pixel it reads one bf16
// value and writes two float32 maps (10 B/px, 3.0 ps/px at 3.35 TB/s)
// and does ~320 subtract / min / max operations on the CUDA cores
// (4.8 ps/px at 67 TFLOP/s). The design keeps every intermediate (16
// differences, arc minima, the jittered NMS input) on chip: device memory
// sees only the level once and the two maps once.
//
// Numerics follow the reference op for op (checked against XLA:CPU):
// every difference is rounded to bf16, the NMS jitter is the bf16
// product bf16((y*131 + x*31) % 251) * bf16(1e-5), and score + jitter is
// rounded to bf16. The circle offsets wrap at the image border like
// jnp.roll; the NMS window does not (reduce_window pads with -inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;  // staged image tile width
constexpr int SH = TY + 2 * HALO;
constexpr int QW = TX + 2;         // score tile (+1 ring for NMS)
constexpr int QH = TY + 2;

__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void fast_nms_kernel(const __nv_bfloat16* __restrict__ img,
                                float* __restrict__ raw_out,
                                float* __restrict__ nms_out, int H, int W) {
  __shared__ float tile[SH][SW];
  __shared__ float sc[QH][QW];     // jittered score (NMS input), -inf outside
  __shared__ float rawq[QH][QW];   // raw score
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const __nv_bfloat16 jscale = __float2bfloat16_rn(1e-5f);

  for (int i = tid; i < SH * SW; i += TX * TY) {
    int ty = i / SW, tx = i % SW;
    int gy = wrap(y0 - HALO + ty, H), gx = wrap(x0 - HALO + tx, W);
    tile[ty][tx] = __bfloat162float(img[(size_t)gy * W + gx]);
  }
  __syncthreads();

  for (int i = tid; i < QH * QW; i += TX * TY) {
    int qy = i / QW, qx = i % QW;
    int gy = y0 - 1 + qy, gx = x0 - 1 + qx;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      sc[qy][qx] = -INFINITY;
      rawq[qy][qx] = 0.f;
      continue;
    }
    int ty = qy + HALO - 1, tx = qx + HALO - 1;
    float p = tile[ty][tx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = bf(tile[ty + c_dy[k]][tx + c_dx[k]] - p);
    float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float mn = INFINITY, mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        float v = d[(k + j) & 15];
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
      bright = fmaxf(bright, mn);
      dark = fmaxf(dark, -mx);
    }
    float s = fmaxf(fmaxf(bright, dark), 0.f);
    bool inside = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3;
    s = inside ? s : 0.f;
    rawq[qy][qx] = s;
    if (s > 0.f) {
      float k = (float)((gy * 131 + gx * 31) % 251);
      float jit = __bfloat162float(__hmul(__float2bfloat16_rn(k), jscale));
      s = bf(s + jit);
    }
    sc[qy][qx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const int qy = threadIdx.y + 1, qx = threadIdx.x + 1;
  float pooled = -INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) pooled = fmaxf(pooled, sc[qy + dy][qx + dx]);
  const float r = rawq[qy][qx];
  const size_t o = (size_t)gy * W + gx;
  raw_out[o] = r;
  nms_out[o] = sc[qy][qx] >= pooled ? r : 0.f;
}

}  // namespace

extern "C" int sspl_fast_nms(const void* img, void* raw, void* nms, int H, int W,
                             void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)img, (float*)raw, (float*)nms, H, W);
  return (int)cudaGetLastError();
}
