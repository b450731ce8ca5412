// Kernel 2: ORB orientation + rotated-BRIEF descriptor, one keypoint per warp.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/orb.py
// `orient_and_describe` (:227) with its pieces `gather_patches` (:119,
// two one-hot interpolation matmuls), `ic_angle` (:177, a moment matmul)
// and `describe` (:191, all 64 rotation banks as one [729, 16384] matmul
// then a one-hot bank select). Here each warp reads the blurred bf16
// level directly: 31 x 32 bilinear row samples into shared memory, the
// 31 x 31 patch from them, the intensity-centroid moments by a warp
// reduction, then only its own bank's 256 tap pairs, packed with
// __ballot_sync (lane l of round w is bit l of word w).
//
// Bound on the card: bytes of the level that the patches touch, i.e. at
// most 32 x 32 bf16 values per keypoint (2 KB) plus 36 B of output; the
// ~4k flops per keypoint sit far below the compute roof. With the 64 KB
// tap table in L2 and patches in shared memory nothing else touches
// device memory. The reference's matmul formulation computed all 64
// banks (64x the tap work) to stay on the TPU's MXU; a warp needs none
// of that.
//
// Numerics match the reference: weights (1 - f) and f are bf16, each
// bilinear row sample is rounded to bf16, then each column sample; the
// moments accumulate in float32 (in another order than XLA, so the angle
// may differ in the last bits); bank = rint(angle / 2pi * 64) mod 64
// (round half to even, as jnp.round); bit = I(p0) < I(p1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 15;
constexpr int P = 2 * R + 1;   // 31
constexpr int RC = P + 1;      // 32 row-sample columns
constexpr int WARPS = 4;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void orb_kernel(const __nv_bfloat16* __restrict__ img, int H, int W,
                           const float* __restrict__ xy, int K,
                           const int8_t* __restrict__ tables,  // [64][256][4]
                           float* __restrict__ angle_out,
                           int32_t* __restrict__ desc_out) {
  __shared__ float rows_s[WARPS][P][RC];
  __shared__ float patch_s[WARPS][P][P + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= K) return;  // whole warp leaves together
  float (*rows)[RC] = rows_s[warp];
  float (*patch)[P + 1] = patch_s[warp];

  float x = fminf(fmaxf(xy[2 * k], (float)R), (float)(W - R - 2));
  float y = fminf(fmaxf(xy[2 * k + 1], (float)R), (float)(H - R - 2));
  float x0f = floorf(x), y0f = floorf(y);
  float fx = bf(x - x0f), fy = bf(y - y0f);
  float wx0 = bf(1.f - fx), wy0 = bf(1.f - fy);
  int x0 = (int)x0f, y0 = (int)y0f;

  for (int idx = lane; idx < P * RC; idx += 32) {
    int i = idx / RC, c = idx % RC;
    size_t o = (size_t)(y0 - R + i) * W + (x0 - R + c);
    float a = __bfloat162float(img[o]);
    float b = __bfloat162float(img[o + W]);
    rows[i][c] = bf(__fadd_rn(__fmul_rn(wy0, a), __fmul_rn(fy, b)));
  }
  __syncwarp();

  float m0 = 0.f, m1 = 0.f;
  for (int idx = lane; idx < P * P; idx += 32) {
    int i = idx / P, j = idx % P;
    float v = bf(__fadd_rn(__fmul_rn(wx0, rows[i][j]), __fmul_rn(fx, rows[i][j + 1])));
    patch[i][j] = v;
    int dx = j - R, dy = i - R;
    if (dx * dx + dy * dy <= R * R) {
      m0 = __fadd_rn(m0, __fmul_rn((float)dx, v));
      m1 = __fadd_rn(m1, __fmul_rn((float)dy, v));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m0 += __shfl_xor_sync(0xffffffffu, m0, off);
    m1 += __shfl_xor_sync(0xffffffffu, m1, off);
  }
  __syncwarp();

  const float ang = atan2f(m1, m0);
  int bank = (int)rintf(__fmul_rn(__fdiv_rn(ang, 6.28318530717958647692f), 64.f));
  bank = ((bank % 64) + 64) % 64;
  const int8_t* tb = tables + (size_t)bank * 256 * 4;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int8_t* t = tb + (w * 32 + lane) * 4;
    float i0 = patch[R + t[1]][R + t[0]];
    float i1 = patch[R + t[3]][R + t[2]];
    unsigned word = __ballot_sync(0xffffffffu, i0 < i1);
    if (lane == 0) desc_out[(size_t)k * 8 + w] = (int32_t)word;
  }
  if (lane == 0) angle_out[k] = ang;
}

}  // namespace

extern "C" int sspl_orb_describe(const void* img, int H, int W, const void* xy, int K,
                                 const void* tables, void* angle, void* desc,
                                 void* stream) {
  int blocks = (K + WARPS - 1) / WARPS;
  orb_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)img, H, W, (const float*)xy, K, (const int8_t*)tables,
      (float*)angle, (int32_t*)desc);
  return (int)cudaGetLastError();
}
