// Device helpers shared by the line kernels (lsd_support.cu, lsd_refine.cu,
// lbd.cu): the reference's bf16 Scharr gradient at one pixel (or from its
// eight taps), glibc's atan2f (the function XLA:CPU calls for jnp.arctan2)
// step for step, and jnp.mod / the undirected angle difference. Built with
// -fmad=false, so every multiply and add rounds on its own as in the torch
// plain versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lines {

// float32 constants the reference's weakly typed Python floats become
constexpr float PI = 3.14159274101257324f;          // 0x40490fdb
constexpr float HALF_PI = 1.57079637050628662f;     // 0x3fc90fdb
constexpr float QUARTER_PI = 0.785398185253143311f;  // 0x3f490fdb
constexpr float TWO_PI = 6.28318548202514648f;      // 0x40c90fdb
constexpr float SQRT2 = 1.41421353816986084f;       // sqrt(2) in float32

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ float jmod(float x, float y) {  // jnp.mod (floor)
  float r = fmodf(x, y);
  return (r != 0.f && ((r < 0.f) != (y < 0.f))) ? r + y : r;
}

__device__ __forceinline__ float angle_diff(float a, float b) {
  return fabsf(jmod(a - b + HALF_PI, PI) - HALF_PI);
}

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

// glibc 2.36 atanf of t >= 0 (sysdeps/ieee754/flt-32/s_atanf.c)
__device__ __forceinline__ float atanf_nonneg(float t) {
  const int32_t it = __float_as_int(t);
  if (it >= 0x4c000000) return f32(0x3fc90fda) + f32(0x33a22168);
  if (it < 0x31000000) return t;
  float x;
  int id;
  if (it < 0x3ee00000) {
    id = -1;
    x = t;
  } else if (it < 0x3f300000) {
    id = 0;
    x = (2.0f * t - 1.0f) / (2.0f + t);
  } else if (it < 0x3f980000) {
    id = 1;
    x = (t - 1.0f) / (t + 1.0f);
  } else if (it < 0x401c0000) {
    id = 2;
    x = (t - 1.5f) / (1.0f + 1.5f * t);
  } else {
    id = 3;
    x = -1.0f / t;
  }
  const float z = x * x;
  const float w = z * z;
  const float a0 = f32(0x3eaaaaab), a1 = f32(0xbe4ccccd), a2 = f32(0x3e124925);
  const float a3 = f32(0xbde38e38), a4 = f32(0x3dba2e6e), a5 = f32(0xbd9d8795);
  const float a6 = f32(0x3d886b35), a7 = f32(0xbd6ef16b), a8 = f32(0x3d4bda59);
  const float a9 = f32(0xbd15a221), a10 = f32(0x3c8569d7);
  const float p1 = z * (a0 + w * (a2 + w * (a4 + w * (a6 + w * (a8 + w * a10)))));
  const float p2 = w * (a1 + w * (a3 + w * (a5 + w * (a7 + w * a9))));
  const float xs = x * (p1 + p2);
  if (id < 0) return x - xs;
  const float hi[4] = {f32(0x3eed6338), f32(0x3f490fda), f32(0x3f7b985e), f32(0x3fc90fda)};
  const float lo[4] = {f32(0x31ac3769), f32(0x33222168), f32(0x33140fb4), f32(0x33a22168)};
  return hi[id] - ((xs - lo[id]) - x);
}

// glibc 2.36 atan2f (sysdeps/ieee754/flt-32/e_atan2f.c), finite arguments
__device__ __forceinline__ float atan2_glibc(float y, float x) {
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  const bool neg_x = hx < 0, neg_y = hy < 0;
  if (iy == 0) return neg_x ? (neg_y ? -PI : PI) : y;
  if (ix == 0) return neg_y ? -HALF_PI : HALF_PI;
  const int32_t k = (iy - ix) >> 23;
  const float pi_lo = f32(0xb3bbbd2e);
  float z;
  if (k > 60) {
    z = HALF_PI + 0.5f * pi_lo;
  } else if (neg_x && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_nonneg(fabsf(y / x));
  }
  if (!neg_x) return neg_y ? -z : z;
  return neg_y ? (z - pi_lo) - PI : PI - (z - pi_lo);
}

// the reference's bf16 Scharr gradient at (y, x) of a float32 image,
// wrapped taps, every op rounded to bf16 (ops/lsd.py:54-75)
struct Grad {
  float gx, gy, sq;  // bf16 values; sq = bf16(gx^2 + gy^2)
};

// the gradient from its eight taps, each already rounded to bf16: a b c
// above, d f beside, g h i below the pixel
__device__ __forceinline__ Grad scharr_taps(float a, float b, float c, float d, float f,
                                            float g, float h, float i) {
  const float d_m = bf(c - a), d_0 = bf(f - d), d_p = bf(i - g);
  const float gx = bf(bf(bf(3.0f * bf(d_m + d_p)) + bf(10.0f * d_0)) * 0.03125f);
  const float r_m = bf(g - a), r_0 = bf(h - b), r_p = bf(i - c);
  const float gy = bf(bf(bf(3.0f * bf(r_m + r_p)) + bf(10.0f * r_0)) * 0.03125f);
  Grad out;
  out.gx = gx;
  out.gy = gy;
  out.sq = bf(bf(gx * gx) + bf(gy * gy));
  return out;
}

__device__ __forceinline__ Grad scharr(const float* __restrict__ img, int H, int W, int y,
                                       int x) {
  const int ym = wrap(y - 1, H), yp = wrap(y + 1, H);
  const int xm = wrap(x - 1, W), xp = wrap(x + 1, W);
  const float* rm = img + (size_t)ym * W;
  const float* r0 = img + (size_t)y * W;
  const float* rp = img + (size_t)yp * W;
  return scharr_taps(bf(rm[xm]), bf(rm[x]), bf(rm[xp]), bf(r0[xm]), bf(r0[xp]), bf(rp[xm]),
                     bf(rp[x]), bf(rp[xp]));
}

}  // namespace lines
