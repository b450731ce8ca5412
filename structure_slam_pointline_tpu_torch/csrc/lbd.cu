// Kernel 7: binary line-band descriptors, one block per segment.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lbd.py
// `describe_lines` (:76-179), which packs (gx, gy, intensity) of the whole
// image into one uint32 plane, gathers [L, 24, 9] nearest samples from it
// and reduces band statistics with whole-array ops. Here one block of 256
// threads owns one segment: threads 0..215 each take one (sample, band)
// point, compute the nearest pixel's bf16 Scharr gradient from the image
// directly (the same quantized value the reference's plane holds there:
// 1/16-unit gradient, 8-bit intensity) and the four rectified gradient
// channels in the line frame; 36 threads reduce the per-band channel mean
// and population std over the 24 samples, 9 the normalized-intensity band
// statistics; thread 0 builds the flip-invariant u / w blocks and their
// norms; the 8 warps compare the 256 seeded pairs and pack one word each
// with a ballot.
//
// Bound on the card: neither; 64 segments x 216 samples read ~9 image
// floats each (~0.5 MB mostly from L2) and write 64 x 432 B, a few us of
// bytes at most; the serial reductions (24 and 216 dependent adds) and the
// thread-0 feature assembly set the time. Simple and right first.
//
// Numerics: the torch plain version (describe_lines_plain) op for op with
// sums in sample order; jnp.std is the population std; jnp.round is rintf;
// the uint32 words are unsigned here (the reference's `sp >> 20` is a
// logical shift).

#include "lines.cuh"

namespace {

using namespace lines;

constexpr int S = 24;
constexpr int B = 9;
constexpr int HB = 5;
constexpr int NS = S * B;  // 216
constexpr int D = 100;

__device__ __forceinline__ float jnp_hypot(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  const float hi = fmaxf(a, b), lo = fminf(a, b);
  if (hi == 0.f) return hi;
  const float q = lo / hi;
  return hi * sqrtf(1.0f + q * q);
}

__global__ void lbd_kernel(const float* __restrict__ img, int H, int W,
                           const float* __restrict__ ep, const uint8_t* __restrict__ valid,
                           const int32_t* __restrict__ pairs, const float* __restrict__ ts,
                           int32_t* __restrict__ packed, float* __restrict__ desc_out) {
  __shared__ float st[NS][4];
  __shared__ float si[NS];
  __shared__ float mean[B][4], stdv[B][4], imean[B], istd[B];
  __shared__ float desc[D];
  __shared__ float mu_sd[2];
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const float sx = ep[l * 4 + 0], sy = ep[l * 4 + 1], ex = ep[l * 4 + 2], ey = ep[l * 4 + 3];
  const float length = fmaxf(jnp_hypot(ex - sx, ey - sy), 1e-6f);
  const float dx = (ex - sx) / length, dy = (ey - sy) / length;
  const float nx = -dy, ny = dx;

  if (tid < NS) {
    const int k = tid / B, b = tid % B;
    const float band = ((float)b - 4.0f) * 2.0f;
    const float px = sx + (ex - sx) * ts[k] + nx * band;
    const float py = sy + (ey - sy) * ts[k] + ny * band;
    const int xi = min(max((int)rintf(px), 0), W - 1);
    const int yi = min(max((int)rintf(py), 0), H - 1);
    const Grad g = scharr(img, H, W, yi, xi);
    const uint32_t qgx = (uint32_t)fminf(fmaxf(rintf((g.gx + 128.0f) * 16.0f), 0.f), 4095.f);
    const uint32_t qgy = (uint32_t)fminf(fmaxf(rintf((g.gy + 128.0f) * 16.0f), 0.f), 4095.f);
    const uint32_t qi =
        (uint32_t)fminf(fmaxf(rintf(img[(size_t)yi * W + xi]), 0.f), 255.f);
    const float sgx = (float)qgx * 0.0625f - 128.0f;
    const float sgy = (float)qgy * 0.0625f - 128.0f;
    const float g_par = sgx * dx + sgy * dy;
    const float g_per = sgx * nx + sgy * ny;
    st[tid][0] = fmaxf(g_per, 0.f);
    st[tid][1] = fmaxf(-g_per, 0.f);
    st[tid][2] = fmaxf(g_par, 0.f);
    st[tid][3] = fmaxf(-g_par, 0.f);
    si[tid] = (float)qi;
  }
  __syncthreads();
  if (tid < B * 4) {  // per-band channel mean and population std over samples
    const int b = tid / 4, c = tid % 4;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += st[k * B + b][c];
    const float m = s / (float)S;
    float v = 0.f;
    for (int k = 0; k < S; ++k) {
      const float d = st[k * B + b][c] - m;
      v += d * d;
    }
    mean[b][c] = m;
    stdv[b][c] = sqrtf(v / (float)S);
  } else if (tid == 64) {  // intensity mean / std over all samples
    float s = 0.f;
    for (int i = 0; i < NS; ++i) s += si[i];
    const float m = s / (float)NS;
    float v = 0.f;
    for (int i = 0; i < NS; ++i) {
      const float d = si[i] - m;
      v += d * d;
    }
    mu_sd[0] = m;
    mu_sd[1] = fmaxf(sqrtf(v / (float)NS), 1e-6f);
  }
  __syncthreads();
  if (tid < B) {
    const float m0 = mu_sd[0], s0 = mu_sd[1];
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += (si[k * B + tid] - m0) / s0;
    const float m = s / (float)S;
    float v = 0.f;
    for (int k = 0; k < S; ++k) {
      const float d = (si[k * B + tid] - m0) / s0 - m;
      v += d * d;
    }
    imean[tid] = m;
    istd[tid] = sqrtf(v / (float)S);
  }
  __syncthreads();
  if (tid == 0) {
    const int swap[4] = {1, 0, 3, 2};
    // blocks: u_mean 0, u_std 20, u_int 40, w_mean 50, w_std 70, w_int 90
    for (int b = 0; b < HB; ++b) {
      for (int c = 0; c < 4; ++c) {
        const float vm = mean[b][c], mm = mean[B - 1 - b][swap[c]];
        const float vs = stdv[b][c], ms = stdv[B - 1 - b][swap[c]];
        desc[b * 4 + c] = vm + mm;
        desc[50 + b * 4 + c] = fabsf(vm - mm);
        desc[20 + b * 4 + c] = vs + ms;
        desc[70 + b * 4 + c] = fabsf(vs - ms);
      }
      const float vi[2] = {imean[b], istd[b]};
      const float mi[2] = {imean[B - 1 - b], istd[B - 1 - b]};
      for (int c = 0; c < 2; ++c) {
        desc[40 + b * 2 + c] = vi[c] + mi[c];
        desc[90 + b * 2 + c] = fabsf(vi[c] - mi[c]);
      }
    }
    const int off[7] = {0, 20, 40, 50, 70, 90, 100};
    for (int blk = 0; blk < 6; ++blk) {
      float s = 0.f;
      for (int i = off[blk]; i < off[blk + 1]; ++i) s += desc[i] * desc[i];
      const float nrm = fmaxf(sqrtf(s), 1e-9f);
      for (int i = off[blk]; i < off[blk + 1]; ++i) desc[i] = desc[i] / nrm;
    }
  }
  __syncthreads();
  if (tid < D) desc_out[(size_t)l * D + tid] = desc[tid];
  const bool bit = desc[pairs[tid * 2]] > desc[pairs[tid * 2 + 1]];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((tid & 31) == 0) packed[l * 8 + (tid >> 5)] = valid[l] ? (int32_t)word : 0;
}

}  // namespace

extern "C" int sspl_lbd_describe(const void* img, int H, int W, const void* ep,
                                 const void* valid, int L, const void* pairs, const void* ts,
                                 void* packed, void* desc, void* stream) {
  lbd_kernel<<<L, 256, 0, (cudaStream_t)stream>>>(
      (const float*)img, H, W, (const float*)ep, (const uint8_t*)valid,
      (const int32_t*)pairs, (const float*)ts, (int32_t*)packed, (float*)desc);
  return (int)cudaGetLastError();
}
