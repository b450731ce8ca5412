// Kernel 2: ORB orientation + rotated-BRIEF descriptor, every keypoint of a
// frame (or of a [B, H, W] stack) over all pyramid levels in one launch, a
// warp per keypoint.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/orb.py
// `orient_and_describe` (:227) with its pieces `gather_patches` (:119,
// two one-hot interpolation matmuls), `ic_angle` (:177, a moment matmul)
// and `describe` (:191, all 64 rotation banks as one [729, 16384] matmul
// then a one-hot bank select), which the reference runs once per level
// (ops/extract.py:73-81), and the per-level glue around it there: the
// level-0 coordinates xy * scale, the octave column and the concatenation.
//
// The host's table (`Work`, ops/orb.py _OrbWork) holds each level's
// blurred bf16 plane, H, W, scale, octave and first keypoint (the prefix of
// the budgets, kernel 11's output offsets). Keypoint k of the frame finds
// its level from the prefix and reads its xy from kernel 11's unsplit
// [B, K, 2] buffer; the outputs are the frame's Keypoints columns: angle
// [K], desc [K, 8], and with a table that asks for them xy0 [K, 2] and
// octave [K]. A warp's work, latency first:
//   rows    lane c loads column x0-15+c of the 32 rows y0-15 .. y0+16, all
//           32 loads issued before the first is used (one or two L2 round
//           trips, not one per row), then its 31 bilinear row samples in
//           registers;
//   columns patch[i][j] from lane j's row sample i and lane j+1's
//           (__shfl_down_sync), in registers; the intensity-centroid
//           moments a lane per column, then summed across the warp; the
//           patch goes to shared memory only for the taps;
//   taps    the bank from atan2, its 8 words of tap offsets a lane loads at
//           once (int8 x 4, the 64 KB table stays in L2), 256 tests as 8
//           ballots (lane l of round w is bit l of word w), one 32-byte
//           store of the words.
//
// Bound on the card: bytes of the level that the patches touch, at most
// 32 x 32 bf16 values a keypoint (2 KB), plus its 8 B of xy and ~50 B of
// output; the ~4k flops a keypoint sit far below the compute roof. The
// reference's matmul formulation computed all 64 banks (64x the tap work)
// to stay on the TPU's MXU; a warp needs none of that.
//
// Numerics match the reference: weights (1 - f) and f are bf16, each
// bilinear row sample is rounded to bf16, then each column sample; the
// moments accumulate in float32 (in another order than XLA, so the angle
// may differ in the last bits); bank = rint(angle / 2pi * 64) mod 64
// (round half to even, as jnp.round); bit = I(p0) < I(p1); xy0 is the
// float32 product xy * scale.
//
// A [B, H, W] stack (the data-parallel frontend, the reference's vmap in
// parallel/batch_frontend.py:36) is the same launch with the frame on grid
// y and per-frame strides, counted apart by the wrapper as
// `orb_describe_batch`: each frame's outputs bit-equal to its single-frame
// call's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 16;
constexpr int R = 15;
constexpr int P = 2 * R + 1;   // 31
constexpr int WARPS = 4;       // keypoints (warps) a block
constexpr unsigned FULL = 0xffffffffu;

// the host's description of one call (ops/orb.py _OrbWork)
struct Work {
  const void* img[MAXL];     // [B, h, w] blurred bf16 levels
  int h[MAXL], w[MAXL];
  int first[MAXL];           // each level's first keypoint (prefix of the budgets)
  int octave[MAXL];          // each level's pyramid level
  float scale[MAXL];         // each level's scale to level 0
  int L, B, K;               // levels, frames, keypoints a frame
  const float* xy;           // [B, K, 2] level coordinates
  const int8_t* tables;      // [64][256][4] rotated taps (dx0, dy0, dx1, dy1)
  float* angle;              // [B, K]
  int32_t* desc;             // [B, K, 8]
  float* xy0;                // [B, K, 2] level-0 coordinates, or null
  int32_t* oct;              // [B, K] octaves, or null
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(WARPS * 32) orb_kernel(const Work w) {
  __shared__ float patch_s[WARPS][P][P + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= w.K) return;  // whole warp leaves together
  const size_t kf = (size_t)blockIdx.y * w.K + k;   // the keypoint's slot in the stack
  const float2 p = reinterpret_cast<const float2*>(w.xy)[kf];
  int l = 0;
  while (l + 1 < w.L && k >= w.first[l + 1]) ++l;
  const int H = w.h[l], W = w.w[l];
  const uint16_t* img = static_cast<const uint16_t*>(w.img[l]) + (size_t)blockIdx.y * H * W;
  float (*patch)[P + 1] = patch_s[warp];

  const float x = fminf(fmaxf(p.x, (float)R), (float)(W - R - 2));
  const float y = fminf(fmaxf(p.y, (float)R), (float)(H - R - 2));
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = bf(x - x0f), fy = bf(y - y0f);
  const float wx0 = bf(1.f - fx), wy0 = bf(1.f - fy);
  const int x0 = (int)x0f, y0 = (int)y0f;

  // rows: lane c's column x0-15+c, rows y0-15 .. y0+16, every load issued first
  const uint16_t* col = img + (size_t)(y0 - R) * W + (x0 - R + lane);
  uint16_t v[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i) v[i] = __ldg(col + (size_t)i * W);
  float rows[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float a = __uint_as_float((uint32_t)v[i] << 16);
    const float b = __uint_as_float((uint32_t)v[i + 1] << 16);
    rows[i] = bf(__fadd_rn(__fmul_rn(wy0, a), __fmul_rn(fy, b)));
  }

  // columns: patch[i][lane] (lane 31's is not part of the patch), moments
  const int dx = lane - R;
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float right = __shfl_down_sync(FULL, rows[i], 1);
    const float val = bf(__fadd_rn(__fmul_rn(wx0, rows[i]), __fmul_rn(fx, right)));
    const int dy = i - R;
    if (lane < P) {
      patch[i][lane] = val;
      if (dx * dx + dy * dy <= R * R) {
        m0 = __fadd_rn(m0, __fmul_rn((float)dx, val));
        m1 = __fadd_rn(m1, __fmul_rn((float)dy, val));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m0 += __shfl_xor_sync(FULL, m0, off);
    m1 += __shfl_xor_sync(FULL, m1, off);
  }

  const float ang = atan2f(m1, m0);
  int bank = (int)rintf(__fmul_rn(__fdiv_rn(ang, 6.28318530717958647692f), 64.f));
  bank = ((bank % 64) + 64) % 64;
  const uint32_t* tb = reinterpret_cast<const uint32_t*>(w.tables) + (size_t)bank * 256;
  uint32_t taps[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) taps[r] = __ldg(tb + r * 32 + lane);
  __syncwarp();

  uint32_t mine = 0;   // lane r < 8 keeps word r
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = (int)taps[r];
    const int dx0 = (int8_t)(t & 0xff), dy0 = (int8_t)((t >> 8) & 0xff);
    const int dx1 = (int8_t)((t >> 16) & 0xff), dy1 = (int8_t)(t >> 24);
    const unsigned word = __ballot_sync(FULL, patch[R + dy0][R + dx0] < patch[R + dy1][R + dx1]);
    mine = lane == r ? word : mine;
  }
  if (lane < 8) w.desc[kf * 8 + lane] = (int32_t)mine;
  if (lane == 8) w.angle[kf] = ang;
  if (lane == 9 && w.oct) w.oct[kf] = w.octave[l];
  if (lane == 10 && w.xy0) {
    const float s = w.scale[l];
    reinterpret_cast<float2*>(w.xy0)[kf] = make_float2(__fmul_rn(p.x, s), __fmul_rn(p.y, s));
  }
}

int launch(const void* work, void* stream) {
  const Work w = *static_cast<const Work*>(work);
  if (w.L < 1 || w.L > MAXL || w.B < 1 || w.B > 65535 || w.K < 1 || w.first[0] != 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < w.L; ++l)
    if (w.h[l] < P + 2 || w.w[l] < P + 2 || !w.img[l] || (l && w.first[l] < w.first[l - 1]))
      return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w.xy) & 7 || reinterpret_cast<uintptr_t>(w.xy0) & 7 ||
      reinterpret_cast<uintptr_t>(w.tables) & 3)
    return (int)cudaErrorMisalignedAddress;
  orb_kernel<<<dim3((w.K + WARPS - 1) / WARPS, w.B), WARPS * 32, 0, (cudaStream_t)stream>>>(w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_orb_describe(const void* work, void* stream) { return launch(work, stream); }
