// Kernel 6: sparse refinement of the line anchors, one octave per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lsd.py
// anchor orientation (:296-300) and `refine` with the endpoint evaluation
// (:357-440): the reference runs each pass as [K, 2S] whole-array ops (a
// flat gather of the packed ridge plane, rolls for the bridge, cumprods for
// the runs, row sums for the weighted PCA). Each anchor runs `iters` coarse
// passes (S/2 samples each side, 3 px apart) that move the centre and the
// direction, then the fine pass (S each side, 1.5 px apart) that yields
// the endpoints, the length, the mean ridge magnitude and the response.
//
// Bound on the card: neither bytes nor operations. 256 anchors x (2 x 48 +
// 96) samples read one word each (~200 KB of gathers, mostly L2 hits) and
// do ~60 operations per sample: ~1 us of either at the card's rates. What
// sets the time is each anchor's chain of dependent steps: a pass's
// samples need the previous pass's centre and direction, and the sums run
// in sample order (below). The design cuts that chain to what the order
// forces:
// - a warp per anchor, 8 anchors a 256-thread block (a frame's K = 256 and
//   128 are 32 + 16 blocks; the first design, a thread per anchor, filled
//   4 + 2 SMs);
// - samples across lanes: lane l takes samples l, l + 32, ..., so a pass's
//   gathers of the packed plane are issued together;
// - the `aligned` flags are ballot words (<= 8 for 256 samples); the
//   wrapping 3-sample bridge is shifts of those words, and the two runs
//   outward from the centre are the first clear bit at or after sample n
//   (`__ffs`) and the last one before it (`__clz`), found by one ballot
//   over the words: the run is one interval [lo, hi), which also gives
//   t_lo / t_hi and the sample count;
// - the sums keep the plain version's order: each lane writes its samples'
//   (magnitude, qx, qy) to the warp's slice of shared memory, and three
//   lanes add the three sums of a stage (weights, x and y moments; then the
//   three second moments) as three independent chains in sample order over
//   the run, the zeros outside it adding nothing. No per-sample array lives
//   in local memory (the 32-byte stack frame is cosf / sinf's reduction of
//   huge arguments).
// What is left is each anchor's chain: a pass's gathers wait on the
// previous pass's centre and direction, and each ordered sum is up to 96
// dependent adds; it sets the ~9 us a call, a few times the launch.
//
// Numerics: the torch plain version (lsd_refine_plain) op for op, bit-equal
// on every valid anchor; both sum the weights and moments one sample after
// another (fmath.seq_sum there), since a centre an ulp off moves the next
// pass's samples; the anchor's gradient is the bilinear mix of the four
// pixels' bf16 Scharr values; atan2 is glibc's, cos / sin are CUDA's (equal
// to torch.cos / torch.sin on the card). Every lane of a warp computes the
// anchor's scalars (direction, centre) itself from the same values, so the
// lanes agree bit for bit. At line_support_downsample = 2 every anchor sits
// on a half pixel: the bilinear weights are 0.5, summed in the plain
// version's order, and walk samples land on exact .5, where rintf rounds
// half to even as torch.round and jnp.round do.

#include "lines.cuh"

namespace {

using namespace lines;

constexpr int MAX_SAMPLES = 256;  // 2 x walk steps of the fine pass
constexpr int MAX_WORDS = MAX_SAMPLES / 32;
constexpr int WARPS = 8;          // anchors a block
constexpr unsigned FULL = 0xffffffffu;

struct Pass {
  float mx, my, ang, msum, nsamp, t_lo, t_hi;
};

// one warp's staged samples of the current pass
struct Slice {
  float mag[MAX_SAMPLES], qx[MAX_SAMPLES], qy[MAX_SAMPLES];
};

__device__ __forceinline__ float sample_t(int j, int n, float step) {
  return (j < n ? -(float)(n - j) : (float)(j - n + 1)) * step;
}

// one pass of one anchor (the whole warp; every lane returns the same)
__device__ __forceinline__ Pass refine(const int32_t* __restrict__ packed, int H, int W,
                                       float cx, float cy, float d_ang, int n, float step,
                                       float tol, float half_grad, bool want_ends, Slice& sl) {
  const int lane = threadIdx.x & 31;
  const float r2 = 0x1.6a09e6p-1f;  // float32(0.7071067811865476)
  const float dxi = cosf(d_ang), dyi = sinf(d_ang);
  const float expect = d_ang + HALF_PI;
  const int m = 2 * n;
  const int words = (m + 31) >> 5;
  // the samples: lane l takes l, l + 32, ...; its word of aligned flags
  // is kept by lane k for word k
  unsigned my_word = 0;
  __syncwarp();  // the previous pass's sums have read the slice
#pragma unroll
  for (int k = 0; k < MAX_WORDS; ++k) {
    if (k < words) {
      const int j = 32 * k + lane;
      bool al = false;
      if (j < m) {
        const float t = sample_t(j, n, step);
        const float px = cx + dxi * t;
        const float py = cy + dyi * t;
        const int xi = min(max((int)rintf(px), 0), W - 1);
        const int yi = min(max((int)rintf(py), 0), H - 1);
        const uint32_t s = (uint32_t)__ldg(packed + (size_t)yi * W + xi);
        const float mag = (float)(s & 4095u) * 0x1.99999ap-6f;            // 1/40
        const float ang = (float)((s >> 12) & 1023u) * 0x1.928456p-8f - PI;  // 2 pi / 1023
        const uint32_t bin = (s >> 30) & 3u;
        const float delta = (float)((s >> 22) & 255u) * 0x1.818182p-7f - 1.5f;  // 1/85
        const float bdx = bin == 0 ? 1.0f : (bin == 1 ? r2 : (bin == 2 ? 0.0f : -r2));
        const float bdy = bin == 0 ? 0.0f : (bin == 2 ? 1.0f : r2);
        const float qx = px + delta * bdx;
        const float qy = py + delta * bdy;
        sl.mag[j] = mag;
        sl.qx[j] = qx;
        sl.qy[j] = qy;
        al = angle_diff(ang, expect) < tol && mag > half_grad && qx >= 1.0f &&
             qx < (float)(W - 2) && qy >= 1.0f && qy < (float)(H - 2);
      }
      const unsigned b = __ballot_sync(FULL, al);
      if (lane == k) my_word = b;
    }
  }
  // bridge isolated gaps (jnp.roll: the ends wrap): B = A | (prev & next),
  // lane k holding word k of each m-bit vector
  const int last = (m - 1) >> 5;
  const unsigned a_lo = __shfl_up_sync(FULL, my_word, 1);
  const unsigned a_hi = __shfl_down_sync(FULL, my_word, 1);
  const unsigned a_first = __shfl_sync(FULL, my_word, 0);
  const unsigned a_last = __shfl_sync(FULL, my_word, last);
  const bool in_range = lane < words;
  const int top = (m - 1) & 31;  // sample m - 1's bit in word `last`
  const unsigned valid = lane < last ? FULL : (lane == last ? (FULL >> (31 - top)) : 0u);
  unsigned prev = (my_word << 1) | (lane > 0 ? (a_lo >> 31) : ((a_last >> top) & 1u));
  unsigned next = (my_word >> 1) | (lane < last ? (a_hi << 31) : 0u);
  if (lane == last) next |= (a_first & 1u) << top;
  const unsigned bridged = in_range ? ((my_word | (prev & next)) & valid) : 0u;
  // the runs outward from the centre: [lo, hi), hi the first clear bit at
  // or after n, lo - 1 the last clear bit before n
  const int wb = 32 * lane;
  unsigned above = in_range ? (~bridged & valid) : 0u;
  unsigned below = above;
  if (wb + 32 <= n) above = 0u;
  else if (wb < n) above &= FULL << (n - wb);
  if (wb >= n) below = 0u;
  else if (wb + 32 > n) below &= FULL >> (32 - (n - wb));
  const unsigned has_above = __ballot_sync(FULL, above != 0u);
  const unsigned has_below = __ballot_sync(FULL, below != 0u);
  const int first_zero = above ? wb + __ffs(above) - 1 : 0;
  const int last_zero = below ? wb + 31 - __clz(below) : 0;
  const int hi = has_above ? __shfl_sync(FULL, first_zero, __ffs(has_above) - 1) : m;
  const int lo = has_below ? __shfl_sync(FULL, last_zero, 31 - __clz(has_below)) + 1 : 0;
  __syncwarp();  // the slice is written
  // the weighted centre: lanes 0-2 add the weights and the x and y moments
  // in sample order over the run
  float acc = 0.f;
  if (lane < 3) {
    const float* f = lane == 1 ? sl.qx : sl.qy;
    // unrolled so the loads run ahead of the chain of adds
#pragma unroll 8
    for (int j = lo; j < hi; ++j) {
      const float w = sl.mag[j];
      acc += lane == 0 ? w : w * f[j];
    }
  }
  Pass out;
  const float wsum = __shfl_sync(FULL, acc, 0);
  const float sx = __shfl_sync(FULL, acc, 1);
  const float sy = __shfl_sync(FULL, acc, 2);
  const float wd = fmaxf(wsum, 1e-6f);
  out.mx = sx / wd;
  out.my = sy / wd;
  // the second moments, likewise
  acc = 0.f;
  if (lane < 3) {
#pragma unroll 8
    for (int j = lo; j < hi; ++j) {
      const float w = sl.mag[j];
      const float ux = sl.qx[j] - out.mx, uy = sl.qy[j] - out.my;
      acc += lane == 0 ? w * ux * ux : (lane == 1 ? w * uy * uy : w * ux * uy);
    }
  }
  const float sxx = __shfl_sync(FULL, acc, 0);
  const float syy = __shfl_sync(FULL, acc, 1);
  const float sxy = __shfl_sync(FULL, acc, 2);
  out.ang = 0.5f * atan2_glibc(2.0f * sxy, sxx - syy);
  out.msum = wsum;
  out.nsamp = (float)(hi - lo);
  out.t_lo = 0.f;
  out.t_hi = 0.f;
  if (want_ends && lo < hi) {
    out.t_lo = fminf(out.t_lo, sample_t(lo, n, step));
    out.t_hi = fmaxf(out.t_hi, sample_t(hi - 1, n, step));
  }
  return out;
}

__global__ void __launch_bounds__(32 * WARPS)
refine_kernel(const float* __restrict__ img, const int32_t* __restrict__ packed, int H, int W,
              const float* __restrict__ ax, const float* __restrict__ ay, int K, int steps,
              int iters, float tol, float half_grad, float* __restrict__ out) {
  __shared__ Slice slices[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  if (k >= K) return;
  Slice& sl = slices[warp];
  // anchor orientation from the bilinear gradient (never the angle map);
  // every lane computes it
  const float x = ax[k], y = ay[k];
  const int x0 = min(max((int)floorf(x), 0), W - 2);
  const int y0 = min(max((int)floorf(y), 0), H - 2);
  const float fx = fminf(fmaxf(x - (float)x0, 0.f), 1.f);
  const float fy = fminf(fmaxf(y - (float)y0, 0.f), 1.f);
  const Grad g00 = scharr(img, H, W, y0, x0), g01 = scharr(img, H, W, y0, x0 + 1);
  const Grad g10 = scharr(img, H, W, y0 + 1, x0), g11 = scharr(img, H, W, y0 + 1, x0 + 1);
  const float a_gx = g00.gx * (1 - fx) * (1 - fy) + g01.gx * fx * (1 - fy) +
                     g10.gx * (1 - fx) * fy + g11.gx * fx * fy;
  const float a_gy = g00.gy * (1 - fx) * (1 - fy) + g01.gy * fx * (1 - fy) +
                     g10.gy * (1 - fx) * fy + g11.gy * fx * fy;
  const float a_ang = atan2_glibc(a_gy, a_gx);
  float d_ang = atan2_glibc(cosf(a_ang), -sinf(a_ang));
  float cx = x, cy = y;
  for (int it = 0; it < iters; ++it) {
    const Pass p =
        refine(packed, H, W, cx, cy, d_ang, steps / 2, 3.0f, tol, half_grad, false, sl);
    cx = p.mx;
    cy = p.my;
    d_ang = p.ang;
  }
  const Pass f = refine(packed, H, W, cx, cy, d_ang, steps, 1.5f, tol, half_grad, true, sl);
  if (lane != 0) return;
  const float dxf = cosf(d_ang), dyf = sinf(d_ang);
  const float total_len = f.t_hi - f.t_lo;
  const float mean_mag = f.msum / fmaxf(f.nsamp, 1.0f);
  float* o = out + (size_t)k * 7;
  o[0] = cx + dxf * f.t_lo;
  o[1] = cy + dyf * f.t_lo;
  o[2] = cx + dxf * f.t_hi;
  o[3] = cy + dyf * f.t_hi;
  o[4] = total_len;
  o[5] = mean_mag;
  o[6] = total_len * mean_mag;
}

}  // namespace

extern "C" int sspl_lsd_refine(const void* img, const void* packed, int H, int W,
                               const void* ax, const void* ay, int K, int steps, int iters,
                               float tol, float half_grad, void* out, void* stream) {
  if (2 * steps > MAX_SAMPLES || steps < 2) return (int)cudaErrorInvalidValue;
  refine_kernel<<<(K + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int32_t*)packed, H, W, (const float*)ax, (const float*)ay, K,
      steps, iters, tol, half_grad, (float*)out);
  return (int)cudaGetLastError();
}
