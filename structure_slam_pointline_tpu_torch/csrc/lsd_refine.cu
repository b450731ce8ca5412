// Kernel 6: sparse refinement of the line anchors, one octave per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lsd.py
// anchor orientation (:296-300) and `refine` with the endpoint evaluation
// (:357-440): the reference runs each pass as [K, 2S] whole-array ops (a
// flat gather of the packed ridge plane, rolls for the bridge, cumprods for
// the runs, row sums for the weighted PCA). Here one thread owns one anchor
// and runs every pass: `iters` coarse passes (S/2 samples each side, 3 px
// apart) that move the centre and the direction, then the fine pass (S
// each side, 1.5 px apart) that yields the endpoints, the length, the mean
// ridge magnitude and the response.
//
// Bound on the card: neither. 256 anchors x (2 x 48 + 96) samples read one
// word each (~200 KB of gathers, mostly L2 hits) and do ~60 operations per
// sample: ~1 us of either at the card's rates, so the launch and the serial
// per-thread loop (a few hundred dependent steps) set the time. Simple and
// right first: a warp per anchor with ballots for the runs is the faster
// design.
//
// Numerics: the torch plain version (lsd_refine_plain) op for op; both sum
// the weights and moments one sample after another (fmath.seq_sum there),
// since a centre an ulp off moves the next pass's samples; the anchor's gradient is the bilinear mix of the four
// pixels' bf16 Scharr values; atan2 is glibc's, cos / sin are CUDA's
// (one-ulp differences to the CPU move a sample across a pixel boundary
// only rarely). At line_support_downsample = 2 every anchor sits on a half
// pixel: the bilinear weights are 0.5, summed in the plain version's
// order, and walk samples land on exact .5, where rintf rounds half to
// even as torch.round and jnp.round do.

#include "lines.cuh"

namespace {

using namespace lines;

constexpr int MAX_SAMPLES = 256;  // 2 x walk steps of the fine pass

struct Pass {
  float mx, my, ang, msum, nsamp, t_lo, t_hi;
};

__device__ Pass refine(const int32_t* __restrict__ packed, int H, int W, float cx, float cy,
                       float d_ang, int n, float step, float tol, float half_grad,
                       bool want_ends) {
  float qx[MAX_SAMPLES], qy[MAX_SAMPLES], smag[MAX_SAMPLES];
  bool al[MAX_SAMPLES];
  const float r2 = 0x1.6a09e6p-1f;  // float32(0.7071067811865476)
  const float dxi = cosf(d_ang), dyi = sinf(d_ang);
  const float expect = d_ang + HALF_PI;
  const int m = 2 * n;
  for (int j = 0; j < m; ++j) {
    const float t = (j < n ? -(float)(n - j) : (float)(j - n + 1)) * step;
    const float px = cx + dxi * t;
    const float py = cy + dyi * t;
    const int xi = min(max((int)rintf(px), 0), W - 1);
    const int yi = min(max((int)rintf(py), 0), H - 1);
    const uint32_t s = (uint32_t)packed[(size_t)yi * W + xi];
    const float mag = (float)(s & 4095u) * 0x1.99999ap-6f;            // 1/40
    const float ang = (float)((s >> 12) & 1023u) * 0x1.928456p-8f - PI;  // 2 pi / 1023
    const uint32_t bin = (s >> 30) & 3u;
    const float delta = (float)((s >> 22) & 255u) * 0x1.818182p-7f - 1.5f;  // 1/85
    const float bdx = bin == 0 ? 1.0f : (bin == 1 ? r2 : (bin == 2 ? 0.0f : -r2));
    const float bdy = bin == 0 ? 0.0f : (bin == 2 ? 1.0f : r2);
    qx[j] = px + delta * bdx;
    qy[j] = py + delta * bdy;
    smag[j] = mag;
    al[j] = angle_diff(ang, expect) < tol && mag > half_grad && qx[j] >= 1.0f &&
            qx[j] < (float)(W - 2) && qy[j] >= 1.0f && qy[j] < (float)(H - 2);
  }
  // bridge isolated gaps (jnp.roll: the ends wrap), then the runs outward
  bool run[MAX_SAMPLES];
  for (int j = 0; j < m; ++j)
    run[j] = al[j] || (al[(j + m - 1) % m] && al[(j + 1) % m]);
  bool r = true;
  for (int j = n; j < m; ++j) run[j] = r = r && run[j];
  r = true;
  for (int j = n - 1; j >= 0; --j) run[j] = r = r && run[j];
  float wsum = 0.f, sx = 0.f, sy = 0.f, ns = 0.f;
  for (int j = 0; j < m; ++j) {
    const float w = run[j] ? smag[j] : 0.f;
    wsum += w;
    sx += w * qx[j];
    sy += w * qy[j];
    ns += run[j] ? 1.f : 0.f;
  }
  Pass out;
  const float wd = fmaxf(wsum, 1e-6f);
  out.mx = sx / wd;
  out.my = sy / wd;
  float sxx = 0.f, syy = 0.f, sxy = 0.f;
  for (int j = 0; j < m; ++j) {
    const float w = run[j] ? smag[j] : 0.f;
    const float ux = qx[j] - out.mx, uy = qy[j] - out.my;
    sxx += w * ux * ux;
    syy += w * uy * uy;
    sxy += w * ux * uy;
  }
  out.ang = 0.5f * atan2_glibc(2.0f * sxy, sxx - syy);
  out.msum = wsum;
  out.nsamp = ns;
  out.t_lo = 0.f;
  out.t_hi = 0.f;
  if (want_ends) {
    for (int j = 0; j < m; ++j) {
      const float t = run[j] ? (j < n ? -(float)(n - j) : (float)(j - n + 1)) * step : 0.f;
      out.t_lo = fminf(out.t_lo, t);
      out.t_hi = fmaxf(out.t_hi, t);
    }
  }
  return out;
}

__global__ void refine_kernel(const float* __restrict__ img, const int32_t* __restrict__ packed,
                              int H, int W, const float* __restrict__ ax,
                              const float* __restrict__ ay, int K, int steps, int iters,
                              float tol, float half_grad, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  // anchor orientation from the bilinear gradient (never the angle map)
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
    const Pass p = refine(packed, H, W, cx, cy, d_ang, steps / 2, 3.0f, tol, half_grad, false);
    cx = p.mx;
    cy = p.my;
    d_ang = p.ang;
  }
  const Pass f = refine(packed, H, W, cx, cy, d_ang, steps, 1.5f, tol, half_grad, true);
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
  if (2 * steps > MAX_SAMPLES) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  refine_kernel<<<(K + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int32_t*)packed, H, W, (const float*)ax, (const float*)ay, K,
      steps, iters, tol, half_grad, (float*)out);
  return (int)cudaGetLastError();
}
