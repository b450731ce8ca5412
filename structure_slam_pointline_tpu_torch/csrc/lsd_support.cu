// Kernel 5: the dense pass of the line detector, one octave per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lsd.py
// `detect_lines` dense part: the bf16 Scharr gradients and angle map
// (:207-211), the 4-bin directional NMS (:236-250), the 16-direction
// support scan (:259-283, a lax.scan of whole-image zero-filled shifts and
// log-doubling sums) and the packed ridge plane (:308-352, rolls and
// selects over whole images). Two launches from one entry point at
// line_support_downsample = 1:
//
//   A. one thread per pixel: the gradient at the pixel and at its two NMS
//      neighbours (wrapped taps, like jnp.roll), the angle (glibc atan2f),
//      the peak test, the 16-bit mask of directions the pixel is aligned
//      with (and weak-gradient), and the packed ridge word;
//   B. one thread per pixel: only NMS peaks do work. For each direction
//      the pixel is aligned with, the laterally dilated mask is read at
//      the 16 lattice points p + k v (k = -7..8, zero outside the image),
//      the pair gate makes 15 pair bits, and their count over k = 0..7
//      each way is the support (the reference's 2 x 3 doublings count
//      exactly these). The best score = support px x magnitude.
//
// At line_support_downsample = 2 (:219-233, the support scan on the 2x2
// box half image) the entry point makes four launches: H, the half image
// (0.25 x the window summed in row-major order, reduce_window's); A on the
// full image for the packed ridge plane alone (the refinement reads it at
// full resolution); A on the half image for the mask and the peaks alone,
// at the 0.75 x threshold the caller passes; B on the half image with the
// support scaled by 2 (full-resolution pixels). No launch computes a
// plane that is thrown away. Any other ds scans at full resolution with
// the support scaled by ds, as the reference does.
//
// Bound on the card: bytes, narrowly against operations. Per pixel A reads
// the image taps (cached; one float per pixel from device memory), B reads
// the mask at up to 16 x 16 x 3 points for peaks only (~5% of pixels) out
// of L1/L2, and the outputs are 4 + 4 B (+ 2 + 4 B intermediates). The
// reference's cost, ~200 whole-image shift passes, becomes one pass of
// per-pixel arithmetic plus sparse gathers. At ds = 2 the mask and support
// launches cover a quarter of the pixels; the ridge-plane launch still
// covers them all.
//
// Numerics: the reference op for op (torch plain version lsd_support_plain):
// bf16 rounding after every gradient op; the magnitude's square root is
// unrounded in the score and the ridge centre and bf16 in the comparisons
// and neighbour copies (XLA:CPU's conversion folding); the angle is glibc's
// atan2f; jnp.round is rintf (half to even). Support counts are small
// integers, exact in any order.

#include "lines.cuh"

namespace {

using namespace lines;

constexpr int TX = 32;
constexpr int TY = 8;

// (vx, vy, nx, ny) per direction and (theta, |v|) as float32
__constant__ int c_dir[16][4] = {
    {2, 0, 0, 1},   {4, 1, 0, 1},  {2, 1, 0, 1},  {4, 3, -1, 1}, {2, 2, -1, 1}, {3, 4, -1, 1},
    {2, 4, -1, 0},  {1, 4, -1, 0}, {0, 2, -1, 0}, {-1, 4, -1, 0}, {-2, 4, -1, 0},
    {-3, 4, -1, -1}, {-2, 2, -1, -1}, {-4, 3, -1, -1}, {-2, 1, 0, -1}, {-4, 1, 0, -1}};
__constant__ float c_theta[16] = {
    0x0.0p+0f, 0x1.f5b76p-3f, 0x1.dac67p-2f, 0x1.4978fap-1f, 0x1.921fb6p-1f, 0x1.dac67p-1f,
    0x1.1b6e1ap+0f, 0x1.5368cap+0f, 0x1.921fb6p+0f, 0x1.d0d6a2p+0f, 0x1.0468a8p+1f,
    0x1.1b6e1ap+1f, 0x1.2d97c8p+1f, 0x1.3fc176p+1f, 0x1.56c6e8p+1f, 0x1.72c44p+1f};
__constant__ float c_vlen[16] = {
    0x1.0p+1f, 0x1.07e0f6p+2f, 0x1.1e377ap+1f, 0x1.4p+2f, 0x1.6a09e6p+1f, 0x1.4p+2f,
    0x1.1e377ap+2f, 0x1.07e0f6p+2f, 0x1.0p+1f, 0x1.07e0f6p+2f, 0x1.1e377ap+2f, 0x1.4p+2f,
    0x1.6a09e6p+1f, 0x1.4p+2f, 0x1.1e377ap+1f, 0x1.07e0f6p+2f};

__constant__ int c_nbr[4][2] = {{1, 0}, {1, 1}, {0, 1}, {-1, 1}};  // (dx, dy) per bin

// 2x2 box half image: ((a + b) + c) + d in the window's row-major order, x 0.25
__global__ void half_kernel(const float* __restrict__ img, int W, int hs, int ws,
                            float* __restrict__ out) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= ws || y >= hs) return;
  const float* r0 = img + (size_t)(2 * y) * W + 2 * x;
  const float* r1 = r0 + W;
  out[(size_t)y * ws + x] = 0.25f * (((r0[0] + r0[1]) + r1[0]) + r1[1]);
}

// mask and peak, or packed, may be null: that plane is not computed
__global__ void planes_kernel(const float* __restrict__ img, int H, int W, float grad_thresh,
                              float tol, uint16_t* __restrict__ mask,
                              float* __restrict__ peak, int32_t* __restrict__ packed) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const Grad g = scharr(img, H, W, y, x);
  const float gang = atan2_glibc(g.gy, g.gx);
  const float magf = sqrtf(g.sq);
  const float mag = bf(magf);
  const int bin = ((int)rintf(jmod(gang, PI) / QUARTER_PI)) % 4;
  const int bdx = c_nbr[bin][0], bdy = c_nbr[bin][1];
  const int yp = wrap(y + bdy, H), xp = wrap(x + bdx, W);
  const int ym = wrap(y - bdy, H), xm = wrap(x - bdx, W);
  const Grad gp = scharr(img, H, W, yp, xp);
  const Grad gm = scharr(img, H, W, ym, xm);
  const float fp = bf(sqrtf(gp.sq)), fm = bf(sqrtf(gm.sq));
  const size_t o = (size_t)y * W + x;
  if (mask != nullptr) {
    const bool is_peak = mag >= fp && mag >= fm && mag > grad_thresh;
    const bool weak = mag > 0.5f * grad_thresh;
    const float line_ang = jmod(gang + HALF_PI, PI);
    uint32_t m = 0;
    if (weak) {
#pragma unroll
      for (int d = 0; d < 16; ++d)
        if (angle_diff(line_ang, c_theta[d]) < tol) m |= 1u << d;
    }
    mask[o] = (uint16_t)m;
    peak[o] = is_peak ? magf : 0.f;
  }
  if (packed == nullptr) return;

  // ridge plane: parabola snap along the bin direction, ridge angle/magnitude
  const float den = fm - 2.0f * magf + fp;
  const float binlen = (bin == 1 || bin == 3) ? SQRT2 : 1.0f;
  float delta = fabsf(den) > 1e-6f ? 0.5f * (fm - fp) / den : 0.0f;
  delta = fminf(fmaxf(delta * binlen, -1.5f), 1.5f);
  const float mag_ridge = fmaxf(fmaxf(fp, fm), magf);
  const int shift_i = (int)rintf(delta / binlen);
  float gang_ridge = gang;
  if (shift_i == 1) gang_ridge = atan2_glibc(gp.gy, gp.gx);
  if (shift_i == -1) gang_ridge = atan2_glibc(gm.gy, gm.gx);
  const uint32_t q_delta = (uint32_t)rintf((delta + 1.5f) * 85.0f);
  const uint32_t q_ang =
      (uint32_t)fminf(fmaxf(rintf((gang_ridge + PI) / TWO_PI * 1023.0f), 0.0f), 1023.0f);
  const uint32_t q_mag = (uint32_t)fminf(fmaxf(rintf(mag_ridge * 40.0f), 0.0f), 4095.0f);
  packed[o] = (int32_t)(((uint32_t)bin << 30) | (q_delta << 22) | (q_ang << 12) | q_mag);
}

__device__ __forceinline__ int bit_at(const uint16_t* __restrict__ mask, int H, int W, int y,
                                      int x, int d) {
  if (x < 0 || x >= W || y < 0 || y >= H) return 0;
  return (mask[(size_t)y * W + x] >> d) & 1;
}

__global__ void support_kernel(const uint16_t* __restrict__ mask,
                               const float* __restrict__ peak, int H, int W, float min_sup,
                               float scale, float* __restrict__ best) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t o = (size_t)y * W + x;
  const float pm = peak[o];
  float out = 0.f;
  if (pm > 0.f) {
    const uint32_t here = mask[o];
    for (int d = 0; d < 16; ++d) {
      if (!((here >> d) & 1)) continue;
      const int vx = c_dir[d][0], vy = c_dir[d][1], nx = c_dir[d][2], ny = c_dir[d][3];
      int contd[16];  // k = -7..8
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qx = x + (i - 7) * vx, qy = y + (i - 7) * vy;
        const bool inside = qx >= 0 && qx < W && qy >= 0 && qy < H;
        contd[i] = inside && (bit_at(mask, H, W, qy, qx, d) | bit_at(mask, H, W, qy + ny, qx + nx, d)
                              | bit_at(mask, H, W, qy - ny, qx - nx, d));
      }
      int sup = 0;
#pragma unroll
      for (int i = 0; i < 15; ++i) {
        const int pair = contd[i] & contd[i + 1];
        const int k = i - 7;  // lattice offset of this pair's first point
        sup += pair * ((k >= 0 ? 1 : 0) + (k <= 0 ? 1 : 0));
      }
      const float support_px = (float)sup * (c_vlen[d] * scale);  // full-res px
      if (support_px >= min_sup) out = fmaxf(out, support_px * pm);
    }
  }
  best[o] = out;
}

}  // namespace

extern "C" int sspl_lsd_support(const void* img, int H, int W, int ds, float grad_thresh,
                                float tol, float min_sup, void* half, void* mask, void* peak,
                                void* best, void* packed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  if (ds != 2) {
    planes_kernel<<<grid, block, 0, s>>>((const float*)img, H, W, grad_thresh, tol,
                                         (uint16_t*)mask, (float*)peak, (int32_t*)packed);
    support_kernel<<<grid, block, 0, s>>>((const uint16_t*)mask, (const float*)peak, H, W,
                                          min_sup, (float)ds, (float*)best);
    return (int)cudaGetLastError();
  }
  const int hs = H / 2, ws = W / 2;
  const dim3 hgrid((ws + TX - 1) / TX, (hs + TY - 1) / TY);
  half_kernel<<<hgrid, block, 0, s>>>((const float*)img, W, hs, ws, (float*)half);
  planes_kernel<<<grid, block, 0, s>>>((const float*)img, H, W, grad_thresh, tol, nullptr,
                                       nullptr, (int32_t*)packed);
  planes_kernel<<<hgrid, block, 0, s>>>((const float*)half, hs, ws, grad_thresh, tol,
                                        (uint16_t*)mask, (float*)peak, nullptr);
  support_kernel<<<hgrid, block, 0, s>>>((const uint16_t*)mask, (const float*)peak, hs, ws,
                                         min_sup, 2.0f, (float*)best);
  return (int)cudaGetLastError();
}
