// Kernel 5: the dense pass of the line detector, one octave per call.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lsd.py
// `detect_lines` dense part: the bf16 Scharr gradients and angle map
// (:207-211), the 4-bin directional NMS (:236-250), the 16-direction
// support scan (:259-283, a lax.scan of whole-image zero-filled shifts and
// log-doubling sums) and the packed ridge plane (:308-352, rolls and
// selects over whole images). Two launches from one entry point:
//
//   A. planes: a block per 32 x 16 tile. The block stages the tile's image
//      taps with a 2-px halo in shared memory (bf16-rounded, wrapped at the
//      image border like jnp.roll), then the gradient, its magnitude and
//      its angle (glibc atan2f) once per pixel of the tile and its 1-px
//      halo, and there the 16-bit mask of directions the pixel is aligned
//      with (and weak-gradient; zero outside the image). Each pixel's NMS
//      neighbours, their magnitudes and, for the ridge, their angles are
//      then read from shared memory: the ridge angle at a shift of +-1 is
//      the neighbour's own atan2, the value the plain version rolls in.
//      Out: the mask laterally dilated (direction d's bit ORed with the
//      bits of the neighbours at +-n_d, zero-filled), the packed ridge
//      word, a zero score, and for each NMS peak (index, magnitude, its own
//      undilated mask) appended to a list with one atomic per warp (ballot,
//      popc, shuffle).
//   B. support: a warp per listed peak (the list order does not matter: a
//      peak writes only its own score). For each pair of directions with
//      one of them set in the peak's mask, lane l takes lattice point
//      l % 16 (k = -7..8) of direction l / 16: the dilated mask at p + k v
//      (zero outside the image), one read. A ballot gives the 16 contd
//      bits of both directions, the pair gate is contd & contd >> 1 over
//      15 pairs, and their count over k = 0..7 each way (the pair at k = 0
//      twice; the reference's 2 x 3 doublings count exactly these) is the
//      support. The best score = support px x magnitude.
//
// At line_support_downsample = 2 (:219-233) the support scan runs on the
// 2x2 box half image (0.25 x the window summed in row-major order,
// reduce_window's) at the 0.75 x threshold the caller passes, in
// full-resolution pixels; the ridge plane stays at full resolution. Launch
// A then has two kinds of blocks: full-image tiles that compute the packed
// plane alone, and half-image tiles that build their taps from the full
// image (four reads each, no half image in memory) and compute the mask,
// the zero score and the peak list alone. Any other ds scans at full
// resolution with the support scaled by ds, as the reference does.
//
// Why not one launch: a peak's support reads the mask up to 8 |v| <= 32 px
// along the line and 1 px across, so a tile would have to compute the
// mask over a 33-px halo (a 32 x 16 tile: ~16x its own pixels, each one
// gradient, one atan2 and 16 angle gates). The mask goes through L2
// instead (2 B a pixel, 0.6 MB at 640x480).
//
// Bound on the card: operations, narrowly against bytes. Per pixel one
// gradient (~40 operations with the bf16 roundings), one atan2 (~60), the
// NMS and bin, 16 angle gates and the ridge snap and packing; per scored
// peak the support over its directions. The tile recomputes the gradient
// and gates of its 1-px halo (34 x 18 for 32 x 16, 1.2x). Device memory: the image read
// once, 4 + 4 B of score and ridge plane written, the dilated mask and the
// peak list in L2.
//
// Numerics: the reference op for op (torch plain version lsd_support_plain):
// bf16 rounding after every gradient op; the magnitude's square root is
// unrounded in the score and the ridge centre and bf16 in the comparisons
// and neighbour copies (XLA:CPU's conversion folding); the angle is glibc's
// atan2f; jnp.round is rintf (half to even). Support counts are small
// integers, exact in any order, and the maximum over directions is exact.

#include "lines.cuh"

namespace {

using namespace lines;

constexpr int TX = 32;           // tile width = threads in x
constexpr int TY = 8;            // threads in y
constexpr int ROWS = 2;          // output rows per thread
constexpr int TH = TY * ROWS;    // tile height
constexpr int GW = TX + 2, GH = TH + 2;  // gradients: the tile and a 1-px halo
constexpr int IW = TX + 4, IH = TH + 4;  // image taps: a 2-px halo
constexpr int THREADS = TX * TY;
constexpr int SUP_WARPS = 8;     // peaks in flight per block of launch B
constexpr int SUP_BLOCKS = 132 * 8;
constexpr unsigned FULL = 0xffffffffu;

struct Peak {
  int32_t o;      // pixel index on the scanned grid
  float mag;      // its unrounded gradient magnitude
  uint32_t here;  // its own (undilated) direction mask
};

// the directions whose rounded unit normal (nx, ny) (ops/lsd.py _DIR_I) is
// +-(0, 1), +-(1, 0), +-(1, 1) and +-(1, -1): the neighbours at +-n that
// each direction's lateral dilation reads
constexpr uint32_t SEL_V = 0xc007, SEL_H = 0x07c0, SEL_D1 = 0x3800, SEL_D2 = 0x0038;

// (vx, vy) per direction and (theta, |v|) as float32
__constant__ int c_dir[16][2] = {{2, 0},  {4, 1},  {2, 1},  {4, 3},  {2, 2},  {3, 4},
                                 {2, 4},  {1, 4},  {0, 2},  {-1, 4}, {-2, 4}, {-3, 4},
                                 {-2, 2}, {-4, 3}, {-2, 1}, {-4, 1}};
__constant__ float c_theta[16] = {
    0x0.0p+0f, 0x1.f5b76p-3f, 0x1.dac67p-2f, 0x1.4978fap-1f, 0x1.921fb6p-1f, 0x1.dac67p-1f,
    0x1.1b6e1ap+0f, 0x1.5368cap+0f, 0x1.921fb6p+0f, 0x1.d0d6a2p+0f, 0x1.0468a8p+1f,
    0x1.1b6e1ap+1f, 0x1.2d97c8p+1f, 0x1.3fc176p+1f, 0x1.56c6e8p+1f, 0x1.72c44p+1f};
__constant__ float c_vlen[16] = {
    0x1.0p+1f, 0x1.07e0f6p+2f, 0x1.1e377ap+1f, 0x1.4p+2f, 0x1.6a09e6p+1f, 0x1.4p+2f,
    0x1.1e377ap+2f, 0x1.07e0f6p+2f, 0x1.0p+1f, 0x1.07e0f6p+2f, 0x1.1e377ap+2f, 0x1.4p+2f,
    0x1.6a09e6p+1f, 0x1.4p+2f, 0x1.1e377ap+1f, 0x1.07e0f6p+2f};

__constant__ int c_nbr[4][2] = {{1, 0}, {1, 1}, {0, 1}, {-1, 1}};  // (dx, dy) per bin

// jmod(x, PI) for x in [-PI, 2 PI), the range of every angle this pass
// reduces: fmodf is exact, and so is x - PI for x in [PI, 2 PI) (Sterbenz);
// below 0 jmod's own rounded x + PI (fmodf(-PI, PI) = -0 stays -0)
__device__ __forceinline__ float jmod_pi(float x) {
  if (x >= PI) return x - PI;
  if (x < 0.f) return x == -PI ? -0.f : x + PI;
  return x;
}

// angle_diff (lines.cuh) with jmod_pi: a, b in [0, PI]
__device__ __forceinline__ float gate_diff(float a, float b) {
  return fabsf(jmod_pi(a - b + HALF_PI) - HALF_PI);
}

// pixel (y, x) of the 2x2 box half image of img (row length W):
// ((a + b) + c) + d in the window's row-major order, x 0.25
__device__ __forceinline__ float box(const float* __restrict__ img, int W, int y, int x) {
  const float* r0 = img + (size_t)(2 * y) * W + 2 * x;
  const float* r1 = r0 + W;
  return 0.25f * (((r0[0] + r0[1]) + r1[0]) + r1[1]);
}

// Launch A. Blocks [0, n_full) tile the image (H x W); at ds = 2 blocks
// [n_full, gridDim.x) tile its half image. A full-image block computes the
// mask, the zero score and the peaks unless ds = 2, and the packed plane;
// a half-image block the mask, the zero score and the peaks.
__global__ void __launch_bounds__(THREADS)
planes_kernel(const float* __restrict__ img, int H, int W, int ds, int n_full,
              float grad_thresh, float tol, uint16_t* __restrict__ mask,
              float* __restrict__ best, Peak* __restrict__ peaks, int* __restrict__ n_peaks,
              int32_t* __restrict__ packed) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_ang[GH][GW], s_magf[GH][GW], s_mag[GH][GW];
  __shared__ uint16_t s_m[GH][GW];
  int b = blockIdx.x;
  const bool on_half = b >= n_full;
  if (on_half) b -= n_full;
  const int h = on_half ? H / 2 : H, w = on_half ? W / 2 : W;
  const bool do_mask = on_half || ds != 2, do_packed = !on_half;
  const int nbx = (w + TX - 1) / TX;
  const int y0 = (b / nbx) * TH, x0 = (b % nbx) * TX;
  const int tid = threadIdx.y * TX + threadIdx.x;

  for (int i = tid; i < IH * IW; i += THREADS) {
    const int y = wrap(y0 - 2 + i / IW, h), x = wrap(x0 - 2 + i % IW, w);
    s_img[i / IW][i % IW] = bf(on_half ? box(img, W, y, x) : img[(size_t)y * W + x]);
  }
  __syncthreads();
  for (int i = tid; i < GH * GW; i += THREADS) {
    const int ly = i / GW, lx = i % GW;
    const Grad g = scharr_taps(s_img[ly][lx], s_img[ly][lx + 1], s_img[ly][lx + 2],
                               s_img[ly + 1][lx], s_img[ly + 1][lx + 2], s_img[ly + 2][lx],
                               s_img[ly + 2][lx + 1], s_img[ly + 2][lx + 2]);
    const float magf = sqrtf(g.sq), mag = bf(magf), gang = atan2_glibc(g.gy, g.gx);
    s_magf[ly][lx] = magf;
    s_mag[ly][lx] = mag;
    s_ang[ly][lx] = gang;
    if (!do_mask) continue;
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    uint32_t m = 0;
    if (y >= 0 && y < h && x >= 0 && x < w && mag > 0.5f * grad_thresh) {
      const float line_ang = jmod_pi(gang + HALF_PI);
#pragma unroll
      for (int d = 0; d < 16; ++d)
        if (gate_diff(line_ang, c_theta[d]) < tol) m |= 1u << d;
    }
    s_m[ly][lx] = (uint16_t)m;
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = 0; r < ROWS; ++r) {
    const int ly = threadIdx.y + r * TY + 1, lx = threadIdx.x + 1;
    const int y = y0 + ly - 1, x = x0 + lx - 1;
    const bool inside = y < h && x < w;
    const size_t o = (size_t)y * w + x;
    const float gang = s_ang[ly][lx], magf = s_magf[ly][lx], mag = s_mag[ly][lx];
    const int bin = ((int)rintf(jmod_pi(gang) / QUARTER_PI)) % 4;
    const int bdx = c_nbr[bin][0], bdy = c_nbr[bin][1];
    const float fp = s_mag[ly + bdy][lx + bdx], fm = s_mag[ly - bdy][lx - bdx];
    if (do_mask) {
      const bool is_peak = mag >= fp && mag >= fm && mag > grad_thresh;
      const uint32_t m = s_m[ly][lx];
      const uint32_t dil = m | ((s_m[ly - 1][lx] | s_m[ly + 1][lx]) & SEL_V) |
                           ((s_m[ly][lx - 1] | s_m[ly][lx + 1]) & SEL_H) |
                           ((s_m[ly - 1][lx - 1] | s_m[ly + 1][lx + 1]) & SEL_D1) |
                           ((s_m[ly + 1][lx - 1] | s_m[ly - 1][lx + 1]) & SEL_D2);
      if (inside) {
        mask[o] = (uint16_t)dil;
        best[o] = 0.f;
      }
      // the support pass skips a peak of zero magnitude, as the plain
      // version's score is zero there
      const bool listed = inside && is_peak && magf > 0.f;
      const unsigned bal = __ballot_sync(FULL, listed);
      if (bal != 0) {
        const int leader = __ffs(bal) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(n_peaks, __popc(bal));
        base = __shfl_sync(FULL, base, leader);
        if (listed) peaks[base + __popc(bal & ((1u << lane) - 1u))] = Peak{(int32_t)o, magf, m};
      }
    }
    if (!do_packed || !inside) continue;

    // ridge plane: parabola snap along the bin direction, ridge angle/magnitude
    const float den = fm - 2.0f * magf + fp;
    const float binlen = (bin == 1 || bin == 3) ? SQRT2 : 1.0f;
    float delta = fabsf(den) > 1e-6f ? 0.5f * (fm - fp) / den : 0.0f;
    delta = fminf(fmaxf(delta * binlen, -1.5f), 1.5f);
    const float mag_ridge = fmaxf(fmaxf(fp, fm), magf);
    const int shift_i = (int)rintf(delta / binlen);
    float gang_ridge = gang;
    if (shift_i == 1) gang_ridge = s_ang[ly + bdy][lx + bdx];
    if (shift_i == -1) gang_ridge = s_ang[ly - bdy][lx - bdx];
    const uint32_t q_delta = (uint32_t)rintf((delta + 1.5f) * 85.0f);
    const uint32_t q_ang =
        (uint32_t)fminf(fmaxf(rintf((gang_ridge + PI) / TWO_PI * 1023.0f), 0.0f), 1023.0f);
    const uint32_t q_mag = (uint32_t)fminf(fmaxf(rintf(mag_ridge * 40.0f), 0.0f), 4095.0f);
    packed[o] = (int32_t)(((uint32_t)bin << 30) | (q_delta << 22) | (q_ang << 12) | q_mag);
  }
}

// Launch B: a warp per listed peak of the H x W scanned grid
__global__ void __launch_bounds__(SUP_WARPS * 32)
support_kernel(const uint16_t* __restrict__ mask, const Peak* __restrict__ peaks,
               const int* __restrict__ n_peaks, int H, int W, float min_sup, float scale,
               float* __restrict__ best) {
  const int lane = threadIdx.x & 31;
  const int k = (lane & 15) - 7;   // this lane's lattice offset
  const int second = lane >> 4;    // which direction of the pair
  const int n = *n_peaks;
  for (int i = blockIdx.x * SUP_WARPS + (threadIdx.x >> 5); i < n;
       i += gridDim.x * SUP_WARPS) {
    const Peak pk = peaks[i];
    const int y = pk.o / W, x = pk.o % W;
    const uint32_t here = pk.here;
    float out = 0.f;
    for (int d0 = 0; d0 < 16; d0 += 2) {
      if (((here >> d0) & 3u) == 0) continue;
      const int d = d0 + second;
      const int qx = x + k * c_dir[d][0], qy = y + k * c_dir[d][1];
      const bool contd = qx >= 0 && qx < W && qy >= 0 && qy < H &&
                         ((mask[(size_t)qy * W + qx] >> d) & 1u);
      const unsigned bits = __ballot_sync(FULL, contd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int dd = d0 + j;
        if (!((here >> dd) & 1u)) continue;
        const unsigned cont = (bits >> (16 * j)) & 0xffffu;
        // pair i = contd[i] & contd[i + 1], i = 0..14 (k = i - 7); the pair
        // at k = 0 counts in both directions' sums
        const unsigned pairs = cont & (cont >> 1) & 0x7fffu;
        const int sup = __popc(pairs) + (int)((pairs >> 7) & 1u);
        const float support_px = (float)sup * (c_vlen[dd] * scale);  // full-res px
        if (support_px >= min_sup) out = fmaxf(out, support_px * pk.mag);
      }
    }
    if (lane == 0) best[pk.o] = out;
  }
}

}  // namespace

// scratch: 16 B (the peak count), then H' W' peaks (12 B each), then the
// H' W' dilated mask (2 B each), H' x W' the scanned grid (the half image at
// ds = 2)
extern "C" int sspl_lsd_support(const void* img, int H, int W, int ds, float grad_thresh,
                                float tol, float min_sup, void* scratch, void* best,
                                void* packed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int hs = ds == 2 ? H / 2 : H, ws = ds == 2 ? W / 2 : W;
  const size_t cap = (size_t)hs * ws;
  int* n_peaks = (int*)scratch;
  Peak* peaks = (Peak*)((char*)scratch + 16);
  uint16_t* mask = (uint16_t*)((char*)scratch + 16 + cap * sizeof(Peak));
  const int n_full = ((W + TX - 1) / TX) * ((H + TH - 1) / TH);
  const int n_half = ds == 2 ? ((ws + TX - 1) / TX) * ((hs + TH - 1) / TH) : 0;
  cudaError_t err = cudaMemsetAsync(n_peaks, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  planes_kernel<<<n_full + n_half, dim3(TX, TY), 0, s>>>(
      (const float*)img, H, W, ds, n_full, grad_thresh, tol, mask, (float*)best, peaks,
      n_peaks, (int32_t*)packed);
  const int blocks = (int)((cap + SUP_WARPS - 1) / SUP_WARPS);
  support_kernel<<<blocks < SUP_BLOCKS ? blocks : SUP_BLOCKS, SUP_WARPS * 32, 0, s>>>(
      mask, peaks, n_peaks, hs, ws, min_sup, (float)ds, (float*)best);
  return (int)cudaGetLastError();
}
