// Kernel 26: the merges of the line detector, in one block per call.
//
//   lsd_merge         one octave of `detect_lines`, from the refined
//                     segments (kernel 6's [K, 7]) to the top-L lines:
//                     the collinear fragment links, their closure, the
//                     component's representative and extents, the
//                     pairwise suppression of duplicates, the stable top L
//                     and the line coefficients;
//   lsd_octave_merge  `detect_lines_pyramid`'s cross-octave step: octave-1
//                     lines that duplicate an octave-0 line dropped, then
//                     the stable top L of the 2L candidates.
//
// Replaces the JAX package's structure_slam_pointline_tpu/ops/lsd.py
// :442-536 (the closure "done as boolean matmuls" on [K, K] matrices, the
// suppression, lax.top_k) and :551-641 (the cross-octave dedup and top L).
// The plain versions (ops/lsd.py lsd_merge_plain, lsd_octave_merge_plain)
// build ~40 [K, K] float and boolean planes and four [K, K] float matmuls,
// ~110 launches per octave.
//
// Here the [K, K] relations never reach device memory: each pair's tests
// are recomputed where they are needed, and the links are bit rows in
// shared memory (K x K bits, 8 KB at K = 256). The closure is exactly the
// reference's four squarings (paths of up to 16 hops, not a full closure):
// row i of the square is the OR of the rows k whose bit is set in row i.
// Ranks replace the sort: a candidate's place in the stable top L is the
// number of candidates with a larger key or an equal key and a lower index.
//
// Numerics: built with -fmad=false, every float op rounded on its own in
// the order of the plain version's torch ops; glibc's atan2f
// (csrc/lines.cuh, as kernel 8), jnp.mod, the CUDA math library's cosf /
// sinf (as torch.cos / torch.sin on the card, and as kernel 6);
// torch.linalg.cross's a * b - c * d as an FMA of the first product on the
// second's rounded negation.
//
// Bound on the card: operations. K^2 pairs of the link test (~45
// operations each) and of the suppression test (~40), 4 x K^3 / 32 word
// ORs of the closure at most, K^2 argmax and extent terms (~25); the
// octave merge (2L)^2 pairs (~40).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lines.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 512;
constexpr int REFINE_OUT = 7;  // sx, sy, ex, ey, total_len, mean_mag, response

using lines::angle_diff;
using lines::atan2_glibc;
using lines::HALF_PI;
using lines::jmod;
using lines::PI;

// the host's description of one call (ops/lsd.py _LsdWork)
struct Work {
  int K, L;                   // candidates, lines kept
  float min_length, angle_tol;
  const float* ref;           // lsd_merge: [K, 7] refined segments
  const uint8_t* avalid;      // [K] anchor valid
  const float* ep0;           // lsd_octave_merge: octave 0 and 1 [L, 4] endpoints,
  const float* ep1;           // [L] responses, angles and valid flags
  const float* resp0;
  const float* resp1;
  const float* ang0;
  const float* ang1;
  const uint8_t* valid0;
  const uint8_t* valid1;
  float* endpoints;           // outputs: [L, 4], [L, 3], [L], [L], [L], [L]
  float* line2d;
  float* response;
  float* angle;
  uint8_t* valid;
  int32_t* octave;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// the stable top-L rank of candidate j: keys larger, or equal at a lower index
__device__ __forceinline__ int rank_of(const float* key, int n, int j) {
  const float kj = key[j];
  int r = 0;
  for (int i = 0; i < n; ++i) r += (key[i] > kj) || (key[i] == kj && i < j);
  return r;
}

// ops/lsd.py _line_coeffs of one segment: the cross product of its two
// homogeneous endpoints, normalized by the norm of its first two terms
__device__ __forceinline__ void line_coeffs(float sx, float sy, float ex, float ey, float* out) {
  const float l0 = sy - ey;
  const float l1 = ex - sx;
  const float l2 = __fmaf_rn(sx, ey, -(sy * ex));
  const float n = fmaxf(sqrtf(l0 * l0 + l1 * l1), 1e-9f);
  out[0] = l0 / n;
  out[1] = l1 / n;
  out[2] = l2 / n;
}

// the pair (i, j) of the fragment links' base relation (before symmetry)
__device__ __forceinline__ bool link_base(int i, int j, const float* sx, const float* sy,
                                          const float* ex, const float* ey, const float* tl,
                                          const float* mxm, const float* mym,
                                          const float* dxm, const float* dym,
                                          const float* sd, const uint8_t* ok) {
  if (!ok[i] || !ok[j]) return false;
  if (!(angle_diff(sd[i], sd[j]) < 0.100000001490116119f)) return false;
  const float nx = -dym[i], ny = dxm[i];
  const float ps = fabsf(nx * (sx[j] - mxm[i]) + ny * (sy[j] - mym[i]));
  const float pe = fabsf(nx * (ex[j] - mxm[i]) + ny * (ey[j] - mym[i]));
  if (!(fmaxf(ps, pe) < 2.5f)) return false;
  const float ts = dxm[i] * (sx[j] - mxm[i]) + dym[i] * (sy[j] - mym[i]);
  const float te = dxm[i] * (ex[j] - mxm[i]) + dym[i] * (ey[j] - mym[i]);
  const float lo = fminf(ts, te), hi = fmaxf(ts, te);
  const float half = 0.5f * tl[i];
  return fmaxf(lo - half, -half - hi) < 5.0f;
}

__global__ void __launch_bounds__(THREADS) merge_kernel(const Work w) {
  extern __shared__ float sm[];
  const int K = w.K, L = w.L, KW = (K + 31) / 32;
  float* sx = sm;
  float* sy = sx + K;
  float* ex = sy + K;
  float* ey = ex + K;
  float* tl = ey + K;
  float* mm = tl + K;
  float* resp = mm + K;
  float* mxm = resp + K;
  float* mym = mxm + K;
  float* dxm = mym + K;
  float* dym = dxm + K;
  float* sd = dym + K;
  float* nsx = sd + K;
  float* nsy = nsx + K;
  float* nex = nsy + K;
  float* ney = nex + K;
  float* ntl = ney + K;
  float* nresp = ntl + K;
  float* sang = nresp + K;
  float* mx = sang + K;
  float* my = mx + K;
  float* ca = my + K;
  float* sa = ca + K;
  float* sel = sa + K;
  int* top = (int*)(sel + K);
  uint32_t* A = (uint32_t*)(top + K);
  uint32_t* Bm = A + K * KW;
  uint8_t* ok = (uint8_t*)(Bm + K * KW);
  uint8_t* nok = ok + K;
  const int t = threadIdx.x;

  // the refined segments, `ok`, the midpoints and directions
  for (int k = t; k < K; k += THREADS) {
    const float* r = w.ref + (size_t)k * REFINE_OUT;
    sx[k] = r[0];
    sy[k] = r[1];
    ex[k] = r[2];
    ey[k] = r[3];
    tl[k] = r[4];
    mm[k] = r[5];
    resp[k] = r[6];
    ok[k] = w.avalid[k] && r[4] >= w.min_length;
    mxm[k] = 0.5f * (r[0] + r[2]);
    mym[k] = 0.5f * (r[1] + r[3]);
    const float d = atan2_glibc(r[3] - r[1], r[2] - r[0]);
    sd[k] = d;
    dxm[k] = cosf(d);
    dym[k] = sinf(d);
  }
  __syncthreads();
  // the base relation as bit rows, then link = base | base^T | eye
  for (int q = t; q < K * KW; q += THREADS) {
    const int i = q / KW, wd = q - i * KW;
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int j = wd * 32 + b;
      if (j < K && link_base(i, j, sx, sy, ex, ey, tl, mxm, mym, dxm, dym, sd, ok))
        bits |= 1u << b;
    }
    Bm[q] = bits;
  }
  __syncthreads();
  for (int q = t; q < K * KW; q += THREADS) {
    const int i = q / KW, wd = q - i * KW;
    uint32_t bits = Bm[q];
    for (int b = 0; b < 32; ++b) {
      const int j = wd * 32 + b;
      if (j < K && ((Bm[j * KW + (i >> 5)] >> (i & 31)) & 1u)) bits |= 1u << b;
    }
    if ((i >> 5) == wd) bits |= 1u << (i & 31);
    A[q] = bits;
  }
  __syncthreads();
  // four squarings of the boolean matrix
  uint32_t* cur = A;
  uint32_t* nxt = Bm;
  for (int it = 0; it < 4; ++it) {
    for (int q = t; q < K * KW; q += THREADS) {
      const int i = q / KW, wd = q - i * KW;
      uint32_t acc = 0;
      for (int kw = 0; kw < KW; ++kw) {
        uint32_t m = cur[i * KW + kw];
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          acc |= cur[(kw * 32 + b) * KW + wd];
        }
      }
      nxt[q] = acc;
    }
    __syncthreads();
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // the component's representative (first argmax of the members'
  // responses, -1 elsewhere) and its extents along its own direction
  for (int i = t; i < K; i += THREADS) {
    const uint32_t* row = cur + i * KW;
    float bv = 0.0f, lo = __int_as_float(0x7f800000), hi = neg_inf();
    int bi = 0;
    for (int j = 0; j < K; ++j) {
      const bool memb = ((row[j >> 5] >> (j & 31)) & 1u) && ok[j];
      const float v = memb ? resp[j] : -1.0f;
      if (j == 0 || v > bv) {
        bv = v;
        bi = j;
      }
      if (memb) {
        const float ts = dxm[i] * (sx[j] - mxm[i]) + dym[i] * (sy[j] - mym[i]);
        const float te = dxm[i] * (ex[j] - mxm[i]) + dym[i] * (ey[j] - mym[i]);
        lo = fminf(lo, fminf(ts, te));
        hi = fmaxf(hi, fmaxf(ts, te));
      }
    }
    const bool rep = bi == i && ok[i];
    float a = sx[i], b = sy[i], c = ex[i], d = ey[i], len = tl[i], r = resp[i];
    if (rep) {
      a = mxm[i] + dxm[i] * lo;
      b = mym[i] + dym[i] * lo;
      c = mxm[i] + dxm[i] * hi;
      d = mym[i] + dym[i] * hi;
      len = hi - lo;
      r = len * mm[i];
    }
    nsx[i] = a;
    nsy[i] = b;
    nex[i] = c;
    ney[i] = d;
    ntl[i] = len;
    nresp[i] = r;
    nok[i] = rep;
    const float ang = jmod(atan2_glibc(d - b, c - a) + HALF_PI, PI) - HALF_PI;
    sang[i] = ang;
    mx[i] = 0.5f * (a + c);
    my[i] = 0.5f * (b + d);
    ca[i] = cosf(ang);
    sa[i] = sinf(ang);
  }
  __syncthreads();
  // the pairwise suppression of collinear duplicates, then the keys
  for (int j = t; j < K; j += THREADS) {
    bool keep = nok[j];
    for (int i = 0; i < K && keep; ++i) {
      if (!nok[i]) continue;
      const bool stronger = nresp[i] > nresp[j] || (nresp[i] == nresp[j] && i < j);
      if (!stronger || !(angle_diff(sang[i], sang[j]) < w.angle_tol)) continue;
      const float dmid = fabsf(-sa[i] * (mx[j] - mx[i]) + ca[i] * (my[j] - my[i]));
      if (!(dmid < 3.0f)) continue;
      const float ts = ca[i] * (nsx[j] - mx[i]) + sa[i] * (nsy[j] - my[i]);
      const float te = ca[i] * (nex[j] - mx[i]) + sa[i] * (ney[j] - my[i]);
      const float half = 0.5f * ntl[i];
      const float ov = fminf(fmaxf(ts, te), half) - fmaxf(fminf(ts, te), -half);
      if (ov > -4.0f) keep = false;
    }
    sel[j] = keep ? nresp[j] : neg_inf();
  }
  __syncthreads();
  for (int j = t; j < K; j += THREADS) {
    const int r = rank_of(sel, K, j);
    if (r < L) top[r] = j;
  }
  __syncthreads();
  for (int r = t; r < L; r += THREADS) {
    const int j = top[r];
    const float v = sel[j];
    const bool valid = isfinite(v);
    float* ep = w.endpoints + (size_t)r * 4;
    ep[0] = nsx[j];
    ep[1] = nsy[j];
    ep[2] = nex[j];
    ep[3] = ney[j];
    line_coeffs(nsx[j], nsy[j], nex[j], ney[j], w.line2d + (size_t)r * 3);
    w.response[r] = valid ? v : 0.0f;
    w.angle[r] = sang[j];
    w.valid[r] = valid;
    w.octave[r] = 0;
  }
}

__global__ void __launch_bounds__(THREADS) octave_kernel(const Work w) {
  extern __shared__ float sm[];
  const int L = w.L, N = 2 * L;
  float* sx = sm;
  float* sy = sx + N;
  float* ex = sy + N;
  float* ey = ex + N;
  float* resp = ey + N;
  float* ang = resp + N;
  float* mx = ang + N;
  float* my = mx + N;
  float* len = my + N;
  float* ca = len + N;
  float* sa = ca + N;
  float* sel = sa + N;
  int* top = (int*)(sel + N);
  uint8_t* valid = (uint8_t*)(top + N);
  const int t = threadIdx.x;
  for (int k = t; k < N; k += THREADS) {
    const bool o1 = k >= L;
    const int s = o1 ? k - L : k;
    const float* ep = (o1 ? w.ep1 : w.ep0) + (size_t)s * 4;
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = o1 ? ep[c] * 2.0f + 0.5f : ep[c];
    const bool v = (o1 ? w.valid1 : w.valid0)[s];
    const float r = o1 ? (v ? w.resp1[s] * 2.0f : 0.0f) : w.resp0[s];
    const float a = (o1 ? w.ang1 : w.ang0)[s];
    sx[k] = e[0];
    sy[k] = e[1];
    ex[k] = e[2];
    ey[k] = e[3];
    resp[k] = r;
    ang[k] = a;
    valid[k] = v;
    mx[k] = 0.5f * (e[0] + e[2]);
    my[k] = 0.5f * (e[1] + e[3]);
    // utils/fmath.py hypot: max * sqrt(1 + (min / max)^2)
    const float x = fabsf(e[2] - e[0]), y = fabsf(e[3] - e[1]);
    const float hi = fmaxf(x, y), lo = fminf(x, y);
    const float q = lo / (hi == 0.0f ? 1.0f : hi);
    len[k] = (isinf(x) || isinf(y)) ? __int_as_float(0x7f800000)
                                    : (hi == 0.0f ? hi : hi * sqrtf(1.0f + q * q));
    ca[k] = cosf(a);
    sa[k] = sinf(a);
  }
  __syncthreads();
  // an octave-1 line (j) duplicating an octave-0 line (i) is dropped
  for (int j = t; j < N; j += THREADS) {
    bool keep = valid[j];
    if (keep && j >= L) {
      for (int i = 0; i < L && keep; ++i) {
        if (!valid[i] || !(angle_diff(ang[i], ang[j]) < w.angle_tol)) continue;
        const float dmid = fabsf(-sa[i] * (mx[j] - mx[i]) + ca[i] * (my[j] - my[i]));
        if (!(dmid < 4.0f)) continue;
        const float ts = ca[i] * (sx[j] - mx[i]) + sa[i] * (sy[j] - my[i]);
        const float te = ca[i] * (ex[j] - mx[i]) + sa[i] * (ey[j] - my[i]);
        const float half = 0.5f * len[i];
        const float ov = fminf(fmaxf(ts, te), half) - fmaxf(fminf(ts, te), -half);
        if (ov > 0.0f) keep = false;
      }
    }
    sel[j] = keep ? resp[j] : neg_inf();
  }
  __syncthreads();
  for (int j = t; j < N; j += THREADS) {
    const int r = rank_of(sel, N, j);
    if (r < L) top[r] = j;
  }
  __syncthreads();
  for (int r = t; r < L; r += THREADS) {
    const int j = top[r];
    const float v = sel[j];
    const bool ok = isfinite(v);
    float* ep = w.endpoints + (size_t)r * 4;
    ep[0] = sx[j];
    ep[1] = sy[j];
    ep[2] = ex[j];
    ep[3] = ey[j];
    line_coeffs(sx[j], sy[j], ex[j], ey[j], w.line2d + (size_t)r * 3);
    w.response[r] = ok ? v : 0.0f;
    w.angle[r] = ang[j];
    w.valid[r] = ok;
    w.octave[r] = j >= L;
  }
}

int run(const void* kernel, size_t smem, const Work& w, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {(void*)&w};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(1), dim3(THREADS), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_lsd_merge(const void* work, void* stream) {
  const Work w = *(const Work*)work;
  if (w.K < 1 || w.K > MAX_K || w.L < 1 || w.L > w.K) return (int)cudaErrorInvalidValue;
  const int KW = (w.K + 31) / 32;
  const size_t smem = (size_t)w.K * (24 * 4 + 4 + 2) + (size_t)2 * w.K * KW * 4;
  return run((const void*)merge_kernel, smem, w, (cudaStream_t)stream);
}

extern "C" int sspl_lsd_octave_merge(const void* work, void* stream) {
  const Work w = *(const Work*)work;
  if (w.L < 1 || 2 * w.L > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * w.L * (12 * 4 + 4 + 1);
  return run((const void*)octave_kernel, smem, w, (cudaStream_t)stream);
}
