// Kernels 20 and 21: the duplicate search of the landmark-space fusions,
// one block per recent landmark scanning the whole pool.
//
// Replace the JAX package's structure_slam_pointline_tpu/models/
// local_mapping.py `fuse_duplicate_points_3d` (:593-635) and
// `fuse_duplicate_lines_3d` (:639-707) pair searches. The reference forms
// dense [R, P] planes: the squared distances through a matmul (:609-613),
// the Hamming distance of every pair through an int8 matmul, the gates as
// whole-plane masks, then a row argmin. Here a block owns one recent
// landmark (R = 512 points or 128 lines), its threads stride over the pool
// (32768 points or 2048 lines), test the gates in order (older, geometry,
// then the descriptor: the 8-word Hamming distance is counted only for
// the pairs the geometry passes) and keep the smallest distance with the
// FIRST index that reaches it, as jnp.argmin does; a shared-memory tree
// merges the threads' (distance, index) pairs. Outputs: best (int64, 0
// for an empty row, as argmin of a BIG-filled row) and has.
//
// Numerics: every product and sum goes through __fmul_rn / __fadd_rn /
// __fsub_rn (never contracted to an FMA) in the reference's order (the
// three-term sums x, y, z left to right; d2 = (|a|^2 + |b|^2) - 2 a.b),
// as the plain versions in models/local_mapping.py round each torch op,
// so best and has are bit-equal to them. Against XLA:CPU the sums may
// round apart beside a gate (its matmul and einsum orders are its own).
//
// Bound on the card: kernel 20 reads the pool's 16 B of position and
// validity per pair from L2 (the 1.6 MB pool stays resident) and does ~20
// operations per pair: 512 x 32768 pairs, ~3.4e8 operations, ~5 us at
// the float32 rate; the bytes read from device memory once are ~1.6 MB
// (~0.5 us). Kernel 21: 128 x 2048 pairs at ~70 operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BIG = 1 << 20;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return add(add(mul(x, x), mul(y, y)), mul(z, z));
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

__device__ __forceinline__ int hamming8(const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ b) {
  int d = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) d += __popc((uint32_t)(a[w] ^ b[w]));
  return d;
}

// block-wide (distance, index) minimum, first index on ties; writes the row
__device__ void finish(int dd, int idx, int64_t* __restrict__ best, bool* __restrict__ has,
                       int r) {
  __shared__ int s_d[THREADS], s_i[THREADS];
  s_d[threadIdx.x] = dd;
  s_i[threadIdx.x] = idx;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const int od = s_d[threadIdx.x + h], oi = s_i[threadIdx.x + h];
      if (od < s_d[threadIdx.x] || (od == s_d[threadIdx.x] && oi < s_i[threadIdx.x])) {
        s_d[threadIdx.x] = od;
        s_i[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool found = s_d[0] < BIG;
    best[r] = found ? (int64_t)s_i[0] : 0;
    has[r] = found;
  }
}

__global__ void points_kernel(const float* __restrict__ xyz, const int32_t* __restrict__ desc,
                              const bool* __restrict__ valid,
                              const int32_t* __restrict__ first_kf,
                              const int32_t* __restrict__ rows, int P, int th,
                              int64_t* __restrict__ best, bool* __restrict__ has) {
  const int r = blockIdx.x;
  const int q = rows[r];
  const float xr = xyz[3 * q], yr = xyz[3 * q + 1], zr = xyz[3 * q + 2];
  const float nr = norm2(xr, yr, zr);
  const float t = mul(0.01f, fmaxf(sqrtf(nr), 1.0f));
  const float thresh = mul(t, t);
  const int fk = first_kf[q];
  const int32_t* dr = desc + 8 * (size_t)q;
  int bd = BIG, bi = 0;
  for (int o = threadIdx.x; o < P; o += THREADS) {
    if (!valid[o] || first_kf[o] >= fk) continue;
    const float xo = xyz[3 * o], yo = xyz[3 * o + 1], zo = xyz[3 * o + 2];
    const float d2 = sub(add(nr, norm2(xo, yo, zo)), mul(2.0f, dot3(xr, yr, zr, xo, yo, zo)));
    if (!(d2 <= thresh)) continue;
    const int dd = hamming8(dr, desc + 8 * (size_t)o);
    if (dd <= th && dd < bd) {  // o rises along the thread: the first index wins
      bd = dd;
      bi = o;
    }
  }
  finish(bd, bi, best, has, r);
}

struct Seg {
  float sx, sy, sz, ux, uy, uz, len;
};

__device__ __forceinline__ Seg segment(const float* __restrict__ e) {
  Seg g;
  g.sx = e[0];
  g.sy = e[1];
  g.sz = e[2];
  const float dx = sub(e[3], e[0]), dy = sub(e[4], e[1]), dz = sub(e[5], e[2]);
  g.len = fmaxf(sqrtf(norm2(dx, dy, dz)), 1e-9f);
  g.ux = __fdiv_rn(dx, g.len);
  g.uy = __fdiv_rn(dy, g.len);
  g.uz = __fdiv_rn(dz, g.len);
  return g;
}

// distance of p to the infinite line of o, and p's coordinate along it
__device__ __forceinline__ float perp(float px, float py, float pz, const Seg& o, float* t) {
  const float rx = sub(px, o.sx), ry = sub(py, o.sy), rz = sub(pz, o.sz);
  *t = dot3(rx, ry, rz, o.ux, o.uy, o.uz);
  const float fx = sub(rx, mul(*t, o.ux)), fy = sub(ry, mul(*t, o.uy)),
              fz = sub(rz, mul(*t, o.uz));
  return sqrtf(norm2(fx, fy, fz));
}

__global__ void lines_kernel(const float* __restrict__ ends, const int32_t* __restrict__ desc,
                             const bool* __restrict__ valid,
                             const int32_t* __restrict__ first_kf,
                             const int32_t* __restrict__ rows, int L, int th,
                             int64_t* __restrict__ best, bool* __restrict__ has) {
  const int r = blockIdx.x;
  const int q = rows[r];
  const float* er = ends + 6 * (size_t)q;
  const Seg g = segment(er);
  const float mx = mul(0.5f, add(er[0], er[3])), my = mul(0.5f, add(er[1], er[4])),
              mz = mul(0.5f, add(er[2], er[5]));
  const float tol = mul(0.02f, fmaxf(sqrtf(norm2(mx, my, mz)), 1.0f));
  const float min_overlap = mul(0.25f, g.len);
  const int fk = first_kf[q];
  const int32_t* dr = desc + 8 * (size_t)q;
  int bd = BIG, bi = 0;
  for (int o = threadIdx.x; o < L; o += THREADS) {
    if (!valid[o] || first_kf[o] >= fk) continue;
    const Seg so = segment(ends + 6 * (size_t)o);
    if (!(fabsf(dot3(g.ux, g.uy, g.uz, so.ux, so.uy, so.uz)) > 0.996f)) continue;
    float t_s, t_e;
    const float dist_s = perp(er[0], er[1], er[2], so, &t_s);
    const float dist_e = perp(er[3], er[4], er[5], so, &t_e);
    if (!(dist_s < tol && dist_e < tol)) continue;
    const float overlap = sub(fminf(fmaxf(t_s, t_e), so.len), fmaxf(fminf(t_s, t_e), 0.0f));
    if (!(overlap > min_overlap)) continue;
    const int dd = hamming8(dr, desc + 8 * (size_t)o);
    if (dd <= th && dd < bd) {
      bd = dd;
      bi = o;
    }
  }
  finish(bd, bi, best, has, r);
}

}  // namespace

extern "C" int sspl_fuse_points_3d(const void* xyz, const void* desc, const void* valid,
                                   const void* first_kf, const void* rows, int R, int P,
                                   int th, void* best, void* has, void* stream) {
  points_kernel<<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const int32_t*)desc, (const bool*)valid, (const int32_t*)first_kf,
      (const int32_t*)rows, P, th, (int64_t*)best, (bool*)has);
  return (int)cudaGetLastError();
}

extern "C" int sspl_fuse_lines_3d(const void* ends, const void* desc, const void* valid,
                                  const void* first_kf, const void* rows, int R, int L, int th,
                                  void* best, void* has, void* stream) {
  lines_kernel<<<R, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ends, (const int32_t*)desc, (const bool*)valid, (const int32_t*)first_kf,
      (const int32_t*)rows, L, th, (int64_t*)best, (bool*)has);
  return (int)cudaGetLastError();
}
