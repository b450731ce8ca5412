// Kernel 22: projection, gates, windowed best-2 and unique columns of the
// projection matches, in one pass over (row, feature) pairs.
//
// Replaces the JAX package's structure_slam_pointline_tpu/models/
// local_mapping.py `fuse_projected_points` direction match (:793-834) and
// `fuse_projected_lines` direction match (:911-940), and models/
// loop_closing.py `_project_pool_matches` (:104) and
// `_sim3_widen_matches` (:55). The reference projects each row, writes a
// dense [B, M, N] candidate mask (ops/matching.py window_mask), a
// [B, M, N] Hamming matrix, then reduces rows (argmin, re-mask, argmin)
// and claims columns (a scatter-min of dist * M + row). Here no [B, M, N]
// plane exists. Four entries, one per caller:
//
//   fuse_match_points  rows = the landmarks bound to the source keyframe
//                      of each of the 2W directions; gates: depth, scale
//                      band, viewing angle, predicted octave, in-image;
//                      window 3 sf^octave with octave slack 1; TH_LOW;
//                      then the chi2 gate at the matched feature's octave
//   fuse_match_lines   rows = the map lines bound to the source keyframe;
//                      projected midpoints within 8 px, both endpoints in
//                      front, the undirected angle within 0.26 rad (glibc
//                      atan2f, csrc/lines.cuh, as kernel 8); TH_HIGH
//   pool_match         rows = the loop pool's landmarks through M_cw of
//                      each keyframe (B = 1 in verify, 8 in the loop fuse)
//   sim3_widen_match   rows = keyframe k's bound features, columns =
//                      cand's; a pair is a candidate when both Sim(3)
//                      projections land within 7.5 px
//   track_match_points rows = the tracking round's local landmarks, columns
//                      = the frame's keypoints (models/tracking.py
//                      `_match_points`, JAX :187): the fuse's gates at a
//                      4 px margin, the window radius_scale sf^octave,
//                      TH_HIGH, the ratio test waived across octaves,
//                      unique columns, then (pass 1) the rotation
//                      histogram's three most popular bins
//   track_match_lines  rows = the local map lines, columns = the frame's
//                      lines (`_match_lines`, JAX :243): both endpoints in
//                      front, the midpoint in the image (4 px) and within
//                      the radius, the undirected angle within 0.26 rad,
//                      TH_HIGH, ratio 0.9, unique columns, then the MAD
//                      margin gate (two lower medians over the valid rows)
//
// Launches of one entry: a memset of the [B, N] column keys, then
//   A. a warp per (batch, row): every lane computes the row's projection
//      and gates (the same values in every lane), the block stages the
//      target keyframe's feature positions, octaves (lines: midpoints and
//      angles; widen: cand's Sim(3) projections) and valid flags in shared
//      memory, 1024 columns at a time; the lanes stride over the columns,
//      test the window (and octave / angle) at every one and read the 32 B
//      descriptor and count the distance only inside it. The row's list
//      follows kernel 3's rule exactly (csrc/top2.cuh: a masked distance
//      is 2^20, first index on ties, the best column re-masked before the
//      second), so an empty row keeps best 2^20, idx 0, valid false. A row
//      with best <= max_dist takes its column with an atomicMin of the
//      integer key best * M + row (the reference's float32 key is exact
//      below 2^24, so the two order alike); the points entry also tests
//      the chi2 gate here. A block with no visible row skips the scan.
//   B. a thread per (batch, row): valid = ok, its key won the column and
//      (points) the chi2 gate passed. The tracking entries instead take a
//      block per batch, which also applies the gates that need every row:
//      the rotation histogram (ops/matching.py rotation_consistency: the
//      third largest bin count, ties as torch.sort takes it) or the MAD
//      margin gate (mad_margin_gate: lower medians by rank among the
//      valid rows). The tracking rows also get the ratio test in launch A
//      (best < ratio * min(second, 2^20), the second from top2::finish),
//      before their column claim, as masked_match orders it.
//
// Numerics: built with -fmad=false, and every product and sum of the
// projection is written out (__fmul_rn, __fadd_rn, __fmaf_rn) in the
// order of the plain version's torch ops on the card: the 3x3 products
// (cuBLAS) as FMA chains, the norms and the torch.sum of a 3-vector in
// PyTorch's reduction order (sum3), each scalar op rounded alone, division by a
// Python scalar as the multiply by its float32 reciprocal that PyTorch's
// CUDA kernel uses. The sf^k tables come from torch.pow on the same
// device (the wrapper); logf is the CUDA math library's, equal to
// torch.log's under either -fmad (tools/fuse_numerics.py). The last bit
// matters: the predicted octave ceil(log(dmax / dist) / log(sf)) sits on
// its gate for every landmark seen from the distance it was made at, and
// with the norm summed in another order rows of phase 2d flipped there
// (tools/fuse_shadow.py). chip_smoke.py prints any row that differs from
// the plain version with the gate nearest its threshold.
//
// Bound on the card: operations. Per (row, feature) pair of a visible row
// the window test (~8 operations); per pair inside the window the 8-word
// distance (~27, kernel 3's count); per row the projection and gates.
// Device memory: the rows' landmarks and the target features read once,
// 9 B a row written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lines.cuh"
#include "top2.cuh"

namespace {

constexpr int ROWS = 8;       // warps (rows) per block
constexpr int CHUNK = 1024;   // columns staged per pass
constexpr int FIN_THREADS = 256;

enum Mode { POINTS = 0, LINES = 1, POOL = 2, WIDEN = 3, TRACK_POINTS = 4, TRACK_LINES = 5 };
constexpr int TRACK_THREADS = 1024;
constexpr int MAX_BINS = 64;          // rotation histogram bins
constexpr int MAX_TRACK_ROWS = 4096;  // rows of a tracking lines call (the medians)

__host__ __device__ constexpr bool is_points(int mode) {
  return mode == POINTS || mode == TRACK_POINTS;
}
__host__ __device__ constexpr bool is_lines(int mode) {
  return mode == LINES || mode == TRACK_LINES;
}
__host__ __device__ constexpr bool is_track(int mode) {
  return mode == TRACK_POINTS || mode == TRACK_LINES;
}

// the host's description of one call (kernels.py passes its address; the
// C entry copies it into the kernels' parameters)
struct Work {
  int B, M, N;         // batches, rows per batch, target features per keyframe
  int P;               // rows' landmark pool (ids clamp to it)
  int n_levels, max_dist;
  int k, cand;         // widen: the two keyframes
  float fx, fy, cx, cy;
  float width, height;  // image size (the in-image gate, margin 2)
  float radius;        // window (points: its scale, times sf^octave)
  float inv_log_sf;    // points: float32(1) / float32(log sf)
  const int32_t* a_ids;      // [B] source keyframes (points, lines)
  const int32_t* b_ids;      // [B] target keyframes (all but widen)
  const uint8_t* present;    // [B] (points, lines)
  const float* M_cw;         // [B, 4, 4] (pool)
  const int32_t* table;      // [K, M] landmark ids by feature (points, lines, widen)
  const int32_t* pool_ids;   // [M] (pool)
  const float* xyz;          // [P, 3] (points, pool, widen)
  const float* dmin;         // [P] (points)
  const float* dmax;         // [P]
  const float* normal;       // [P, 3]
  const int32_t* desc;       // rows' descriptors: [P, 8], widen kf_desc [K, N, 8]
  const float* endpoints;    // [P, 6] (lines)
  const float* kf_T;         // [K, 4, 4]
  const float* S12;          // [4, 4] (widen)
  const float* S21;          // [4, 4]
  const float* kf_xy;        // [K, N, 2] (points, pool, widen)
  const float* line_ep;      // [K, N, 4] (lines)
  const uint8_t* kf_valid;   // [K, N] feature valid (widen: unused, bound instead)
  const int32_t* kf_oct;     // [K, N] (points)
  const int32_t* kf_desc;    // [K, N, 8]
  const float* pow_sf;       // [n_levels] sf^k (points)
  const float* sig2;         // [n_levels] sf^2k
  int32_t* idx;              // [B, M] outputs
  int32_t* dist;
  uint8_t* valid;
  int32_t* col_key;          // [B, N] scratch
  uint8_t* flags;            // [B, M] scratch: 1 ok, 2 chi2
  float margin;              // in-image margin (fuses 2, tracking 4)
  float ratio;               // tracking: the ratio test, applied below 1
  float inv_two_pi;          // tracking points: float32(1) / float32(2 pi)
  float mad_scale;           // tracking lines: float32(line_mad_ratio x 1.4826)
  int n_bins;                // tracking points: rotation bins (0: no check)
  const float* ref_angle;    // [P] landmark angles (tracking points)
  const float* frame_angle;  // [B, N] keypoint angles
  uint8_t* visible;          // [B, M] tracking output: the row's gates passed
  int32_t* aux;              // [B, M] scratch: rotation bin / second distance
};
// the tracking entries read the frame where the fuses read a keyframe:
// row ids in pool_ids [B, M], the pose in kf_T [B, 4, 4], the frame's
// features in kf_xy / line_ep / kf_valid / kf_oct / kf_desc [B, N, ...]

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// row i of R p + t, R and t the 3x4 head of a row-major 4x4: the matmul's
// FMA chain, then the add
__device__ __forceinline__ void transform(const float* T, float x, float y, float z,
                                          float& ox, float& oy, float& oz) {
  ox = add(__fmaf_rn(z, T[2], __fmaf_rn(y, T[1], mul(x, T[0]))), T[3]);
  oy = add(__fmaf_rn(z, T[6], __fmaf_rn(y, T[5], mul(x, T[4]))), T[7]);
  oz = add(__fmaf_rn(z, T[10], __fmaf_rn(y, T[9], mul(x, T[8]))), T[11]);
}

// utils/camera.py project: (u, v) and the depth
__device__ __forceinline__ void project(const Work& w, float x, float y, float z, float& u,
                                        float& v) {
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  u = add(mul(x / zs, w.fx), w.cx);
  v = add(mul(y / zs, w.fy), w.cy);
}

__device__ __forceinline__ bool in_image(const Work& w, float u, float v) {
  return u >= w.margin && u < w.width - w.margin && v >= w.margin &&
         v < w.height - w.margin;
}

// PyTorch's reduction of a contiguous 3-vector on the card, (a + c) + b:
// torch.linalg.norm equals sqrt of that sum of squares, each rounded, on
// every one of 10^6 seeded vectors (tools/fuse_numerics.py; on the CPU it
// is the FMA chain instead); torch.sum likewise
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, c), b); }

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf(sum3(mul(x, x), mul(y, y), mul(z, z)));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

struct Row {
  bool vis;
  float u, v;      // projection (lines: the midpoint; widen: uv1_in2)
  float rad;       // window radius
  int oct;         // points: predicted octave
  float ang;       // lines: projected angle
  float kx, ky;    // widen: the row's own feature position
  int tgt;         // target keyframe (tracking: the batch's frame)
  int s;           // the row's landmark slot
  uint32_t d[8];   // descriptor
};

template <int MODE>
__device__ __forceinline__ int target(const Work& w, int b) {
  if constexpr (MODE == WIDEN) return w.cand;
  if constexpr (is_track(MODE)) return b;
  return w.b_ids[b];
}

template <int MODE>
__device__ void row_setup(const Work& w, int b, int m, Row& r) {
  const int32_t* dsrc = nullptr;
  r.tgt = target<MODE>(w, b);
  if constexpr (is_points(MODE) || is_lines(MODE)) {
    int id;
    bool has;
    if constexpr (is_track(MODE)) {
      id = w.pool_ids[(size_t)b * w.M + m];
      has = id >= 0;
    } else {
      id = w.table[(size_t)w.a_ids[b] * w.M + m];
      has = id >= 0 && w.present[b];
    }
    const int s = clampi(id, 0, w.P - 1);
    r.s = s;
    dsrc = w.desc + (size_t)s * 8;
    const float* T = w.kf_T + (size_t)r.tgt * 16;
    if constexpr (is_points(MODE)) {
      const float X = w.xyz[3 * s], Y = w.xyz[3 * s + 1], Z = w.xyz[3 * s + 2];
      float px, py, pz;
      transform(T, X, Y, Z, px, py, pz);
      project(w, px, py, pz, r.u, r.v);
      const float dist = norm3(px, py, pz);
      const float dmin = w.dmin[s], dmax = w.dmax[s];
      const bool no_band = dmax <= 0.0f || dmax >= 1e8f;
      const bool band_ok = no_band || (dist >= mul(dmin, 0.8f) && dist <= mul(dmax, 1.2f));
      // camera centre -(R^T t), then the unit ray from it: the fuses' batched
      // product is an FMA chain, the tracking round's torch.mv an FMA of the
      // first two terms with the third added (tools/fuse_numerics.py)
      float c[3];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        c[j] = MODE == POINTS
                   ? -__fmaf_rn(T[11], T[8 + j], __fmaf_rn(T[7], T[4 + j], mul(T[3], T[j])))
                   : -add(__fmaf_rn(T[7], T[4 + j], mul(T[3], T[j])), mul(T[11], T[8 + j]));
      float rx = sub(X, c[0]), ry = sub(Y, c[1]), rz = sub(Z, c[2]);
      const float rn = fmaxf(norm3(rx, ry, rz), 1e-9f);
      rx = rx / rn;
      ry = ry / rn;
      rz = rz / rn;
      const float nx = w.normal[3 * s], ny = w.normal[3 * s + 1], nz = w.normal[3 * s + 2];
      const bool has_nrm = norm3(nx, ny, nz) > 0.5f;
      const bool view_ok = !has_nrm || sum3(mul(rx, nx), mul(ry, ny), mul(rz, nz)) > 0.5f;
      // ops/matching.py predict_octave
      const float maxd = no_band ? dist : dmax;
      const float ratio = fmaxf(maxd / fmaxf(dist, 1e-6f), 1.0f);
      const float lv = ceilf(mul(logf(ratio), w.inv_log_sf));
      r.oct = clampi((int)lv, 0, w.n_levels - 1);
      r.rad = mul(w.radius, w.pow_sf[r.oct]);
      r.vis = has && pz > 0.1f && band_ok && view_ok && in_image(w, r.u, r.v);
    } else {
      const float* ep = w.endpoints + (size_t)s * 6;
      float sx, sy, sz, ex, ey, ez, us, vs, ue, ve;
      transform(T, ep[0], ep[1], ep[2], sx, sy, sz);
      transform(T, ep[3], ep[4], ep[5], ex, ey, ez);
      project(w, sx, sy, sz, us, vs);
      project(w, ex, ey, ez, ue, ve);
      r.u = mul(0.5f, add(us, ue));
      r.v = mul(0.5f, add(vs, ve));
      r.ang = lines::atan2_glibc(sub(ve, vs), sub(ue, us));
      r.rad = w.radius;
      r.vis = has && sz > 0.1f && ez > 0.1f && in_image(w, r.u, r.v);
    }
  } else if constexpr (MODE == POOL) {
    const int id = w.pool_ids[m];
    const int s = clampi(id, 0, w.P - 1);
    dsrc = w.desc + (size_t)s * 8;
    float px, py, pz;
    transform(w.M_cw + (size_t)b * 16, w.xyz[3 * s], w.xyz[3 * s + 1], w.xyz[3 * s + 2], px,
              py, pz);
    project(w, px, py, pz, r.u, r.v);
    r.rad = w.radius;
    r.vis = id >= 0 && pz > 0.1f;
  } else {  // WIDEN: row m is feature m of keyframe k, seen from cand
    const int id = w.table[(size_t)w.k * w.M + m];
    const int s = clampi(id, 0, w.P - 1);
    dsrc = w.kf_desc + ((size_t)w.k * w.M + m) * 8;
    float x1, y1, z1, x2, y2, z2;
    transform(w.kf_T + (size_t)w.k * 16, w.xyz[3 * s], w.xyz[3 * s + 1], w.xyz[3 * s + 2],
              x1, y1, z1);
    transform(w.S21, x1, y1, z1, x2, y2, z2);
    project(w, x2, y2, z2, r.u, r.v);
    r.kx = w.kf_xy[((size_t)w.k * w.M + m) * 2];
    r.ky = w.kf_xy[((size_t)w.k * w.M + m) * 2 + 1];
    r.rad = w.radius;
    r.vis = id >= 0 && z2 > 0.1f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) r.d[j] = (uint32_t)dsrc[j];
}

struct Cols {
  float2 xy[CHUNK];   // feature position (lines: the observed midpoint)
  float2 aux[CHUNK];  // lines: (angle, -); widen: cand's landmark projected into k
  int oct[CHUNK];     // points: octave
  uint8_t ok[CHUNK];  // feature valid (widen: bound and in front of k)
};

template <int MODE>
__device__ void stage(const Work& w, int tgt, int c0, int nc, Cols& cs) {
  for (int i = threadIdx.x; i < nc; i += blockDim.x) {
    const size_t f = (size_t)tgt * w.N + c0 + i;
    if constexpr (is_lines(MODE)) {
      const float* ep = w.line_ep + f * 4;
      cs.xy[i] = make_float2(mul(0.5f, add(ep[0], ep[2])), mul(0.5f, add(ep[1], ep[3])));
      cs.aux[i].x = lines::atan2_glibc(sub(ep[3], ep[1]), sub(ep[2], ep[0]));
      cs.ok[i] = w.kf_valid[f];
    } else {
      cs.xy[i] = make_float2(w.kf_xy[2 * f], w.kf_xy[2 * f + 1]);
      if constexpr (is_points(MODE)) {
        cs.oct[i] = w.kf_oct[f];
        cs.ok[i] = w.kf_valid[f];
      } else if constexpr (MODE == POOL) {
        cs.ok[i] = w.kf_valid[f];
      } else {  // WIDEN: X2 = cand's landmark in cand's frame, through S12 into k
        const int id = w.table[f];
        const int s = clampi(id, 0, w.P - 1);
        float x2, y2, z2, x1, y1, z1, u, v;
        transform(w.kf_T + (size_t)tgt * 16, w.xyz[3 * s], w.xyz[3 * s + 1],
                  w.xyz[3 * s + 2], x2, y2, z2);
        transform(w.S12, x2, y2, z2, x1, y1, z1);
        project(w, x1, y1, z1, u, v);
        cs.aux[i] = make_float2(u, v);
        cs.ok[i] = id >= 0 && z1 > 0.1f;
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ bool allowed(const Row& r, const Cols& cs, int i) {
  if (!cs.ok[i]) return false;
  const float2 c = cs.xy[i];
  if (!(fabsf(sub(r.u, c.x)) <= r.rad && fabsf(sub(r.v, c.y)) <= r.rad)) return false;
  if constexpr (is_points(MODE)) return abs(cs.oct[i] - r.oct) <= 1;
  if constexpr (is_lines(MODE)) return lines::angle_diff(r.ang, cs.aux[i].x) < 0.26f;
  if constexpr (MODE == WIDEN)
    return fabsf(sub(cs.aux[i].x, r.kx)) <= r.rad && fabsf(sub(cs.aux[i].y, r.ky)) <= r.rad;
  return true;
}

template <int MODE>
__global__ void __launch_bounds__(ROWS * 32) match_kernel(const Work w) {
  __shared__ Cols cs;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS + warp;
  const bool row_ok = m < w.M;
  Row r;
  r.vis = false;
  r.s = 0;
  r.tgt = target<MODE>(w, b);
  if (row_ok) row_setup<MODE>(w, b, m, r);
  const bool any = __syncthreads_or(row_ok && r.vis);
  top2::Top2 t = top2::empty();
  if (any) {
    for (int c0 = 0; c0 < w.N; c0 += CHUNK) {
      const int nc = min(CHUNK, w.N - c0);
      __syncthreads();
      stage<MODE>(w, r.tgt, c0, nc, cs);
      __syncthreads();
      if (!(row_ok && r.vis)) continue;
      for (int i = lane; i < nc; i += 32) {
        const int j = c0 + i;
        int d = top2::BIG;
        if (allowed<MODE>(r, cs, i)) {
          const uint4* q = reinterpret_cast<const uint4*>(
              w.kf_desc + ((size_t)r.tgt * w.N + j) * 8);
          const uint4 p0 = q[0], p1 = q[1];
          d = __popc(r.d[0] ^ p0.x) + __popc(r.d[1] ^ p0.y) + __popc(r.d[2] ^ p0.z) +
              __popc(r.d[3] ^ p0.w) + __popc(r.d[4] ^ p1.x) + __popc(r.d[5] ^ p1.y) +
              __popc(r.d[6] ^ p1.z) + __popc(r.d[7] ^ p1.w);
        }
        top2::push(t, d, j);
      }
    }
  }
  if (!row_ok) return;
  int best = top2::BIG, best_j = 0;
  int second = top2::BIG, second_j = w.N > 1 ? 1 : 0;
  if (r.vis) {  // else every column is masked: kernel 3's empty row
    top2::warp_merge(t);
    best = t.v0;
    best_j = t.j0;
    top2::finish(t, second, second_j);
  }
  if (lane != 0) return;
  const size_t o = (size_t)b * w.M + m;
  uint8_t fl = 0;
  bool ok = best <= w.max_dist;
  if constexpr (is_track(MODE)) {
    // masked_match's ratio test, waived (points) when best and second
    // sit on different octaves
    if (w.ratio < 1.0f) {
      bool passes = (float)best < mul(w.ratio, (float)min(second, top2::BIG));
      if constexpr (MODE == TRACK_POINTS) {
        const int32_t* oc = w.kf_oct + (size_t)r.tgt * w.N;
        passes = passes || oc[best_j] != oc[second_j];
      }
      ok = ok && passes;
    }
    w.visible[o] = r.vis;
    if constexpr (MODE == TRACK_POINTS) {
      // the rotation bin of the angle delta (rotation_consistency): jnp.mod
      // by 2 pi, the division by 2 pi as PyTorch's multiply by its
      // reciprocal, floor, Python's modulo
      const float delta = lines::jmod(
          sub(w.ref_angle[r.s], w.frame_angle[(size_t)r.tgt * w.N + best_j]), lines::TWO_PI);
      const int bin = (int)floorf(mul(mul(delta, w.inv_two_pi), (float)w.n_bins));
      w.aux[o] = w.n_bins > 0 ? ((bin % w.n_bins) + w.n_bins) % w.n_bins : 0;
    } else {
      w.aux[o] = second;
    }
  }
  if (ok) {
    fl = 1;
    atomicMin(&w.col_key[(size_t)b * w.N + best_j], best * w.M + m);
  }
  if constexpr (MODE == POINTS) {
    // the chi2 gate at the matched feature's octave (the plain version
    // tests every row; only valid rows keep it)
    const size_t f = (size_t)r.tgt * w.N + best_j;
    const float du = sub(r.u, w.kf_xy[2 * f]), dv = sub(r.v, w.kf_xy[2 * f + 1]);
    const float e2 = add(mul(du, du), mul(dv, dv));
    const int ko = clampi(w.kf_oct[f], 0, w.n_levels - 1);
    if (e2 <= mul(5.991f, w.sig2[ko])) fl |= 2;
  } else {
    fl |= 2;
  }
  w.idx[o] = best_j;
  w.dist[o] = best;
  w.flags[o] = fl;
}

__global__ void finish_kernel(const Work w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w.B * w.M) return;
  const int b = i / w.M, m = i - b * w.M;
  const uint8_t fl = w.flags[i];
  const int j = w.idx[i];
  w.valid[i] = (fl & 1) && (fl & 2) &&
               w.col_key[(size_t)b * w.N + j] == w.dist[i] * w.M + m;
}

// the tracking entries' finish, a block per batch: valid = ok and the
// row's key won its column; then the rotation histogram (points, n_bins >
// 0) or the MAD margin gate (lines), which need all of the batch's rows

// the k-th smallest of the valid rows' x (by rank: as many below it as
// fit under k, and more at or below it), written to *out by the threads
// that hold it; the caller synchronizes
__device__ void kth_valid(const float* x, const uint8_t* v, int M, int k, float* out) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    if (!v[i]) continue;
    int below = 0, at = 0;
    for (int j = 0; j < M; ++j) {
      if (!v[j]) continue;
      below += x[j] < x[i];
      at += x[j] <= x[i];
    }
    if (below <= k && k < at) *out = x[i];
  }
}

template <int MODE>
__global__ void __launch_bounds__(TRACK_THREADS) track_finish_kernel(const Work w) {
  __shared__ int hist[MAX_BINS];
  __shared__ int n_valid, thresh;
  __shared__ float med, mad;
  __shared__ float xs[MODE == TRACK_LINES ? MAX_TRACK_ROWS : 1];
  __shared__ uint8_t vs[MODE == TRACK_LINES ? MAX_TRACK_ROWS : 1];
  const int b = blockIdx.x, M = w.M;
  const size_t base = (size_t)b * M;
  if (threadIdx.x < MAX_BINS) hist[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    n_valid = 0;
    med = 0.0f;
    mad = 0.0f;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const size_t o = base + m;
    const bool v = (w.flags[o] & 1) &&
                   w.col_key[(size_t)b * w.N + w.idx[o]] == w.dist[o] * M + m;
    w.valid[o] = v;
    if constexpr (MODE == TRACK_POINTS) {
      if (v && w.n_bins > 0) atomicAdd(&hist[w.aux[o]], 1);
    } else {
      // margin = second - best where the second is a distance, else 255
      const int sec = min(w.aux[o], top2::BIG);
      xs[m] = sec < top2::BIG ? (float)sec - (float)w.dist[o] : 255.0f;
      vs[m] = v;
      if (v) atomicAdd(&n_valid, 1);
    }
  }
  __syncthreads();
  if constexpr (MODE == TRACK_POINTS) {
    if (w.n_bins <= 0) return;
    if (threadIdx.x == 0) {
      // the third largest count (torch.sort descending, [keep_bins - 1])
      int top[3] = {-1, -1, -1};
      for (int i = 0; i < w.n_bins; ++i) {
        int c = hist[i];
        for (int k = 0; k < 3; ++k)
          if (c > top[k]) {
            const int tmp = top[k];
            top[k] = c;
            c = tmp;
          }
      }
      thresh = max(top[2], 1);
    }
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const size_t o = base + m;
      if (w.valid[o] && hist[w.aux[o]] < thresh) w.valid[o] = 0;
    }
  } else {
    const int n = n_valid;
    if (n > 0) kth_valid(xs, vs, M, (n - 1) / 2, &med);
    __syncthreads();
    const float md = med;
    __syncthreads();
    for (int m = threadIdx.x; m < M; m += blockDim.x) xs[m] = fabsf(sub(xs[m], md));
    __syncthreads();
    if (n > 0) kth_valid(xs, vs, M, (n - 1) / 2, &mad);
    __syncthreads();
    const float gate = mul(w.mad_scale, mad);
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      // xs now holds |margin - med|; the margin is md +- it
      const size_t o = base + m;
      const int sec = min(w.aux[o], top2::BIG);
      const float margin = sec < top2::BIG ? (float)sec - (float)w.dist[o] : 255.0f;
      if (vs[m] && !(margin > gate)) w.valid[o] = 0;
    }
  }
}

template <int MODE>
int run(const Work* wp, void* stream) {
  const Work w = *wp;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(w.col_key, 0x7f, sizeof(int32_t) * w.B * w.N, s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((w.M + ROWS - 1) / ROWS, w.B);
  match_kernel<MODE><<<grid, ROWS * 32, 0, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (is_track(MODE)) {
    track_finish_kernel<MODE><<<w.B, TRACK_THREADS, 0, s>>>(w);
  } else {
    const int n = w.B * w.M;
    finish_kernel<<<(n + FIN_THREADS - 1) / FIN_THREADS, FIN_THREADS, 0, s>>>(w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sspl_fuse_match_points(const void* work, void* stream) {
  return run<POINTS>((const Work*)work, stream);
}

extern "C" int sspl_fuse_match_lines(const void* work, void* stream) {
  return run<LINES>((const Work*)work, stream);
}

extern "C" int sspl_pool_match(const void* work, void* stream) {
  return run<POOL>((const Work*)work, stream);
}

extern "C" int sspl_sim3_widen_match(const void* work, void* stream) {
  return run<WIDEN>((const Work*)work, stream);
}

extern "C" int sspl_track_match_points(const void* work, void* stream) {
  const Work* w = (const Work*)work;
  if (w->n_bins > MAX_BINS) return (int)cudaErrorInvalidValue;
  return run<TRACK_POINTS>(w, stream);
}

extern "C" int sspl_track_match_lines(const void* work, void* stream) {
  const Work* w = (const Work*)work;
  if (w->M > MAX_TRACK_ROWS) return (int)cudaErrorInvalidValue;
  return run<TRACK_LINES>(w, stream);
}
