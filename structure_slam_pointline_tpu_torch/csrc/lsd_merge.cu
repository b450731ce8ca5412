// Kernel 26: the merges of the line detector.
//
//   lsd_merge         one octave of `detect_lines`, from the refined
//                     segments (kernel 6's [K, 7]) to the top-L lines:
//                     the collinear fragment links, their closure, the
//                     component's representative and extents, the
//                     pairwise suppression of duplicates, the stable top L
//                     and the line coefficients; one cluster of 8 blocks
//                     of 1024 threads;
//   lsd_octave_merge  `detect_lines_pyramid`'s cross-octave step: octave-1
//                     lines that duplicate an octave-0 line dropped, then
//                     the stable top L of the 2L candidates; one block.
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
// shared memory (K x K bits, 8 KB at K = 256). The two pair phases, the
// links and the suppression (K^2 pairs each, ~2/3 of one block's time),
// are split over the cluster's 8 blocks, each owning every 8th row; the
// rest runs in every block alike (no exchange but two):
//   links        a warp per owned row i, rows taken one at a time (their
//                work differs). A cheap direction prefilter (a superset of
//                the exact angle gate: the undirected difference within
//                the tolerance plus 1e-3) over lanes j lists the survivors
//                by ballot; the exact gates run on the list, the cheap
//                ones first, and set bits by shared atomicOr. Each
//                finished row is written into every block's copy of the
//                matrix (distributed shared memory), then a cluster
//                barrier. base^T: word I of row r holds bit r of rows
//                32 I .. 32 I + 31, read by broadcast, no collectives.
//   closure      exactly the reference's four squarings (paths of up to 16
//                hops, not a full closure; a 40-fragment chain merges to
//                33 members): a thread per (row, word) ORs that word of
//                the rows whose bit is set. A row none of whose members
//                changed in the last squaring is its own square and is
//                copied; once no row changes, the rest are skipped.
//   extents      a thread per row walks its members' bits: the first
//                argmax (largest response, then lowest index; the
//                non-members' -1 enters as the first non-member), the
//                min / max of the projections, then the merged segment.
//   suppression  a warp per owned candidate j: the stronger
//                representatives in a similar direction listed by ballot,
//                the exact gates on the list, ended at the first
//                suppressor; the key written into block 0's, then a
//                cluster barrier.
//   rank         block 0, T threads per candidate count the keys larger,
//                or equal at a lower index; shuffles add the shares.
// Every float op keeps the plain version's operands and order; the
// prefilters only skip pairs whose exact gate fails, and the gates of a
// pair are a conjunction, so their order does not change it.
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
//
// Built with -DSSPL_LSD_TRACE (tools/kernel_ab.py --trace), merge_kernel's
// block 0 writes each phase's end (the clock64 of its last warp to finish)
// and each row's popcount before and after each squaring into Work::trace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lines.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;  // lsd_merge's blocks: the pair phases split over 8 SMs
constexpr int MAX_K = 512;
constexpr int MAX_KW = MAX_K / 32;
constexpr int REFINE_OUT = 7;  // sx, sy, ex, ey, total_len, mean_mag, response
constexpr unsigned FULL = 0xffffffffu;
constexpr float PREFILTER_SLACK = 1e-3f;  // far above the gates' few-ulp rounding
// trace layout (int64): 12 clock64 marks (start, stage, links, transpose,
// 4 squarings, extents, suppression, rank, write), the 4 squarings'
// walked-row counts, the squarings run, then 5 x K row popcounts (the
// links, after each squaring)
constexpr int TRACE_WALKED = 12;
constexpr int TRACE_SQUARINGS = 16;
constexpr int TRACE_HEAD = 20;

using lines::angle_diff;
using lines::atan2_glibc;
using lines::HALF_PI;
using lines::jmod;
using lines::PI;
using lines::TWO_PI;

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
  long long* trace;           // -DSSPL_LSD_TRACE builds only (else unused)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// a superset of angle_diff(a, b) < tol for a, b in [-pi, pi]: the distance
// of a - b to the nearest multiple of pi, within tol plus the slack
__device__ __forceinline__ bool near_dir(float a, float b, float tol) {
  const float d = fabsf(a - b);
  const float e = fminf(fminf(d, fabsf(d - PI)), fabsf(d - TWO_PI));
  return e < tol + PREFILTER_SLACK;
}

// threads per candidate in the pair loops: a power of 2, at most 32, with
// T * n <= THREADS (n <= MAX_K), so one pass of the block covers n
__device__ __forceinline__ int parts_for(int n) {
  int T = 1;
  while (T < 32 && 2 * T * n <= THREADS) T *= 2;
  return T;
}

// the stable top L of n keys: candidate j's slot is the number of keys
// larger, or equal at a lower index; T threads count a candidate's share
// and shuffles add the shares
__device__ __forceinline__ void rank_top(const float* key, int n, int L, int* top) {
  const int T = parts_for(n), j = threadIdx.x / T, part = threadIdx.x & (T - 1);
  int r = 0;
  if (j < n) {
    const float kj = key[j];
#pragma unroll 8
    for (int i = part; i < n; i += T) r += (key[i] > kj) || (key[i] == kj && i < j);
  }
  for (int off = 1; off < T; off <<= 1) r += __shfl_xor_sync(FULL, r, off);
  if (j < n && part == 0 && r < L) top[r] = j;
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

// trace builds: a phase's end is the clock of the last warp to finish it,
// read after that warp's arrival count (so not ahead of its own work, as a
// read after the barrier may be scheduled); only the cluster's first
// block writes the trace (`trace` is null elsewhere)
__device__ __forceinline__ void trace_arrive(long long* trace, int mark, int* arrived) {
#ifdef SSPL_LSD_TRACE
  __syncwarp();
  if (trace && (threadIdx.x & 31) == 0 && (atomicAdd(arrived, 1) + 1) % WARPS == 0)
    trace[mark] = clock64();
#endif
}

__device__ __forceinline__ void phase_end(long long* trace, int mark, int* arrived) {
  trace_arrive(trace, mark, arrived);
  __syncthreads();
}

// each row's popcount into the trace's slot s (trace builds)
__device__ __forceinline__ void trace_popcounts(long long* trace, const uint32_t* m, int K,
                                                int KW, int s) {
#ifdef SSPL_LSD_TRACE
  for (int i = threadIdx.x; trace && i < K; i += THREADS) {
    int p = 0;
    for (int kw = 0; kw < KW; ++kw) p += __popc(m[i * KW + kw]);
    trace[TRACE_HEAD + s * K + i] = p;
  }
#endif
}

__global__ void __launch_bounds__(THREADS) merge_kernel(const Work w) {
  extern __shared__ float sm[];
  const int K = w.K, L = w.L, KW = (K + 31) / 32, KP = KW * 32;
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
  uint32_t* A = (uint32_t*)(top + K);  // [KP, KW] bit rows
  uint32_t* Bm = A + KP * KW;          // [KP, KW]
  uint32_t* chg = Bm + KP * KW;        // [3, MAX_KW]: rows changed by a squaring
  uint32_t* okbits = chg + 3 * MAX_KW; // [MAX_KW]
  uint16_t* lst = (uint16_t*)(okbits + MAX_KW);  // [WARPS, K] prefiltered pairs
  uint8_t* ok = (uint8_t*)(lst + WARPS * K);
  uint8_t* nok = ok + K;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  uint16_t* mylst = lst + warp * K;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  long long* trace = rank == 0 ? w.trace : nullptr;
  __shared__ int arrived, next_row[2];  // trace arrivals; the links' and suppression's next row
  if (t == 0) {
    arrived = 0;
    next_row[0] = next_row[1] = 0;
  }
#ifdef SSPL_LSD_TRACE
  if (trace && t == 0) trace[0] = clock64();
  __syncthreads();
#endif

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
  for (int q = t; q < 3 * MAX_KW; q += THREADS) chg[q] = q < MAX_KW ? FULL : 0u;
  trace_arrive(trace, 1, &arrived);
  cluster.sync();  // every block of the cluster runs before any writes to another's rows

  // the base relation: a warp per row i, the prefiltered j listed, the
  // exact test on the list
  for (int wd = warp; wd < KW; wd += WARPS) {
    const int j = wd * 32 + lane;
    const unsigned m = __ballot_sync(FULL, j < K && ok[j]);
    if (lane == 0) okbits[wd] = m;
  }
  // block `rank` of the cluster owns rows rank, rank + CLUSTER, ..., taken
  // by its warps one at a time (their lists differ in length), and writes
  // each finished row into every block's copy of the matrix
  for (;;) {
    const int i = rank + CLUSTER * __shfl_sync(FULL, lane == 0 ? atomicAdd(&next_row[0], 1) : 0,
                                               0);
    if (i >= KP) break;
    if (lane < KW) Bm[i * KW + lane] = 0u;
    if (i < K && ok[i]) {
      const float sdi = sd[i], nx = -dym[i], ny = dxm[i], mxi = mxm[i], myi = mym[i];
      const float dxi = dxm[i], dyi = dym[i];
      const float half = 0.5f * tl[i];
      int n = 0;
      for (int wd = 0; wd < KW; ++wd) {
        const int j = wd * 32 + lane;
        const bool c = j < K && ok[j] && near_dir(sdi, sd[j], 0.100000001490116119f);
        const unsigned m = __ballot_sync(FULL, c);
        if (c) mylst[n + __popc(m & lt)] = (uint16_t)j;
        n += __popc(m);
      }
      __syncwarp();
      for (int r = lane; r < n; r += 32) {  // the gates in any order: the cheap ones first
        const int j = mylst[r];
        const float ps = fabsf(nx * (sx[j] - mxi) + ny * (sy[j] - myi));
        const float pe = fabsf(nx * (ex[j] - mxi) + ny * (ey[j] - myi));
        if (!(fmaxf(ps, pe) < 2.5f)) continue;
        if (!(angle_diff(sdi, sd[j]) < 0.100000001490116119f)) continue;
        const float ts = dxi * (sx[j] - mxi) + dyi * (sy[j] - myi);
        const float te = dxi * (ex[j] - mxi) + dyi * (ey[j] - myi);
        const float lo = fminf(ts, te), hi = fmaxf(ts, te);
        if (fmaxf(lo - half, -half - hi) < 5.0f)
          atomicOr(&Bm[i * KW + (j >> 5)], 1u << (j & 31));
      }
    }
    __syncwarp();
    if (lane < KW) {
      const uint32_t word = Bm[i * KW + lane];
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r)
        cluster.map_shared_rank(Bm, (rank + r) % CLUSTER)[i * KW + lane] = word;
    }
  }
  trace_arrive(trace, 2, &arrived);
  cluster.sync();
  // link = base | base^T | eye. Word I of row r of base^T holds bit r of
  // base's rows 32 I .. 32 I + 31: a warp per (row block R, word I), lane
  // r's row 32 R + r, the 32 rows' word R read by broadcast
  for (int q = warp; q < KW * KW; q += WARPS) {
    const int R = q / KW, I = q - R * KW, row = R * 32 + lane;
    uint32_t bits = 0;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) bits |= ((Bm[(I * 32 + b) * KW + R] >> lane) & 1u) << b;
    if (row < K) {
      bits |= Bm[row * KW + I];
      if (I == R) bits |= 1u << lane;
    } else {
      bits = 0u;
    }
    A[row * KW + I] = bits;
  }
  phase_end(trace, 3, &arrived);
  trace_popcounts(trace, A, K, KW, 0);

  // four squarings of the boolean matrix, a thread per (row i, word wd):
  // the OR of word wd of the rows whose bit is set in row i; first a
  // thread per row flags the rows holding a row the last squaring changed
  // (nok is free until the extents)
  uint32_t* cur = A;
  uint32_t* nxt = Bm;
  uint8_t* dirty_row = nok;
  int it = 0;
  for (; it < 4; ++it) {
    const uint32_t* ch = chg + (it % 3) * MAX_KW;      // changed by the last squaring
    uint32_t* chn = chg + ((it + 1) % 3) * MAX_KW;     // changed by this one (zero)
    if (t < MAX_KW) chg[((it + 2) % 3) * MAX_KW + t] = 0u;  // the next one's
    if (it > 0) {
      for (int i = t; i < K; i += THREADS) {
        uint32_t any = 0u;
        for (int kw = 0; kw < KW; ++kw) any |= cur[i * KW + kw] & ch[kw];
        dirty_row[i] = any != 0u;
      }
      __syncthreads();
    }
    bool changed = false;
    for (int q = t; q < K * KW; q += THREADS) {
      const int i = q / KW, wd = q - i * KW;
      const uint32_t* ri = cur + i * KW;
      const bool dirty = it == 0 || dirty_row[i];
      const uint32_t own = ri[wd];
      uint32_t acc = own;
      if (dirty) {
        acc = 0u;
        for (int kw = 0; kw < KW; ++kw) {
          uint32_t m = ri[kw];
          while (m) {
            const int b = __ffs(m) - 1;
            m &= m - 1;
            acc |= cur[(kw * 32 + b) * KW + wd];
          }
        }
      }
      nxt[q] = acc;
      if (acc != own) {
        atomicOr(&chn[i >> 5], 1u << (i & 31));
        changed = true;
      }
#ifdef SSPL_LSD_TRACE
      if (trace && dirty && wd == 0)
        atomicAdd((unsigned long long*)&trace[TRACE_WALKED + it], 1ull);
#endif
    }
    trace_arrive(trace, 4 + it, &arrived);
    const int more = __syncthreads_or(changed);
    trace_popcounts(trace, nxt, K, KW, it + 1);
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (!more) break;  // a fixed point: the remaining squarings change nothing
  }
#ifdef SSPL_LSD_TRACE
  if (trace && t == 0) trace[TRACE_SQUARINGS] = it < 4 ? it + 1 : 4;
  for (int s = it + 1; s < 4; ++s) {
    __syncthreads();
    trace_popcounts(trace, cur, K, KW, s + 1);
    if (trace && t == 0) trace[4 + s] = trace[4 + it];
  }
#endif
  __syncthreads();

  // a thread per row: the component's representative (first argmax of
  // the members' responses, -1 elsewhere: the first non-member against
  // the best member) and its extents along its own direction, then the
  // row's merged segment, angle and midpoint
  for (int i = t; i < K; i += THREADS) {
    const float mxi = mxm[i], myi = mym[i], dxi = dxm[i], dyi = dym[i];
    const uint32_t* row = cur + i * KW;
    float bv = 0.0f, lo = pos_inf(), hi = neg_inf();
    int bi = INT32_MAX, jn = INT32_MAX;
    for (int kw = 0; kw < KW; ++kw) {
      uint32_t m = row[kw] & okbits[kw];
      const uint32_t inside = kw * 32 + 32 <= K ? FULL : (1u << (K - kw * 32)) - 1u;
      const uint32_t z = ~m & inside;
      if (z && jn == INT32_MAX) jn = kw * 32 + __ffs(z) - 1;
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const int j = kw * 32 + b;
        const float v = resp[j];
        if (bi == INT32_MAX || v > bv) {
          bv = v;
          bi = j;
        }
        const float ts = dxi * (sx[j] - mxi) + dyi * (sy[j] - myi);
        const float te = dxi * (ex[j] - mxi) + dyi * (ey[j] - myi);
        lo = fminf(lo, fminf(ts, te));
        hi = fmaxf(hi, fmaxf(ts, te));
      }
    }
    if (jn != INT32_MAX && (bi == INT32_MAX || -1.0f > bv || (-1.0f == bv && jn < bi))) bi = jn;
    const bool rep = bi == i && ok[i];
    float a = sx[i], b = sy[i], c = ex[i], d = ey[i], len = tl[i], r = resp[i];
    if (rep) {
      a = mxi + dxi * lo;
      b = myi + dyi * lo;
      c = mxi + dxi * hi;
      d = myi + dyi * hi;
      len = hi - lo;
      r = len * mm[i];
    }
    nok[i] = rep;
    nsx[i] = a;
    nsy[i] = b;
    nex[i] = c;
    ney[i] = d;
    ntl[i] = len;
    nresp[i] = r;
    const float ang = jmod(atan2_glibc(d - b, c - a) + HALF_PI, PI) - HALF_PI;
    sang[i] = ang;
    mx[i] = 0.5f * (a + c);
    my[i] = 0.5f * (b + d);
    ca[i] = cosf(ang);
    sa[i] = sinf(ang);
  }
  phase_end(trace, 8, &arrived);

  // the pairwise suppression of collinear duplicates, then the keys, into
  // block 0's sel: block `rank` owns candidates rank, rank + CLUSTER, ...,
  // a warp per candidate j (taken one at a time), the stronger
  // representatives i in a similar direction listed by ballot, the exact
  // gates on the list (the cheap ones first), ended at the first
  // suppressor by __any_sync
  float* sel0 = cluster.map_shared_rank(sel, 0);
  for (;;) {
    const int j = rank + CLUSTER * __shfl_sync(FULL, lane == 0 ? atomicAdd(&next_row[1], 1) : 0,
                                               0);
    if (j >= K) break;
    bool keep = nok[j];
    if (keep) {
      const float rj = nresp[j], aj = sang[j], mxj = mx[j], myj = my[j];
      const float sxj = nsx[j], syj = nsy[j], exj = nex[j], eyj = ney[j];
      int n = 0;
      for (int b0 = 0; b0 < K; b0 += 32) {
        const int i = b0 + lane;
        const bool c = i < K && nok[i] && (nresp[i] > rj || (nresp[i] == rj && i < j)) &&
                       near_dir(sang[i], aj, w.angle_tol);
        const unsigned m = __ballot_sync(FULL, c);
        if (c) mylst[n + __popc(m & lt)] = (uint16_t)i;
        n += __popc(m);
      }
      __syncwarp();
      for (int r0 = 0; r0 < n; r0 += 32) {
        bool sup = false;
        if (r0 + lane < n) {
          const int i = mylst[r0 + lane];
          const float dmid = fabsf(-sa[i] * (mxj - mx[i]) + ca[i] * (myj - my[i]));
          if (dmid < 3.0f && angle_diff(sang[i], aj) < w.angle_tol) {
            const float ts = ca[i] * (sxj - mx[i]) + sa[i] * (syj - my[i]);
            const float te = ca[i] * (exj - mx[i]) + sa[i] * (eyj - my[i]);
            const float half = 0.5f * ntl[i];
            const float ov = fminf(fmaxf(ts, te), half) - fmaxf(fminf(ts, te), -half);
            sup = ov > -4.0f;
          }
        }
        if (__any_sync(FULL, sup)) {
          keep = false;
          break;
        }
      }
      __syncwarp();
    }
    if (lane == 0) sel0[j] = keep ? nresp[j] : neg_inf();
  }
  trace_arrive(trace, 9, &arrived);
  cluster.sync();  // block 0 holds every key; the others are done
  if (rank != 0) return;
  rank_top(sel, K, L, top);
  phase_end(trace, 10, &arrived);
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
  trace_arrive(trace, 11, &arrived);
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
    len[k] = (isinf(x) || isinf(y)) ? pos_inf() : (hi == 0.0f ? hi : hi * sqrtf(1.0f + q * q));
    ca[k] = cosf(a);
    sa[k] = sinf(a);
  }
  __syncthreads();
  // an octave-1 line (j) duplicating an octave-0 line (i) is dropped: T
  // threads per candidate over the octave-0 lines, as lsd_merge's
  // suppression
  {
    const int T = parts_for(N), j = t / T, part = t & (T - 1);
    bool dup = false;
    if (j >= L && j < N && valid[j]) {
      for (int i = part; i < L && !dup; i += T) {
        if (!valid[i] || !(angle_diff(ang[i], ang[j]) < w.angle_tol)) continue;
        const float dmid = fabsf(-sa[i] * (mx[j] - mx[i]) + ca[i] * (my[j] - my[i]));
        if (!(dmid < 4.0f)) continue;
        const float ts = ca[i] * (sx[j] - mx[i]) + sa[i] * (sy[j] - my[i]);
        const float te = ca[i] * (ex[j] - mx[i]) + sa[i] * (ey[j] - my[i]);
        const float half = 0.5f * len[i];
        const float ov = fminf(fmaxf(ts, te), half) - fmaxf(fminf(ts, te), -half);
        dup = ov > 0.0f;
      }
    }
    for (int off = 1; off < T; off <<= 1) dup |= __shfl_xor_sync(FULL, dup, off);
    if (j < N && part == 0) sel[j] = valid[j] && !dup ? resp[j] : neg_inf();
  }
  __syncthreads();
  rank_top(sel, N, L, top);
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
  const int KW = (w.K + 31) / 32, KP = KW * 32;
  const size_t smem = (size_t)w.K * (24 * 4 + 4) + (size_t)2 * KP * KW * 4 +
                      (size_t)4 * MAX_KW * 4 + (size_t)WARPS * w.K * 2 + (size_t)2 * w.K;
  cudaError_t e = cudaFuncSetAttribute(merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // one cluster of CLUSTER blocks on neighbouring SMs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, merge_kernel, w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int sspl_lsd_octave_merge(const void* work, void* stream) {
  const Work w = *(const Work*)work;
  if (w.L < 1 || 2 * w.L > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * w.L * (12 * 4 + 4 + 1);
  return run((const void*)octave_kernel, smem, w, (cudaStream_t)stream);
}
