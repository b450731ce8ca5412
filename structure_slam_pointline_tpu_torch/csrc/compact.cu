// Kernel 19: pool compaction, three launches per pass.
//
// Replaces the JAX package's structure_slam_pointline_tpu/world/compact.py
// `compact_points` (:33), `compact_lines` (:72) and `compact_keyframes`
// (:106): `jnp.nonzero(valid, size=N, fill_value=-1)` for the new -> old
// table, an old -> new scatter, one gather + `where` per pool field, the
// edge grid or the landmark stamps rewritten through a table, and for
// keyframes `clip(cumsum(valid) - 1, 0, K - 1)` as the stamp table.
//
// compact_scan: one block of 1024 threads. Thread t counts the valid slots
// of its contiguous chunk of ceil(N / 1024) ids, a two-level warp-shuffle
// scan gives each chunk its exclusive prefix, and the thread walks its
// chunk again in id order writing perm[rank] = id, old2new[id] = rank (or
// -1), and for keyframes stamp_map[id] = clip(inclusive count - 1, 0,
// N - 1). Positions are ranks, never atomics, so survivors keep their id
// order exactly as nonzero's. perm is -1 past the live count, which goes
// to n_live[0] on the device (the caller reads it once per pass).
//
// compact_gather: one launch per pool over a table of up to 16 fields
// passed by value as a __grid_constant__ parameter (source, destination,
// row bytes, copy unit, a 64-byte fill pattern: a dead row's byte b is
// pattern[b % 64], so kf_T_cw's identity is one 64-byte row and -1 / 1e9
// fills are a repeated word).
// blockIdx.y picks the field; the threads stride over the destination's
// units (16 bytes where the row and both pointers allow it, else 8, 4 or
// 1): unit c of new row r copies unit c of old row perm[r], or the fill.
//
// compact_remap: out[i] = a[i] < 0 ? a[i] : table[a[i]] over up to four
// int32 arrays (blockIdx.y), a value past the table becoming -1, or with
// `clip` the table's last entry (the reference clips stamps to K - 1).
// The points / lines passes remap the [K, F] / [K, LF] edge grid through
// old2new, the keyframe pass the four landmark stamp arrays through
// stamp_map. The keyframe pass then rebuilds mp_obs_bits with kernel 9.
//
// Every output element is a copy or a table entry, so the kernel is
// bit-equal to its plain version. Bound on the card: bytes, the live rows
// of each pool field read and every row written (a dead row is a fill,
// read from no field), plus the edge grid or the stamps read and written
// and, for keyframes, the observer bits written; at the default pools and
// few live rows about 17 MB for the keyframe pass (~59 KB a kf_* row) and
// 10.5 MB for the points pass. The scan reads N bytes in one block, a few
// microseconds of latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;
constexpr int kPat = 64;
constexpr int kMaxRemap = 4;
constexpr int kScanThreads = 1024;

struct Field {
  const char* src;
  char* dst;
  long long row_bytes;
  int unit;
  unsigned char pat[kPat];
};

struct FieldTable {
  Field f[kMaxFields];
};

struct RemapTable {
  const int32_t* src[kMaxRemap];
  int32_t* dst[kMaxRemap];
  long long n[kMaxRemap];
};

__global__ void scan_kernel(const bool* __restrict__ valid, int N, int32_t* __restrict__ perm,
                            int32_t* __restrict__ old2new, int32_t* __restrict__ stamp_map,
                            int32_t* __restrict__ n_live) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x;
  const int chunk = (N + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * chunk, N), hi = min(lo + chunk, N);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += valid[i] ? 1 : 0;
  const int lane = t & 31, w = t >> 5;
  int x = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int total = warp_sums[kScanThreads / 32 - 1];
  int r = x - c + (w > 0 ? warp_sums[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    if (valid[i]) {
      perm[r] = i;
      old2new[i] = r;
      ++r;
    } else {
      old2new[i] = -1;
    }
    if (stamp_map != nullptr) stamp_map[i] = min(max(r - 1, 0), N - 1);
  }
  for (int i = max(lo, total); i < hi; ++i) perm[i] = -1;
  if (t == 0) n_live[0] = total;
}

__global__ void gather_kernel(const int32_t* __restrict__ perm, int N,
                              const __grid_constant__ FieldTable tab) {
  __shared__ __align__(16) unsigned char pat[kPat];
  const Field& f = tab.f[blockIdx.y];
  if (threadIdx.x < kPat) pat[threadIdx.x] = f.pat[threadIdx.x];
  __syncthreads();
  const int u = f.unit;
  const long long upr = f.row_bytes / u;
  const long long total = (long long)N * upr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < total; j += stride) {
    const long long r = j / upr, c = j - r * upr;
    const int p = perm[r];
    const char* s = p >= 0 ? f.src + (long long)p * f.row_bytes + c * u
                           : (const char*)pat + ((c * u) % kPat);
    char* d = f.dst + r * f.row_bytes + c * u;
    if (u == 16) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else if (u == 8) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    } else if (u == 4) {
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    } else {
      *d = *s;
    }
  }
}

__global__ void remap_kernel(const __grid_constant__ RemapTable tab,
                             const int32_t* __restrict__ table, int table_len, int clip) {
  const int a = blockIdx.y;
  const int32_t* src = tab.src[a];
  int32_t* dst = tab.dst[a];
  const long long n = tab.n[a];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = src[i];
    int o = v;
    if (v >= 0) o = v < table_len ? table[v] : (clip ? table[table_len - 1] : -1);
    dst[i] = o;
  }
}

int grid_for(long long units) {
  const long long blocks = (units + 255) / 256;
  return (int)(blocks < 1 ? 1 : (blocks > 2048 ? 2048 : blocks));
}

}  // namespace

extern "C" int sspl_compact_scan(const void* valid, int N, void* perm, void* old2new,
                                 void* stamp_map, void* n_live, void* stream) {
  scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const bool*)valid, N, (int32_t*)perm, (int32_t*)old2new, (int32_t*)stamp_map,
      (int32_t*)n_live);
  return (int)cudaGetLastError();
}

// srcs / dsts / row_bytes / units / pats are host arrays of n_fields entries
// (pats: 64 bytes per field); they are copied into the launch's parameters.
extern "C" int sspl_compact_gather(const void* perm, int N, int n_fields,
                                   const void* const* srcs, void* const* dsts,
                                   const long long* row_bytes, const int* units,
                                   const unsigned char* pats, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return (int)cudaErrorInvalidValue;
  FieldTable tab = {};
  long long most = 1;
  for (int k = 0; k < n_fields; ++k) {
    Field& f = tab.f[k];
    f.src = (const char*)srcs[k];
    f.dst = (char*)dsts[k];
    f.row_bytes = row_bytes[k];
    f.unit = units[k];
    if ((f.unit != 1 && f.unit != 4 && f.unit != 8 && f.unit != 16) || f.row_bytes % f.unit != 0)
      return (int)cudaErrorInvalidValue;
    for (int b = 0; b < kPat; ++b) f.pat[b] = pats[k * kPat + b];
    const long long units_k = (long long)N * (f.row_bytes / f.unit);
    if (units_k > most) most = units_k;
  }
  dim3 grid(grid_for(most), n_fields);
  gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const int32_t*)perm, N, tab);
  return (int)cudaGetLastError();
}

extern "C" int sspl_compact_remap(int n_arrays, const void* const* srcs, void* const* dsts,
                                  const long long* ns, const void* table, int table_len, int clip,
                                  void* stream) {
  if (n_arrays < 1 || n_arrays > kMaxRemap || table_len < 1) return (int)cudaErrorInvalidValue;
  RemapTable tab = {};
  long long most = 1;
  for (int a = 0; a < n_arrays; ++a) {
    tab.src[a] = (const int32_t*)srcs[a];
    tab.dst[a] = (int32_t*)dsts[a];
    tab.n[a] = ns[a];
    if (ns[a] > most) most = ns[a];
  }
  dim3 grid(grid_for(most), n_arrays);
  remap_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(tab, (const int32_t*)table, table_len,
                                                       clip);
  return (int)cudaGetLastError();
}
