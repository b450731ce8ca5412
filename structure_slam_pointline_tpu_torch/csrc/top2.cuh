// The masked best / second-best rule of kernel 3 (csrc/hamming.cu), shared
// by the kernels that match descriptors inside their own windows (kernel
// 22, csrc/fuse_match.cu).
//
// Each lane folds its columns' (value, column) pairs into a top-2 list,
// then a shuffle tree merges the warp's 32 lists. Comparing (value, index)
// pairs everywhere keeps jnp.argmin's first-index rule. `finish` applies
// the reference's re-mask: the best column's value plus 2^20 competes with
// the runner-up for second place, which covers rows with fewer than two
// columns.

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace top2 {

constexpr int BIG = 1 << 20;  // a masked distance

struct Top2 {
  int v0, j0, v1, j1;
};

__device__ __forceinline__ Top2 empty() { return Top2{INT_MAX, INT_MAX, INT_MAX, INT_MAX}; }

__device__ __forceinline__ bool less(int va, int ja, int vb, int jb) {
  return va < vb || (va == vb && ja < jb);
}

__device__ __forceinline__ void push(Top2& t, int v, int j) {
  if (less(v, j, t.v0, t.j0)) {
    t.v1 = t.v0; t.j1 = t.j0; t.v0 = v; t.j0 = j;
  } else if (less(v, j, t.v1, t.j1)) {
    t.v1 = v; t.j1 = j;
  }
}

// merge the lists of a full warp; every lane ends with the warp's list
__device__ __forceinline__ void warp_merge(Top2& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    int v0 = __shfl_xor_sync(0xffffffffu, t.v0, off);
    int j0 = __shfl_xor_sync(0xffffffffu, t.j0, off);
    int v1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
    int j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
    push(t, v0, j0);
    push(t, v1, j1);
  }
}

// (second, second_j) after the best column is re-masked by adding 2^20
__device__ __forceinline__ void finish(const Top2& t, int& second, int& second_j) {
  second = t.v1;
  second_j = t.j1;
  const int rv = t.v0 + BIG;
  if (less(rv, t.j0, second, second_j)) {
    second = rv;
    second_j = t.j0;
  }
}

}  // namespace top2
