// Kernel 8: glibc's atan2f, elementwise, for the line path's glue.
//
// Replaces the JAX package's jnp.arctan2 calls outside the line kernels:
// the segment directions of the fragment merges and the suppression
// (structure_slam_pointline_tpu/ops/lsd.py:448, :494), the line gates of
// tracking (models/tracking.py:274-275) and of the projection fuse
// (models/local_mapping.py:926-931). XLA:CPU lowers jnp.arctan2 to glibc's
// atan2f; the port reproduces it bit for bit (lines.cuh, and
// utils/fmath.atan2_plain in torch ops). As torch ops that is ~100
// elementwise launches per call, six calls a frame; here it is one.
//
// Bound on the card: neither. A call holds at most a few hundred elements
// (8 B in, 4 B out and ~60 operations each), well under a microsecond of
// either, so the launch sets the time.

#include "lines.cuh"

namespace {

__global__ void atan2_kernel(const float* __restrict__ y, const float* __restrict__ x, int n,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = lines::atan2_glibc(y[i], x[i]);
}

}  // namespace

extern "C" int sspl_atan2_glibc(const void* y, const void* x, int n, void* out, void* stream) {
  const int threads = 256;
  atan2_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)x, n, (float*)out);
  return (int)cudaGetLastError();
}
