// Sim(3) maps for kernels 17 and 18, templated on the scalar type.
//
// The reference's structure_slam_pointline_tpu/utils/lie.py:189-297
// (sim3_exp, sim3_log, sim3_inverse and their SO(3) parts, :43-118), op
// for op, with the same Taylor branches, thresholds and "safe"
// denominators. A Sim(3) element is held as its top 3x4 block, row-major
// (sR | t); the last row is the constant (0, 0, 0, 1).
//
// `T` is float or `Dual`, a float with one forward-mode tangent. With Dual
// the functions compute a directional derivative, which is what jax.jacfwd
// evaluates one tangent lane at a time: branches are chosen on the primal
// values (jnp.where selects whole tangents the same way), and a clamp
// passes its tangent where the primal lies inside the bounds or on one
// (torch.clamp's convention; the reference's differs only on the bound
// itself, where the tangent is multiplied by an exact zero in so3_log).

#pragma once

#include <math.h>

struct Dual {
  float v, d;
  __device__ Dual() : v(0.f), d(0.f) {}
  __device__ Dual(float x) : v(x), d(0.f) {}
  __device__ Dual(float x, float dx) : v(x), d(dx) {}
};

__device__ inline Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ inline Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ inline Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ inline Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ inline Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - b.d * q) / b.v);
}
__device__ inline Dual operator+(Dual a, float b) { return Dual(a.v + b, a.d); }
__device__ inline Dual operator+(float a, Dual b) { return Dual(a + b.v, b.d); }
__device__ inline Dual operator-(Dual a, float b) { return Dual(a.v - b, a.d); }
__device__ inline Dual operator-(float a, Dual b) { return Dual(a - b.v, -b.d); }
__device__ inline Dual operator*(Dual a, float b) { return Dual(a.v * b, a.d * b); }
__device__ inline Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.d); }
__device__ inline Dual operator/(Dual a, float b) { return Dual(a.v / b, a.d / b); }
__device__ inline Dual operator/(float a, Dual b) { return Dual(a) / b; }

__device__ inline float val(float x) { return x; }
__device__ inline float val(Dual x) { return x.v; }

__device__ inline float d_sqrt(float x) { return sqrtf(x); }
__device__ inline Dual d_sqrt(Dual x) {
  const float r = sqrtf(x.v);
  return Dual(r, x.d / (2.f * r));
}
__device__ inline float d_sin(float x) { return sinf(x); }
__device__ inline Dual d_sin(Dual x) { return Dual(sinf(x.v), x.d * cosf(x.v)); }
__device__ inline float d_cos(float x) { return cosf(x); }
__device__ inline Dual d_cos(Dual x) { return Dual(cosf(x.v), -(x.d * sinf(x.v))); }
__device__ inline float d_exp(float x) { return expf(x); }
__device__ inline Dual d_exp(Dual x) {
  const float r = expf(x.v);
  return Dual(r, x.d * r);
}
__device__ inline float d_log(float x) { return logf(x); }
__device__ inline Dual d_log(Dual x) { return Dual(logf(x.v), x.d / x.v); }
__device__ inline float d_acos(float x) { return acosf(x); }
__device__ inline Dual d_acos(Dual x) {
  return Dual(acosf(x.v), -(x.d / sqrtf(1.f - x.v * x.v)));
}
__device__ inline float d_sign(float x) { return (float)((x > 0.f) - (x < 0.f)); }
__device__ inline Dual d_sign(Dual x) { return Dual(d_sign(x.v)); }

// clamp with the tangent passed inside the closed bounds
template <typename T>
__device__ inline T d_clamp(T x, float lo, float hi) {
  if (val(x) < lo) return T(lo);
  if (val(x) > hi) return T(hi);
  return x;
}
template <typename T>
__device__ inline T d_max(T x, float lo) {
  return val(x) < lo ? T(lo) : x;
}

namespace sim3 {

constexpr float kEps = 1e-8f;
constexpr float kSmallTheta2 = 1e-4f;

// (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) of theta2 = t^2
template <typename T>
__device__ inline void sinc_factors(T theta2, T& A, T& B, T& C) {
  const bool small = val(theta2) < kSmallTheta2;
  if (small) {
    A = 1.f - theta2 / 6.f;
    B = 0.5f - theta2 / 24.f;
    C = (float)(1.0 / 6.0) - theta2 / 120.f;
  } else {
    const T t2 = d_max(theta2, kSmallTheta2);
    const T th = d_sqrt(t2);
    A = d_sin(th) / th;
    B = (1.f - d_cos(th)) / t2;
    C = (th - d_sin(th)) / (t2 * th);
  }
}

template <typename T>
__device__ inline void hat(const T* w, T* W) {
  W[0] = T(0.f); W[1] = -w[2];    W[2] = w[1];
  W[3] = w[2];   W[4] = T(0.f);   W[5] = -w[0];
  W[6] = -w[1];  W[7] = w[0];     W[8] = T(0.f);
}

template <typename T>
__device__ inline void mul33(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ inline void so3_exp(const T* w, T* R) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T A, B, C;
  sinc_factors(theta2, A, B, C);
  T W[9], W2[9];
  hat(w, W);
  mul33(W, W, W2);
  for (int q = 0; q < 9; ++q) R[q] = ((q % 4 == 0) ? 1.f : 0.f) + A * W[q] + B * W2[q];
}

template <typename T>
__device__ inline void so3_log(const T* R, T* w) {
  const T trace = R[0] + R[4] + R[8];
  const T cos_t = d_clamp((trace - 1.f) * 0.5f, -1.f, 1.f);
  const float c = val(cos_t);
  const T wr[3] = {(R[7] - R[5]) * 0.5f, (R[2] - R[6]) * 0.5f, (R[3] - R[1]) * 0.5f};
  if (c < (float)(-1.0 + 1e-5)) {
    // near pi: the axis from the diagonal of (R + I) / 2, signs from the
    // symmetric part's row of the largest component
    const T theta = d_acos(d_clamp(cos_t, (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
    T axis2[3], axis[3];
    for (int i = 0; i < 3; ++i) {
      axis2[i] = d_max((R[4 * i] + 1.f) * 0.5f, 1e-12f);
      axis[i] = d_sqrt(axis2[i]);
    }
    int k = 0;
    for (int i = 1; i < 3; ++i)
      if (val(axis2[i]) > val(axis2[k])) k = i;
    T ap[3];
    const T ax_k = axis[k];
    const T den = val(ax_k) < kEps ? T(1.f) : ax_k;
    for (int j = 0; j < 3; ++j) {
      const T row = (R[3 * k + j] + R[3 * j + k]) * 0.5f;
      const T sgn = row / den;
      ap[j] = d_sign(fabsf(val(sgn)) < kEps ? T(1.f) : sgn) * axis[j];
    }
    T nrm = d_sqrt(ap[0] * ap[0] + ap[1] * ap[1] + ap[2] * ap[2]);
    if (val(nrm) < kEps) nrm = T(1.f);
    for (int j = 0; j < 3; ++j) w[j] = ap[j] / nrm * theta;
    return;
  }
  T scale;
  if (c > (float)(1.0 - 1e-4)) {
    const T omc = 1.f - cos_t;
    scale = 1.f + omc / 3.f + 7.f * omc * omc / 45.f;
  } else {
    const T th = d_acos(d_clamp(cos_t, (float)(-1.0 + 1e-6), (float)(1.0 - 1e-6)));
    scale = th / d_sin(th);
  }
  for (int j = 0; j < 3; ++j) w[j] = wr[j] * scale;
}

// W of the Sim(3) exponential (lie.py:221-271)
template <typename T>
__device__ inline void sim3_W(const T* w, T sigma, T* Wout) {
  const T theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T sigma2 = sigma * sigma;
  const T s = d_exp(sigma);
  const bool small_sig = fabsf(val(sigma)) < 1e-5f;
  const bool small_th = val(theta2) < kEps;
  T Cc, A, B;
  if (small_sig) {
    Cc = 1.f + sigma * 0.5f + sigma2 / 6.f;
    T A0, C0;
    sinc_factors(theta2, A0, A, C0);   // the SE(3) V coefficients (B, C)
    B = C0;
  } else {
    Cc = (s - 1.f) / sigma;
    if (small_th) {
      A = ((sigma - 1.f) * s + 1.f) / sigma2;
      B = ((0.5f * sigma2 - sigma + 1.f) * s - 1.f) / (sigma2 * sigma);
    } else {
      const T theta = d_sqrt(d_max(theta2, kEps * kEps));
      const T a = s * d_sin(theta);
      const T b = s * d_cos(theta);
      T c = theta2 + sigma2;
      if (val(c) < kEps) c = T(1.f);
      A = (a * sigma + (1.f - b) * theta) / (theta * c);
      B = (Cc - ((b - 1.f) * sigma + a * theta) / c) / theta2;
    }
  }
  T W[9], W2[9];
  hat(w, W);
  mul33(W, W, W2);
  for (int q = 0; q < 9; ++q)
    Wout[q] = Cc * ((q % 4 == 0) ? 1.f : 0.f) + A * W[q] + B * W2[q];
}

// exp: xi (omega, upsilon, sigma) -> S (3x4)
template <typename T>
__device__ inline void sim3_exp(const T* xi, T* S) {
  T R[9], W[9];
  so3_exp(xi, R);
  sim3_W(xi, xi[6], W);
  const T s = d_exp(xi[6]);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) S[4 * i + j] = s * R[3 * i + j];
    S[4 * i + 3] = W[3 * i] * xi[3] + W[3 * i + 1] * xi[4] + W[3 * i + 2] * xi[5];
  }
}

template <typename T>
__device__ inline T sim3_scale(const T* S) {
  return d_sqrt(S[0] * S[0] + S[1] * S[1] + S[2] * S[2]);
}

// C = A B of two 3x4 Sim(3) blocks (the implied last rows multiply out)
template <typename T>
__device__ inline void sim3_mul(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 4; ++j) {
      T acc = A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j] + A[4 * i + 2] * B[8 + j];
      if (j == 3) acc = acc + A[4 * i + 3];
      C[4 * i + j] = acc;
    }
  }
}

template <typename T>
__device__ inline void sim3_inverse(const T* S, T* Si) {
  const T s = sim3_scale(S);
  const T sinv = 1.f / s;
  T Rt[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rt[3 * i + j] = S[4 * j + i] / s;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) Si[4 * i + j] = sinv * Rt[3 * i + j];
    const T rt = Rt[3 * i] * S[3] + Rt[3 * i + 1] * S[7] + Rt[3 * i + 2] * S[11];
    Si[4 * i + 3] = -(sinv * rt);
  }
}

// x = A^-1 b for a 3x3 A (row-major), Gaussian elimination with partial
// pivoting (first row on ties), as LAPACK's getrf / getrs order it
template <typename T>
__device__ inline void solve3(T* A, T* b) {
  for (int c = 0; c < 3; ++c) {
    int p = c;
    for (int r = c + 1; r < 3; ++r)
      if (fabsf(val(A[3 * r + c])) > fabsf(val(A[3 * p + c]))) p = r;
    if (p != c) {
      for (int j = 0; j < 3; ++j) {
        const T tmp = A[3 * c + j];
        A[3 * c + j] = A[3 * p + j];
        A[3 * p + j] = tmp;
      }
      const T tb = b[c];
      b[c] = b[p];
      b[p] = tb;
    }
    for (int r = c + 1; r < 3; ++r) {
      const T f = A[3 * r + c] / A[3 * c + c];
      for (int j = c + 1; j < 3; ++j) A[3 * r + j] = A[3 * r + j] - f * A[3 * c + j];
      b[r] = b[r] - f * b[c];
    }
  }
  for (int r = 2; r >= 0; --r) {
    T acc = b[r];
    for (int j = r + 1; j < 3; ++j) acc = acc - A[3 * r + j] * b[j];
    b[r] = acc / A[3 * r + r];
  }
}

// log: S (3x4) -> xi (omega, upsilon, sigma)
template <typename T>
__device__ inline void sim3_log(const T* S, T* xi) {
  const T s = sim3_scale(S);
  T R[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[3 * i + j] = S[4 * i + j] / s;
  so3_log(R, xi);
  xi[6] = d_log(s);
  T W[9];
  sim3_W(xi, xi[6], W);
  T v[3] = {S[3], S[7], S[11]};
  solve3(W, v);
  xi[3] = v[0];
  xi[4] = v[1];
  xi[5] = v[2];
}

}  // namespace sim3
