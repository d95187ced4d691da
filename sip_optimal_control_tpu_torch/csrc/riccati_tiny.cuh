// Entry-unrolled tiny-matrix algebra for the chain-Riccati kernels.
//
// Counterparts of the helpers in sip_optimal_control_tpu/ops/pallas_riccati.py
// (_chol, _tri_solve_mat, _cho_solve_mat, _matvec, _tri_solve_vec,
// _cho_solve_vec: lines 62-119 and 462-491).  On the TPU every scalar of a
// matrix is an [8, 128] tile of scenarios; here one thread owns one scenario
// and every scalar is a register.  All sizes are template constants, so the
// loops unroll fully and the arrays stay in registers.
#pragma once

namespace riccati {

// Lower Cholesky (Cholesky-Banachiewicz), same operation order as _chol.
// A non-positive pivot gives NaN (sqrtf of a negative), which the caller
// detects from the diagonal.
template <int N>
__device__ __forceinline__ void chol(const float (&a)[N][N], float (&l)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    const float d = sqrtf(s);
    l[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * inv_d;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) l[i][j] = 0.0f;
  }
}

// Solve L X = B (TRANSPOSE false) or L^T X = B (true), column by column.
template <int N, int C, bool TRANSPOSE>
__device__ __forceinline__ void tri_solve_mat(const float (&l)[N][N],
                                              const float (&b)[N][C],
                                              float (&x)[N][C]) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int step = 0; step < N; ++step) {
      const int i = TRANSPOSE ? N - 1 - step : step;
      float s = b[i][j];
      if (TRANSPOSE) {
#pragma unroll
        for (int k = i + 1; k < N; ++k) s -= l[k][i] * x[k][j];
      } else {
#pragma unroll
        for (int k = 0; k < i; ++k) s -= l[i][k] * x[k][j];
      }
      x[i][j] = s / l[i][i];
    }
  }
}

template <int N, int C>
__device__ __forceinline__ void cho_solve_mat(const float (&l)[N][N],
                                              const float (&b)[N][C],
                                              float (&x)[N][C]) {
  float t[N][C];
  tri_solve_mat<N, C, false>(l, b, t);
  tri_solve_mat<N, C, true>(l, t, x);
}

template <int N, bool TRANSPOSE>
__device__ __forceinline__ void tri_solve_vec(const float (&l)[N][N],
                                              const float (&b)[N],
                                              float (&x)[N]) {
#pragma unroll
  for (int step = 0; step < N; ++step) {
    const int i = TRANSPOSE ? N - 1 - step : step;
    float s = b[i];
    if (TRANSPOSE) {
#pragma unroll
      for (int k = i + 1; k < N; ++k) s -= l[k][i] * x[k];
    } else {
#pragma unroll
      for (int k = 0; k < i; ++k) s -= l[i][k] * x[k];
    }
    x[i] = s / l[i][i];
  }
}

template <int N>
__device__ __forceinline__ void cho_solve_vec(const float (&l)[N][N],
                                              const float (&b)[N],
                                              float (&x)[N]) {
  float t[N];
  tri_solve_vec<N, false>(l, b, t);
  tri_solve_vec<N, true>(l, t, x);
}

// Structure-of-arrays access: stage s, entry r of a [S, rows, B] tensor,
// scenario b.  Neighbouring threads read neighbouring addresses.
__device__ __forceinline__ size_t soa(int s, int r, int rows, int b, int B) {
  return (static_cast<size_t>(s) * rows + r) * B + b;
}

template <int R, int C>
__device__ __forceinline__ void load_mat(const float* __restrict__ p, int s,
                                         int b, int B, float (&out)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) out[i][j] = p[soa(s, i * C + j, R * C, b, B)];
}

template <int R, int C>
__device__ __forceinline__ void store_mat(float* __restrict__ p, int s, int b,
                                          int B, const float (&in)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) p[soa(s, i * C + j, R * C, b, B)] = in[i][j];
}

template <int D>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, int s,
                                         int b, int B, float (&out)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) out[i] = p[soa(s, i, D, b, B)];
}

template <int D>
__device__ __forceinline__ void store_vec(float* __restrict__ p, int s, int b,
                                          int B, const float (&in)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) p[soa(s, i, D, b, B)] = in[i];
}

// cho_solve_vec with the diagonal's reciprocals taken first, off
// the dependent chain, and multiplied (a zero or NaN pivot still gives a
// non-finite solution).
template <int N>
__device__ __forceinline__ void cho_solve_rcp(const float (&l)[N][N],
                                              const float (&b)[N],
                                              float (&x)[N]) {
  float inv[N], t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) inv[i] = 1.0f / l[i][i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * t[k];
    t[i] = s * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = t[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= l[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// Per-row delta scalings with delta <= 0 replaced by 1, as the TPU kernels
// do (the INVALID_DELTA status is computed outside the kernel).
template <int N>
__device__ __forceinline__ void delta_scalings(const float (&delta)[N],
                                               float (&sd)[N], float (&sdi)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float safe = delta[i] > 0.0f ? delta[i] : 1.0f;
    sd[i] = sqrtf(safe);
    sdi[i] = 1.0f / sd[i];
  }
}

}  // namespace riccati
