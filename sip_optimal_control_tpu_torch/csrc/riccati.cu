// Chain-Riccati kernels for Hopper (sm_90a): factor, backward vector pass,
// forward rollout.
//
// Replaces the TPU kernels of sip_optimal_control_tpu/ops/pallas_riccati.py:
//   riccati_factor_f32     <- _factor_kernel     (explicit-W form, n < 8)
//   riccati_solve_bwd_f32  <- _solve_bwd_kernel
//   riccati_solve_fwd_f32  <- _solve_fwd_kernel
// and computes exactly what they compute (per-row delta with delta <= 0
// replaced by 1, W f through two triangular solves with F_chol).  The plain
// PyTorch twins live in ops/riccati_cuda.py.
//
// Design.  The TPU kernels put 1024 scenarios on the vector lanes of one
// block and walk the horizon as a sequential grid axis, carrying V (or v, x)
// in VMEM scratch.  Here one thread owns one scenario: the tiny n x n
// algebra is unrolled in registers (riccati_tiny.cuh) and the horizon loop
// runs inside the thread with the carry in registers.  Operands arrive in a
// structure-of-arrays layout [stage, entry, scenario] with the scenario
// index contiguous, so the 32 threads of a warp read 128 contiguous bytes
// per matrix entry.  A bounds check b < B takes the place of the TPU's
// padding to a multiple of 1024 with inert stages.  The kernels allocate
// nothing and launch on the caller's stream.
//
// What bounds them on an H100: at the main path's batch of 4096 scenarios
// there are only 32 blocks of 128 threads for 132 SMs, and each thread runs
// a dependent chain of T stages, so the kernels are latency-bound (each
// stage's bytes are read once; the FLOPs are tiny).  Making them fast is
// later work: several scenarios per warp with the matrix entries spread
// over lanes, cp.async prefetch of the next stage's operands, or keeping
// the SoA layout through the solver so the wrapper's transposes disappear.
#include <cuda_runtime.h>

#include "riccati_tiny.cuh"

namespace riccati {

constexpr int kThreads = 128;

// Backward factorization over edges e = T-1 .. 0, carrying V of the child
// node.  Inputs: Q [T+1, n*n], delta [T+1, n], A [T, n*n], Bm [T, n*m],
// Mm [T, n*m], R [T, m*m].  Outputs per edge: V of the parent node
// [T, n*n], W [T, n*n], K [T, m*n], G_chol [T, m*m].
template <int N, int M>
__global__ void __launch_bounds__(kThreads)
factor_kernel(int T, int B, const float* __restrict__ Q,
              const float* __restrict__ delta, const float* __restrict__ A,
              const float* __restrict__ Bm, const float* __restrict__ Mm,
              const float* __restrict__ R, float* __restrict__ v_out,
              float* __restrict__ w_out, float* __restrict__ k_out,
              float* __restrict__ g_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float V[N][N];
  load_mat<N, N>(Q, T, b, B, V);
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;  // edge e: parent node e, child node e + 1

    float dl[N], sd[N], sdi[N];
    load_vec<N>(delta, e + 1, b, B, dl);
    delta_scalings<N>(dl, sd, sdi);

    // F = I + sd V sd; W = sdi (I - F^{-1}) sdi   (reference: lqr.cpp:487-529)
    float F[N][N], Lf[N][N], eye[N][N], Finv[N][N], W[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        F[i][j] = sd[i] * V[i][j] * sd[j] + (i == j ? 1.0f : 0.0f);
        eye[i][j] = i == j ? 1.0f : 0.0f;
      }
    chol<N>(F, Lf);
    cho_solve_mat<N, N>(Lf, eye, Finv);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        W[i][j] = sdi[i] * ((i == j ? 1.0f : 0.0f) - Finv[i][j]) * sdi[j];

    // G = R + B^T W B; H = M^T + B^T W A; K = -G^{-1} H   (lqr.cpp:689-719)
    float a[N][N], bm[N][M], mm[N][M], r[M][M];
    load_mat<N, N>(A, e, b, B, a);
    load_mat<N, M>(Bm, e, b, B, bm);
    load_mat<N, M>(Mm, e, b, B, mm);
    load_mat<M, M>(R, e, b, B, r);

    float BtW[M][N];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = bm[0][i] * W[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) s += bm[k][i] * W[k][j];
        BtW[i][j] = s;
      }
    float G[M][M], Lg[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float s = BtW[i][0] * bm[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) s += BtW[i][k] * bm[k][j];
        G[i][j] = r[i][j] + s;
      }
    chol<M>(G, Lg);

    float WA[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = W[i][0] * a[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) s += W[i][k] * a[k][j];
        WA[i][j] = s;
      }
    float H[M][N];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = bm[0][i] * WA[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) s += bm[k][i] * WA[k][j];
        H[i][j] = mm[j][i] + s;
      }
    float Kneg[M][N], K[M][N];
    cho_solve_mat<M, N>(Lg, H, Kneg);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) K[i][j] = -Kneg[i][j];

    // V_parent = Q_parent + A^T W A + K^T H
    float Qp[N][N];
    load_mat<N, N>(Q, e, b, B, Qp);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float awa = a[0][i] * WA[0][j];
#pragma unroll
        for (int k = 1; k < N; ++k) awa += a[k][i] * WA[k][j];
        float kh = K[0][i] * H[0][j];
#pragma unroll
        for (int k = 1; k < M; ++k) kh += K[k][i] * H[k][j];
        V[i][j] = Qp[i][j] + (awa + kh);
      }

    store_mat<N, N>(v_out, e, b, B, V);
    store_mat<N, N>(w_out, e, b, B, W);
    store_mat<M, N>(k_out, e, b, B, K);
    store_mat<M, M>(g_out, e, b, B, Lg);
  }
}

// Backward vector pass over edges e = T-1 .. 0, carrying v of the child
// node (reference: lqr.cpp:746-795).  W f is formed from the child's
// F_chol: W f = sdi (fh - F^{-1} fh), fh = sdi f.  Inputs: q [T+1, n],
// r [T, m], c [T+1, n], delta [T+1, n], F_chol [T+1, n*n], G_chol [T, m*m],
// K [T, m*n], A [T, n*n], Bm [T, n*m].  Outputs: k [T, m], v of the parent
// node [T, n].
template <int N, int M>
__global__ void __launch_bounds__(kThreads)
solve_bwd_kernel(int T, int B, const float* __restrict__ q,
                 const float* __restrict__ r, const float* __restrict__ c,
                 const float* __restrict__ delta,
                 const float* __restrict__ fchol,
                 const float* __restrict__ gchol, const float* __restrict__ K,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ k_out, float* __restrict__ v_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float v[N];
  load_vec<N>(q, T, b, B, v);
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;
    float cc[N], dl[N], sd[N], sdi[N], Lf[N][N], Lg[M][M], kg[M][N];
    float a[N][N], bm[N][M], rr[M], qp[N];
    load_vec<N>(c, e + 1, b, B, cc);
    load_vec<N>(delta, e + 1, b, B, dl);
    load_mat<N, N>(fchol, e + 1, b, B, Lf);
    load_mat<M, M>(gchol, e, b, B, Lg);
    load_mat<M, N>(K, e, b, B, kg);
    load_mat<N, N>(A, e, b, B, a);
    load_mat<N, M>(Bm, e, b, B, bm);
    load_vec<M>(r, e, b, B, rr);
    load_vec<N>(q, e, b, B, qp);
    delta_scalings<N>(dl, sd, sdi);

    float fh[N], finv_fh[N], g[N];
#pragma unroll
    for (int i = 0; i < N; ++i) fh[i] = sdi[i] * (dl[i] * v[i] - cc[i]);
    cho_solve_vec<N>(Lf, fh, finv_fh);
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = v[i] - sdi[i] * (fh[i] - finv_fh[i]);

    float h[M], kneg[M], kv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = bm[0][i] * g[0];
#pragma unroll
      for (int k = 1; k < N; ++k) s += bm[k][i] * g[k];
      h[i] = rr[i] + s;
    }
    cho_solve_vec<M>(Lg, h, kneg);
#pragma unroll
    for (int i = 0; i < M; ++i) kv[i] = -kneg[i];

#pragma unroll
    for (int i = 0; i < N; ++i) {
      float atg = a[0][i] * g[0];
#pragma unroll
      for (int k = 1; k < N; ++k) atg += a[k][i] * g[k];
      float kth = kg[0][i] * h[0];
#pragma unroll
      for (int k = 1; k < M; ++k) kth += kg[k][i] * h[k];
      v[i] = qp[i] + atg + kth;
    }
    store_vec<M>(k_out, e, b, B, kv);
    store_vec<N>(v_out, e, b, B, v);
  }
}

// Forward rollout over edges e = 0 .. T-1, carrying x of the parent node
// (reference: lqr.cpp:821-870): u = k + K x, x_child = (I + delta V)^{-1}
// (A x + B u + c - delta v) through F_chol, y = v + V x_child.  Inputs:
// x_root [1, n], k [T, m], K [T, m*n], A [T, n*n], Bm [T, n*m], and the
// node-indexed c, delta, v [T+1, n], V, F_chol [T+1, n*n].  Outputs: u
// [T, m], x and y of the child node [T, n].
template <int N, int M>
__global__ void __launch_bounds__(kThreads)
solve_fwd_kernel(int T, int B, const float* __restrict__ x_root,
                 const float* __restrict__ k, const float* __restrict__ K,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ c, const float* __restrict__ delta,
                 const float* __restrict__ vv, const float* __restrict__ Vm,
                 const float* __restrict__ fchol, float* __restrict__ u_out,
                 float* __restrict__ x_out, float* __restrict__ y_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float x[N];
  load_vec<N>(x_root, 0, b, B, x);
  for (int e = 0; e < T; ++e) {
    float kv[M], kg[M][N], a[N][N], bm[N][M], cc[N], dl[N], vc[N];
    float Vc[N][N], Lf[N][N], sd[N], sdi[N];
    load_vec<M>(k, e, b, B, kv);
    load_mat<M, N>(K, e, b, B, kg);
    load_mat<N, N>(A, e, b, B, a);
    load_mat<N, M>(Bm, e, b, B, bm);
    load_vec<N>(c, e + 1, b, B, cc);
    load_vec<N>(delta, e + 1, b, B, dl);
    load_vec<N>(vv, e + 1, b, B, vc);
    load_mat<N, N>(Vm, e + 1, b, B, Vc);
    load_mat<N, N>(fchol, e + 1, b, B, Lf);

    float u[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = kg[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s += kg[i][j] * x[j];
      u[i] = kv[i] + s;
    }
    float rhs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float ax = a[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) ax += a[i][j] * x[j];
      float bu = bm[i][0] * u[0];
#pragma unroll
      for (int j = 1; j < M; ++j) bu += bm[i][j] * u[j];
      rhs[i] = cc[i] - dl[i] * vc[i] + ax + bu;
    }
    delta_scalings<N>(dl, sd, sdi);
    float scaled[N], xs[N], y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) scaled[i] = sdi[i] * rhs[i];
    cho_solve_vec<N>(Lf, scaled, xs);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = sd[i] * xs[i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = Vc[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s += Vc[i][j] * x[j];
      y[i] = vc[i] + s;
    }
    store_vec<M>(u_out, e, b, B, u);
    store_vec<N>(x_out, e, b, B, x);
    store_vec<N>(y_out, e, b, B, y);
  }
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

}  // namespace riccati

// (n, m) instantiations: cartpole (4, 1), planar quadrotor (6, 2), double
// integrator (2, 1) and the small test shapes (3, 1), (3, 2).  The Python
// wrapper checks the same list (ops/riccati_cuda.py: SUPPORTED_SHAPES) and
// raises before calling for anything else.
#define RICCATI_DISPATCH(KERNEL, ...)                                        \
  if (n == 4 && m == 1) {                                                    \
    riccati::KERNEL<4, 1><<<grid, block, 0, s>>>(__VA_ARGS__);               \
  } else if (n == 6 && m == 2) {                                             \
    riccati::KERNEL<6, 2><<<grid, block, 0, s>>>(__VA_ARGS__);               \
  } else if (n == 2 && m == 1) {                                             \
    riccati::KERNEL<2, 1><<<grid, block, 0, s>>>(__VA_ARGS__);               \
  } else if (n == 3 && m == 1) {                                             \
    riccati::KERNEL<3, 1><<<grid, block, 0, s>>>(__VA_ARGS__);               \
  } else if (n == 3 && m == 2) {                                             \
    riccati::KERNEL<3, 2><<<grid, block, 0, s>>>(__VA_ARGS__);               \
  } else {                                                                   \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }                                                                          \
  return static_cast<int>(cudaGetLastError());

extern "C" {

int riccati_factor_f32(int n, int m, int T, int B, const float* Q,
                       const float* delta, const float* A, const float* Bm,
                       const float* Mm, const float* R, float* v_out,
                       float* w_out, float* k_out, float* g_out,
                       void* stream) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = riccati::grid_for(B), block(riccati::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RICCATI_DISPATCH(factor_kernel, T, B, Q, delta, A, Bm, Mm, R, v_out, w_out,
                   k_out, g_out)
}

int riccati_solve_bwd_f32(int n, int m, int T, int B, const float* q,
                          const float* r, const float* c, const float* delta,
                          const float* fchol, const float* gchol,
                          const float* K, const float* A, const float* Bm,
                          float* k_out, float* v_out, void* stream) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = riccati::grid_for(B), block(riccati::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RICCATI_DISPATCH(solve_bwd_kernel, T, B, q, r, c, delta, fchol, gchol, K, A,
                   Bm, k_out, v_out)
}

int riccati_solve_fwd_f32(int n, int m, int T, int B, const float* x_root,
                          const float* k, const float* K, const float* A,
                          const float* Bm, const float* c, const float* delta,
                          const float* v, const float* V, const float* fchol,
                          float* u_out, float* x_out, float* y_out,
                          void* stream) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = riccati::grid_for(B), block(riccati::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RICCATI_DISPATCH(solve_fwd_kernel, T, B, x_root, k, K, A, Bm, c, delta, v,
                   V, fchol, u_out, x_out, y_out)
}

}  // extern "C"
