// Whole-iteration fused chain kernels for Hopper (sm_90a): factor, solve
// backward, solve forward, eval.
//
// Replaces the TPU kernels of sip_optimal_control_tpu/ops/fused_iter.py:
//   factor_team_kernel, factor_thread_kernel  <- _factor_kernel     (:255)
//   solve_bwd_kernel                          <- _solve_bwd_kernel  (:361)
//   solve_fwd_kernel                          <- _solve_fwd_kernel  (:438)
//   eval_kernel                               <- _eval_kernel       (:492)
// and computes what they compute.  The plain PyTorch twins, the codegen
// route and the wrappers are in ops/fused_iter.py.
//
// The user's stage functions and their derivatives are not known here.
// ops/fused_iter.py::cuda_source generates, per model, a struct `Model`
// with the horizon and dims as constants, the stage functions, the dynamics
// Jacobian and VJP, the cost gradients and the node and edge Hessians as
// straight-line float32 code (ops/stage_codegen.py::emit_cuda; closure
// constants are literals; the stage index is a run-time argument, so the
// terminal node is stage T of the same programs), and the finite bounds'
// complementarity terms, and instantiates the launchers below behind plain C
// entry points.
//
// Layout.  The iterate and the per-stage vectors are read in place from the
// port's [B, stage, dim] layout; the factor products are written once,
// structure of arrays [T, rows, B] with the scenario index contiguous, and
// read by the solve kernels in that layout, so nothing is transposed between
// the kernels.  At n >= kPackN the symmetric V and the triangular F_chol are
// stored lower-packed; at n >= kGramN A and B are not stored but recomputed
// in the solve kernels from (x, u), and the factor takes the Gram form.
//
// Design of the factor.  A block holds S scenarios (8 or 16, fewer where a
// model's shared memory needs it; at least 132 blocks at the main path's
// batch of 4096), each owned by a team of L lanes of one warp.  Per chunk of
// C stages, walked backward, the team copies the chunk's rows of x, u, r1x,
// r1u (and y at the children in exact mode) into shared memory with
// cp.async one chunk ahead; a scenario's rows of a chunk are contiguous, so
// the copy is coalesced.  Then the stage derivatives that do not depend on
// the carry (dyn_jac, nhess, ehess) are evaluated into the chunk's ring of
// stage slots, one (program, stage) item per lane of the team (n < kGramN)
// or per warp of the block, its lanes over the block's scenarios (n >=
// kGramN: a warp runs one program, no divergence), and the recursion reads
// them there, so its dependent chain holds only the Riccati algebra.  The
// carry starts from the terminal node's Q_T = nhess(x_T, T) + diag(r1x_T),
// evaluated in the kernel too.
//   - Team design (n >= kGramN, the Gram form; n <= 32): lane r holds row r
//     of V; the Cholesky of F = I + d V runs column by column over the team
//     (a shuffle broadcasts the pivot, __syncwarp on the team's mask orders
//     the columns); the triangular solves run one right-hand column per
//     lane, on [Ah Bh] stored by columns; the Gram products and V_parent one
//     entry, column or row per lane, with Lf, Z, H, G and K in shared
//     memory.  Each stage's products are staged in shared memory and
//     written by the whole block, row by row, consecutive threads on
//     consecutive scenarios.
//   - Thread design (n < kGramN): the team's lanes produce the stage slots;
//     one lane per team runs the explicit-W recursion in registers
//     (riccati_tiny.cuh) and writes its products.
//
// Design of the eval.  A warp per scenario, its lanes over the T + 1 nodes
// (lane j takes nodes j, j + 32, ...): neighbouring lanes read and write
// neighbouring rows.  Node T (its cost and gradient, ctx = -y_T) and the root
// row (cdyn_0 = x0 - x_0) are computed in the kernel.  The objective sums per
// lane in node order, then over the warp by an xor butterfly
// (ops/fused_iter.py::eval_codegen sums in that order); the KKT maxima and
// the d*z minima and maxima reduce by NaN-propagating shuffles.
//
// Design of the solve kernels.  On the TPU one block holds 1024 scenarios on
// the vector lanes and the grid walks the horizon with the carry in VMEM.
// Here one thread owns one scenario and runs the horizon loop with the carry
// (v or x) in registers; the tiny matrix algebra is unrolled
// (riccati_tiny.cuh, the same cho_solve as the standalone Riccati kernels).
//
// What bounds them on an H100 (PERF.md §6).  The factor at n = 16: each
// team's dependent chain per stage (16 Cholesky columns, each a shuffle and
// a warp barrier; the 16-step triangular solves, lanes 0-3 doing two; two
// block barriers around the staged writes), and occupancy: 155 registers
// let 3 blocks of 8 scenarios onto an SM, so the 512 blocks of the main
// path's batch run in two waves (capped at 128 registers they fit in one,
// ~1.6x faster, but spill).  At n < 8 the recursion's chain in one lane.  The eval: the generated stage programs' instructions per node,
// at chain16 with 214 registers.  The solve kernels: at the main path's
// batch of 4096 there are 32 blocks of 128 threads for 132 SMs, each thread
// a dependent chain of T stages, so they are latency-bound; at n = 16 their
// live set spills to local memory.  None of the kernels is bound by device
// memory: the blocks the standard path streams through memory never leave
// the chip.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "riccati_tiny.cuh"

namespace fused_iter {

using riccati::soa;

constexpr int kThreads = 128;  // the solve kernels
constexpr int kGramN = 8;  // ops/fused_iter.py: GRAM_N
constexpr int kPackN = 6;  // ops/fused_iter.py: PACK_N

template <int N>
struct Sym {
  static constexpr int kRows = N >= kPackN ? N * (N + 1) / 2 : N * N;
};

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// NaN-propagating max / min, as jnp.maximum / torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ void fold(float& mn, float& mx, float v) {
  mn = nan_min(mn, v);
  mx = nan_max(mx, v);
}

// Symmetric / triangular block of stage s: lower-packed at N >= kPackN,
// where entry (i, j) reads the packed (max, min) slot (exact for V, and the
// triangular solves read only the lower entries of F_chol).
template <int N>
__device__ __forceinline__ void store_sym(float* __restrict__ p, int s, int b,
                                          int B, const float (&a)[N][N]) {
  if constexpr (N >= kPackN) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) p[soa(s, tri(i, j), Sym<N>::kRows, b, B)] = a[i][j];
  } else {
    riccati::store_mat<N, N>(p, s, b, B, a);
  }
}

template <int N>
__device__ __forceinline__ void load_sym(const float* __restrict__ p, int s,
                                         int b, int B, float (&a)[N][N]) {
  if constexpr (N >= kPackN) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        a[i][j] = p[soa(s, i >= j ? tri(i, j) : tri(j, i), Sym<N>::kRows, b, B)];
  } else {
    riccati::load_mat<N, N>(p, s, b, B, a);
  }
}

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&out)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = p[j];
}

// A [N][N] and B [N][M] of edge e: from the factor's products (n < kGramN)
// or recomputed from the iterate (n >= kGramN, JAX fused_iter.py:385-397).
template <class Model>
__device__ __forceinline__ void edge_jacobians(
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ xb, const float* __restrict__ ub, int e, int b,
    int B, float (&A)[Model::N][Model::N], float (&Bm)[Model::N][Model::M]) {
  constexpr int N = Model::N, M = Model::M;
  if constexpr (N >= kGramN) {
    float xe[N], ue[M], jac[N * N + N * M];
    load_row<N>(xb + e * N, xe);
    load_row<M>(ub + e * M, ue);
    Model::dyn_jac(xe, ue, e, jac);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = jac[i * N + j];
#pragma unroll
      for (int j = 0; j < M; ++j) Bm[i][j] = jac[N * N + i * M + j];
    }
  } else {
    riccati::load_mat<N, N>(a, e, b, B, A);
    riccati::load_mat<N, M>(bm, e, b, B, Bm);
  }
}

// ---------------------------------------------------------------------------
// kernel F: stage derivatives + condensation + Riccati edge step, backward
// ---------------------------------------------------------------------------

// bytes of stage slots per block that bound the chunk of stages produced at
// once, and the chunk's cap
constexpr int kSlotBudget = 32768;
constexpr int kMaxChunk = 8;

__host__ __device__ constexpr int largest_divisor(int t, int cap) {
  int c = cap < 1 ? 1 : cap;
  while (c > 1 && t % c != 0) --c;
  return c;
}
__host__ __device__ constexpr int align4(int v) { return (v + 3) / 4 * 4; }

// dynamic shared memory a block may hold on sm_90
constexpr int kMaxSmem = 232448;

// The chunk of stages produced at once for S scenarios per block, and the
// floats per scenario of the shared-memory map below (team: the products'
// and the scratch rows too).
__host__ __device__ constexpr int factor_chunk(int t, int s, int slot) {
  const int cap = kSlotBudget / (4 * s * slot);
  return largest_divisor(t, cap < kMaxChunk ? cap : kMaxChunk);
}
__host__ __device__ constexpr int factor_stride(bool team, int c, int row,
                                                int slot, int out_rows,
                                                int scr_rows) {
  const int used = align4(align4(2 * c * row) + c * slot + out_rows) + scr_rows;
  return team ? (used + 7) / 8 * 8 + 4 : used | 1;
}
// Scenarios per block: 8 (teams of 16 or 32 lanes) or 16, halved while the
// block's shared memory exceeds kMaxSmem, down to one warp's worth.
__host__ __device__ constexpr int factor_scenarios(int l, int t, bool team,
                                                   int row, int slot,
                                                   int out_rows,
                                                   int scr_rows) {
  int s = l >= 16 ? 8 : 16;
  while (s > 32 / l &&
         4 * s * factor_stride(team, factor_chunk(t, s, slot), row, slot,
                               out_rows, scr_rows) > kMaxSmem)
    s /= 2;
  return s;
}

// Shapes and the shared-memory map of the factor for one model.  Per
// scenario, at stride P floats (thread design: odd, so that a row read
// across the block's scenarios hits distinct banks; team design: 4 mod 8,
// so that the regions are 16-byte aligned for vector loads and two teams of
// a warp read distinct banks), regions at multiples of 4 floats:
//   raw   two buffers of a chunk's rows: x [C][N], u [C][M], r1x [C][N],
//         r1u [C][M], y of the children [C][N] (exact mode)
//   slots C stage slots: dyn_jac [A (N*N), B (N*M)], nhess [N*N], ehess
//         [Hxx (N*N), Hxu (N*M), Huu (M*M)]
//   out   (team) one stage's products: V_child, F_chol (nsym rows each), K,
//         G_chol, in the rows of the [T, rows, B] outputs
//   scr   (team) Z = Lf^-1 [Ah Bh] by columns, H by columns, G
// In the team design the slot's A and B become [Ah Bh] = d^-1/2 [A B] by
// columns (column c at c * N) before the edge step.
template <class Model>
struct FactorCfg {
  static constexpr int T = Model::T, N = Model::N, M = Model::M;
  static constexpr bool kTeam = N >= kGramN;
  static constexpr int L = !kTeam ? 4 : N <= 8 ? 8
                           : N <= 16 ? 16 : 32;   // lanes per scenario
  static constexpr int NS = Sym<N>::kRows;
  static constexpr int ROW = 2 * N + 2 * M + (Model::kExact ? N : 0);
  static constexpr int JAC = N * N + N * M, HN = N * N,
                       HE = N * N + N * M + M * M;
  static constexpr int SLOT = align4(JAC + HN + HE);
  static constexpr int kOutRows = kTeam ? 2 * NS + M * N + M * M : 0;
  static constexpr int kScrRows =
      kTeam ? N * (N + M) + M * N + M * M : 0;
  static constexpr int S =
      factor_scenarios(L, T, kTeam, ROW, SLOT, kOutRows, kScrRows);
  static constexpr int kBlock = L * S;
  static constexpr int C = factor_chunk(T, S, SLOT);
  static constexpr int kRaw = 0;
  static constexpr int kSlots = align4(kRaw + 2 * C * ROW);
  static constexpr int kOut = kSlots + C * SLOT;
  static constexpr int kScr = align4(kOut + kOutRows);
  static constexpr int P =
      factor_stride(kTeam, C, ROW, SLOT, kOutRows, kScrRows);
  static constexpr int kSmem = 4 * S * P;
  static_assert(N <= 32, "a team holds at most a warp (ops/fused_iter.py: "
                "FUSED_MAX_DIM)");
  static_assert(kSmem <= kMaxSmem, "the factor's shared memory exceeds a "
                "block's (ops/fused_iter.py: FUSED_MAX_DIM)");
  static_assert(32 % L == 0 && kBlock % 32 == 0, "teams tile warps");
};

// The lanes of the caller's team within its warp.
template <int L>
__device__ __forceinline__ unsigned team_mask(int tid) {
  if constexpr (L == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
  }
}

// Asynchronous 4-byte copies global -> shared (sm_80+), grouped per chunk.
// Compiled for the host (tests/test_torch_fused_iter_host.py), a plain copy.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
#endif
}

// Row (i, j) of a stored symmetric / triangular block: lower-packed at
// N >= kPackN, else row-major N x N.
template <int N>
__device__ __forceinline__ int sym_row(int i, int j) {
  if constexpr (N >= kPackN) {
    return tri(i, j);
  } else {
    return i * N + j;
  }
}

// The team copies chunk rows e_lo .. e_lo + C - 1 of its scenario into raw
// buffer `raw` (rows of a chunk are contiguous per scenario: coalesced).
template <class Model>
__device__ __forceinline__ void load_chunk(
    float* raw, const float* xb, const float* ub, const float* yb,
    const float* r1xb, const float* r1ub, int e_lo, int r) {
  using Cfg = FactorCfg<Model>;
  constexpr int N = Model::N, M = Model::M, C = Cfg::C, L = Cfg::L;
  for (int f = r; f < C * N; f += L) {
    cp_async4(raw + f, xb + e_lo * N + f);
    cp_async4(raw + C * (N + M) + f, r1xb + e_lo * N + f);
    if constexpr (Model::kExact)
      cp_async4(raw + C * (2 * N + 2 * M) + f, yb + (e_lo + 1) * N + f);
  }
  for (int f = r; f < C * M; f += L) {
    cp_async4(raw + C * N + f, ub + e_lo * M + f);
    cp_async4(raw + C * (2 * N + M) + f, r1ub + e_lo * M + f);
  }
}

// The team's lanes evaluate the chunk's stage derivatives, one (program,
// stage) item per lane and round, consecutive lanes on one program.
template <class Model>
__device__ __forceinline__ void produce_chunk(const float* raw, float* slots,
                                              int e_lo, int r) {
  using Cfg = FactorCfg<Model>;
  constexpr int N = Model::N, M = Model::M, C = Cfg::C;
#pragma unroll 1
  for (int k = r; k < 3 * C; k += Cfg::L) {
    const int p = k / C, c = k % C, e = e_lo + c;
    const float* xr = raw + c * N;
    const float* ur = raw + C * N + c * M;
    const float* yr = Model::kExact ? raw + C * (2 * N + 2 * M) + c * N : xr;
    float* slot = slots + c * Cfg::SLOT;
    if (p == 0) {
      Model::dyn_jac(xr, ur, e, slot);
    } else if (p == 1) {
      Model::nhess(xr, e, slot + Cfg::JAC);
    } else {
      Model::ehess(xr, ur, e, yr, slot + Cfg::JAC + Cfg::HN);
    }
  }
}

// One stage's products of the block's scenarios from their `out` rows in
// shared memory to a [T, rows, B] output, row by row with consecutive threads
// on consecutive scenarios (full 32-byte sectors from 8 scenarios on).
template <class Model>
__device__ __forceinline__ void write_rows(float* __restrict__ dst, int e,
                                           int rows, const float* src,
                                           int b0, int B) {
  using Cfg = FactorCfg<Model>;
  constexpr int S = Cfg::S;
  for (int idx = threadIdx.x; idx < rows * S; idx += Cfg::kBlock) {
    const int row = idx / S, s = idx % S;
    if (b0 + s < B) dst[soa(e, row, rows, b0 + s, B)] = src[s * Cfg::P + row];
  }
}

// The explicit-W edge step in registers (n < kGramN; lqr.cpp:689-719):
// W = d^-1 (I - F^-1); G = R + B^T W B; H = M^T + B^T W A; K = -G^-1 H;
// V_parent = Q + (A^T W A + K^T H).
template <int N, int M>
__device__ __forceinline__ void explicit_w_step(
    const float (&Lf)[N][N], float d, const float (&A)[N][N],
    const float (&Bm)[N][M], const float (&Qp)[N][N], const float (&R)[M][M],
    const float (&Mm)[N][M], float (&Lg)[M][M], float (&K)[M][N],
    float (&Vp)[N][N]) {
  float eye[N][N], Finv[N][N], W[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) eye[i][j] = i == j ? 1.0f : 0.0f;
  riccati::cho_solve_mat<N, N>(Lf, eye, Finv);
  const float inv_d = 1.0f / d;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) W[i][j] = inv_d * (eye[i][j] - Finv[i][j]);
  float BtW[M][N], G[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = Bm[0][i] * W[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += Bm[k][i] * W[k][j];
      BtW[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = BtW[i][0] * Bm[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += BtW[i][k] * Bm[k][j];
      G[i][j] = R[i][j] + s;
    }
  riccati::chol<M>(G, Lg);
  float WA[N][N], H[M][N], Kneg[M][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = W[i][0] * A[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += W[i][k] * A[k][j];
      WA[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = Bm[0][i] * WA[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += Bm[k][i] * WA[k][j];
      H[i][j] = Mm[j][i] + s;
    }
  riccati::cho_solve_mat<M, N>(Lg, H, Kneg);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) K[i][j] = -Kneg[i][j];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float awa = A[0][i] * WA[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) awa += A[k][i] * WA[k][j];
      float kh = K[0][i] * H[0][j];
#pragma unroll
      for (int k = 1; k < M; ++k) kh += K[k][i] * H[k][j];
      Vp[i][j] = Qp[i][j] + (awa + kh);
    }
}

// Per backward step e = T-1 .. 0, thread design: the team's lanes produce
// the stage slots (A, B, the node Hessian and the edge Hessians at (x_e,
// u_e), exact mode with y at the child node e + 1); lane 0 forms Q = Hn +
// Hxx + diag(r1x_e), R = Huu + diag(r1u_e), M = Hxu, F = I + d V_child,
// Lf = chol(F) and the explicit-W edge step in registers.  The carry starts
// from the terminal node's Q_T = Hn(x_T, T) + diag(r1x_T).  Inputs: x, y
// [B, T+1, N] (y in exact mode only), u [B, T, M], r1x [B, T+1, N], r1u
// [B, T, M], delta [B].  Outputs [T, rows, B]: V_child, F_chol, K, G_chol,
// A, B; vroot [rows, B].
template <class Model>
__global__ void __launch_bounds__(FactorCfg<Model>::kBlock)
factor_thread_kernel(int B, const float* __restrict__ x,
                     const float* __restrict__ u, const float* __restrict__ y,
                     const float* __restrict__ r1x,
                     const float* __restrict__ r1u,
                     const float* __restrict__ delta,
                     float* __restrict__ vc_out, float* __restrict__ fc_out,
                     float* __restrict__ k_out, float* __restrict__ g_out,
                     float* __restrict__ a_out, float* __restrict__ b_out,
                     float* __restrict__ vroot_out) {
  using Cfg = FactorCfg<Model>;
  constexpr int T = Model::T, N = Model::N, M = Model::M, C = Cfg::C,
                L = Cfg::L, NN = N * N, NM = N * M;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b = blockIdx.x * Cfg::S + team;
  const bool valid = b < B;
  const int bv = valid ? b : 0;
  const float* xb = x + static_cast<size_t>(bv) * (T + 1) * N;
  const float* ub = u + static_cast<size_t>(bv) * T * M;
  const float* yb = y + static_cast<size_t>(bv) * (T + 1) * N;
  const float* r1xb = r1x + static_cast<size_t>(bv) * (T + 1) * N;
  const float* r1ub = r1u + static_cast<size_t>(bv) * T * M;
  float* sc = smem + team * Cfg::P;
  float* raw0 = sc + Cfg::kRaw;
  float* slots = sc + Cfg::kSlots;
  const bool lead = valid && r == 0;
  const float d = valid ? delta[b] : 1.0f;

  if (valid) load_chunk<Model>(raw0, xb, ub, yb, r1xb, r1ub, T - C, r);
  cp_async_commit();
  // the terminal node: the carry starts from Q_T
  float* xt = raw0 + C * Cfg::ROW;
  for (int f = r; f < N; f += L) xt[f] = valid ? xb[T * N + f] : 0.0f;
  __syncwarp(mask);
  if (r == 0) Model::nhess(xt, T, slots + Cfg::JAC);
  __syncwarp(mask);
  float V[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      V[i][j] = slots[Cfg::JAC + i * N + j]
                + (i == j && valid ? r1xb[T * N + i] : 0.0f);

  constexpr int K = T / C;
#pragma unroll 1
  for (int kc = 0; kc < K; ++kc) {
    const int e_lo = T - (kc + 1) * C;
    float* raw = raw0 + (kc & 1) * C * Cfg::ROW;
    __syncwarp(mask);  // the team's last chunk: slots and buffer free
    if (valid && kc + 1 < K)
      load_chunk<Model>(raw0 + ((kc + 1) & 1) * C * Cfg::ROW, xb, ub, yb,
                        r1xb, r1ub, e_lo - C, r);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp(mask);
    produce_chunk<Model>(raw, slots, e_lo, r);
    __syncwarp(mask);
    if (!lead) continue;
#pragma unroll 1
    for (int c = C - 1; c >= 0; --c) {
      const int e = e_lo + c;
      const float* jac = slots + c * Cfg::SLOT;
      const float* hn = jac + Cfg::JAC;
      const float* he = hn + Cfg::HN;
      const float* r1xe = raw + C * (N + M) + c * N;
      const float* r1ue = raw + C * (2 * N + M) + c * M;
      float A[N][N], Bm[N][M], Qp[N][N], R[M][M], Mm[N][M];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          A[i][j] = jac[i * N + j];
          Qp[i][j] = hn[i * N + j] + he[i * N + j] + (i == j ? r1xe[i] : 0.0f);
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          Bm[i][j] = jac[NN + i * M + j];
          Mm[i][j] = he[NN + i * M + j];
        }
      }
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < M; ++j)
          R[i][j] = he[NN + NM + i * M + j] + (i == j ? r1ue[i] : 0.0f);

      // F = I + sqrt(d) V sqrt(d) = I + d V for the uniform scalar delta
      float F[N][N], Lf[N][N], Lg[M][M], Kg[M][N], Vp[N][N];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j)
          F[i][j] = d * V[i][j] + (i == j ? 1.0f : 0.0f);
      riccati::chol<N>(F, Lf);
      explicit_w_step<N, M>(Lf, d, A, Bm, Qp, R, Mm, Lg, Kg, Vp);

      store_sym<N>(vc_out, e, b, B, V);  // V of the CHILD (the carry)
      riccati::store_mat<M, N>(k_out, e, b, B, Kg);
      riccati::store_mat<M, M>(g_out, e, b, B, Lg);
      store_sym<N>(fc_out, e, b, B, Lf);
      riccati::store_mat<N, N>(a_out, e, b, B, A);
      riccati::store_mat<N, M>(b_out, e, b, B, Bm);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) V[i][j] = Vp[i][j];
    }
  }
  if (lead) store_sym<N>(vroot_out, 0, b, B, V);
}

// Lower Cholesky of F = I + d V by a team, lane r holding row r of V: column
// by column in riccati::chol's order of operations; the pivot reaches the
// team by a shuffle, the rows by the stored factor `lf` (the F_chol output
// rows, sym_row; zeros above the diagonal when not packed).
template <int N, int L>
__device__ __forceinline__ void team_chol(const float (&vrow)[N], float d,
                                          int r, unsigned mask, float* lf) {
  float lrow[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float t = d * vrow[j] + (r == j ? 1.0f : 0.0f);
#pragma unroll
    for (int k = 0; k < j; ++k) t -= lrow[k] * lf[sym_row<N>(j, k)];
    const float dj = sqrtf(__shfl_sync(mask, t, j, L));
    const float inv_d = 1.0f / dj;
    lrow[j] = r == j ? dj : t * inv_d;
    if (r < N) {
      if (r >= j) {
        lf[sym_row<N>(r, j)] = lrow[j];
      } else if constexpr (N < kPackN) {
        lf[r * N + j] = 0.0f;
      }
    }
    __syncwarp(mask);
  }
}

// N consecutive floats of shared memory into registers: float4 loads where
// N is a multiple of 4 (the Gram form's regions are 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_col(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 v = p4[k];
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = p[k];
  }
}

// The slot's A [N][N] and B [N][M] (row-major, as dyn_jac writes them)
// become [Ah Bh] = d^-1/2 [A B] by columns in place: column c at c * N.
// Lane r holds columns r, r + L, ... while the team swaps them.
template <class Model>
__device__ __forceinline__ void team_scale_columns(float* jac, float sdi,
                                                   int r, unsigned mask) {
  constexpr int N = Model::N, M = Model::M, W = N + M,
                L = FactorCfg<Model>::L, NC = (W + L - 1) / L;
  auto at = [&](int k, int c) {
    return c < N ? jac[k * N + c] : jac[N * N + k * M + (c - N)];
  };
  float col[NC][N];
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int k = 0; k < N; ++k)
      col[q][k] = r + q * L < W ? at(k, r + q * L) : 0.0f;
  __syncwarp(mask);
#pragma unroll
  for (int q = 0; q < NC; ++q)
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (r + q * L < W) jac[(r + q * L) * N + k] = sdi * col[q][k];
  __syncwarp(mask);
}

// The Gram-form edge step by a team (riccati_tiny.cuh::gram_core's
// arithmetic), on ab = [Ah Bh] by columns: lane c solves column c of Z =
// Lf^-1 [Ah Bh] (and columns c + L, ...), lane (i, j) entry G[i][j] of the
// upper triangle (and entries i * M + j + L, ...), lane j column j of H and K, lane i row i of V_parent (entry
// (i, j) as gram_core's (min, max) entry, so V_parent is exactly
// symmetric).  A lane keeps its own columns in registers and reads the
// others' from shared memory, where every lane of the team reads the same
// column (a broadcast).
template <class Model>
__device__ __forceinline__ void team_gram_step(
    const float* ab, const float* hn, const float* he, const float* r1xe,
    const float* r1ue, int r, unsigned mask, const float* lf, float* kk,
    float* g, float* scr, float (&vrow)[Model::N]) {
  constexpr int N = Model::N, M = Model::M, W = N + M, NN = N * N,
                NM = N * M, L = FactorCfg<Model>::L;
  float* Z = scr;        // [W][N]: column c of Z at c * N
  float* H = Z + W * N;  // [N][M]: column j of H at j * M
  float* G = H + N * M;  // [M][M]
  auto q_at = [&](int i, int j) {
    return hn[i * N + j] + he[i * N + j] + (i == j ? r1xe[i] : 0.0f);
  };
  auto r_at = [&](int i, int j) {
    return he[NN + NM + i * M + j] + (i == j ? r1ue[i] : 0.0f);
  };
#pragma unroll 1
  for (int c = r; c < W; c += L) {
    float b[N], z[N];
    load_col<N>(ab + c * N, b);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= lf[sym_row<N>(i, k)] * z[k];
      z[i] = s / lf[sym_row<N>(i, i)];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) Z[c * N + i] = z[i];
  }
  __syncwarp(mask);
  for (int q = r; q < M * M; q += L) {
    const int i = q / M, j = q % M;
    if (i <= j) {
      const float* bi = ab + (N + i) * N;
      const float* bj = ab + (N + j) * N;
      const float* zi = Z + (N + i) * N;
      const float* zj = Z + (N + j) * N;
      float s = i == j ? r_at(i, j) : 0.5f * (r_at(i, j) + r_at(j, i));
#pragma unroll
      for (int k = 0; k < N; ++k) s = s + bi[k] * bj[k] - zi[k] * zj[k];
      G[i * M + j] = s;
      G[j * M + i] = s;
    }
  }
  __syncwarp(mask);
  float Gm[M][M], Lg[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Gm[i][j] = G[i * M + j];
  riccati::chol<M>(Gm, Lg);
  if (r < N) {
    const int j = r;
    float aj[N], zj[N], h[M], kneg[M];
    load_col<N>(ab + j * N, aj);
    load_col<N>(Z + j * N, zj);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float bi[N], zi[N];
      load_col<N>(ab + (N + i) * N, bi);
      load_col<N>(Z + (N + i) * N, zi);
      float s = bi[0] * aj[0] - zi[0] * zj[0];
#pragma unroll
      for (int k = 1; k < N; ++k) s = s + (bi[k] * aj[k] - zi[k] * zj[k]);
      h[i] = he[NN + j * M + i] + s;
    }
    riccati::cho_solve_vec<M>(Lg, h, kneg);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      H[j * M + i] = h[i];
      kk[i * N + j] = -kneg[i];
    }
  }
  if (r == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) g[i * M + j] = Lg[i][j];
  }
  __syncwarp(mask);
  if (r < N) {
    const int i = r;
    float ai[N], zi[N], ki[M], hi[M];
    load_col<N>(ab + i * N, ai);
    load_col<N>(Z + i * N, zi);
#pragma unroll
    for (int k = 0; k < M; ++k) {
      ki[k] = kk[k * N + i];
      hi[k] = H[i * M + k];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int a = i < j ? i : j, c = i < j ? j : i;
      float aj[N], zj[N];
      load_col<N>(ab + j * N, aj);
      load_col<N>(Z + j * N, zj);
      float s = a == c ? q_at(a, c) : 0.5f * (q_at(a, c) + q_at(c, a));
#pragma unroll
      for (int k = 0; k < N; ++k) s = s + ai[k] * aj[k] - zi[k] * zj[k];
      // K[k][a] H[k][c]: own K column against H's column j when j >= i,
      // K's column j against own H column otherwise
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const float kf = j >= i ? ki[k] : kk[k * N + j];
        const float hf = j >= i ? H[j * M + k] : hi[k];
        s = s + kf * hf;
      }
      vrow[j] = s;
    }
  }
}

// The Gram form's stage derivatives for the whole block: the (program,
// stage) pairs on warps, the block's scenarios on lanes, so that a warp
// runs one program (no divergence between dyn_jac, nhess and ehess).
template <class Model>
__device__ __forceinline__ void produce_chunk_block(float* smem, int q,
                                                    int e_lo) {
  using Cfg = FactorCfg<Model>;
  constexpr int N = Model::N, M = Model::M, C = Cfg::C;
  constexpr int kWarps = Cfg::kBlock / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int k = warp; k < 3 * C; k += kWarps) {
    const int p = k / C, c = k % C, e = e_lo + c;
    for (int t = lane; t < Cfg::S; t += 32) {
      float* sc = smem + t * Cfg::P;
      const float* raw = sc + Cfg::kRaw + q * C * Cfg::ROW;
      const float* xr = raw + c * N;
      const float* ur = raw + C * N + c * M;
      const float* yr =
          Model::kExact ? raw + C * (2 * N + 2 * M) + c * N : xr;
      float* slot = sc + Cfg::kSlots + c * Cfg::SLOT;
      if (p == 0) {
        Model::dyn_jac(xr, ur, e, slot);
      } else if (p == 1) {
        Model::nhess(xr, e, slot + Cfg::JAC);
      } else {
        Model::ehess(xr, ur, e, yr, slot + Cfg::JAC + Cfg::HN);
      }
    }
  }
}

// Per backward step e = T-1 .. 0, team design (n >= kGramN): the stage
// slots as in the thread design, produced by the block's warps; lane r holds
// row r of V; the team's Cholesky of F = I + d V and its Gram-form edge
// step; each stage's products are staged in shared memory and written by the
// block.  Same operands as factor_thread_kernel; A and B are not written.
template <class Model>
__global__ void __launch_bounds__(FactorCfg<Model>::kBlock)
factor_team_kernel(int B, const float* __restrict__ x,
                   const float* __restrict__ u, const float* __restrict__ y,
                   const float* __restrict__ r1x,
                   const float* __restrict__ r1u,
                   const float* __restrict__ delta, float* __restrict__ vc_out,
                   float* __restrict__ fc_out, float* __restrict__ k_out,
                   float* __restrict__ g_out, float* __restrict__ a_out,
                   float* __restrict__ b_out, float* __restrict__ vroot_out) {
  using Cfg = FactorCfg<Model>;
  constexpr int T = Model::T, N = Model::N, M = Model::M, C = Cfg::C,
                L = Cfg::L, NS = Cfg::NS;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, r = threadIdx.x % L;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b0 = blockIdx.x * Cfg::S, b = b0 + team;
  const bool valid = b < B;
  const int bv = valid ? b : 0;
  const float* xb = x + static_cast<size_t>(bv) * (T + 1) * N;
  const float* ub = u + static_cast<size_t>(bv) * T * M;
  const float* yb = y + static_cast<size_t>(bv) * (T + 1) * N;
  const float* r1xb = r1x + static_cast<size_t>(bv) * (T + 1) * N;
  const float* r1ub = r1u + static_cast<size_t>(bv) * T * M;
  float* sc = smem + team * Cfg::P;
  float* raw0 = sc + Cfg::kRaw;
  float* slots = sc + Cfg::kSlots;
  float* vc = sc + Cfg::kOut;  // the products' rows: vc, fc, k, g
  float* lf = vc + NS;
  float* kk = lf + NS;
  float* g = kk + M * N;
  float* scr = sc + Cfg::kScr;
  const float d = valid ? delta[b] : 1.0f;
  const float sdi = rsqrtf(d);

  if (valid) load_chunk<Model>(raw0, xb, ub, yb, r1xb, r1ub, T - C, r);
  cp_async_commit();
  // the terminal node: the carry starts from Q_T
  float* xt = raw0 + C * Cfg::ROW;
  for (int f = r; f < N; f += L) xt[f] = valid ? xb[T * N + f] : 0.0f;
  __syncwarp(mask);
  if (r == 0) Model::nhess(xt, T, slots + Cfg::JAC);
  __syncwarp(mask);
  float vrow[N];
  const int ro = r < N ? r : 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
    vrow[j] = slots[Cfg::JAC + ro * N + j]
              + (ro == j && valid ? r1xb[T * N + ro] : 0.0f);

  constexpr int K = T / C;
#pragma unroll 1
  for (int kc = 0; kc < K; ++kc) {
    const int e_lo = T - (kc + 1) * C;
    float* raw = raw0 + (kc & 1) * C * Cfg::ROW;
    __syncwarp(mask);  // the team's last chunk: slots and buffer free
    if (valid && kc + 1 < K)
      load_chunk<Model>(raw0 + ((kc + 1) & 1) * C * Cfg::ROW, xb, ub, yb,
                        r1xb, r1ub, e_lo - C, r);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // every team's rows have landed
    produce_chunk_block<Model>(smem, kc & 1, e_lo);
    __syncthreads();
#pragma unroll 1
    for (int c = C - 1; c >= 0; --c) {
      const int e = e_lo + c;
      float* jac = slots + c * Cfg::SLOT;
      const float* hn = jac + Cfg::JAC;
      const float* he = hn + Cfg::HN;
      const float* r1xe = raw + C * (N + M) + c * N;
      const float* r1ue = raw + C * (2 * N + M) + c * M;
      // V of the CHILD (the carry before the update) into the products
      if (r < N) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (N < kPackN || j <= r) vc[sym_row<N>(r, j)] = vrow[j];
      }
      team_scale_columns<Model>(jac, sdi, r, mask);
      team_chol<N, L>(vrow, d, r, mask, lf);
      team_gram_step<Model>(jac, hn, he, r1xe, r1ue, r, mask, lf, kk, g, scr,
                            vrow);
      __syncthreads();
      write_rows<Model>(vc_out, e, NS, smem + Cfg::kOut, b0, B);
      write_rows<Model>(fc_out, e, NS, smem + Cfg::kOut + NS, b0, B);
      write_rows<Model>(k_out, e, M * N, smem + Cfg::kOut + 2 * NS, b0, B);
      write_rows<Model>(g_out, e, M * M, smem + Cfg::kOut + 2 * NS + M * N,
                        b0, B);
      __syncthreads();
    }
  }
  if (r < N) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (N < kPackN || j <= r) vc[sym_row<N>(r, j)] = vrow[j];
  }
  __syncthreads();
  write_rows<Model>(vroot_out, 0, NS, smem + Cfg::kOut, b0, B);
}

// ---------------------------------------------------------------------------
// the solve kernels, reading the factor's products in place
// ---------------------------------------------------------------------------

// Backward vector pass per edge e = T-1 .. 0, carrying v of the child node
// (reference: lqr.cpp:746-795); W f from the child's F_chol by two
// triangular solves.  At the end, the root solve (lqr.cpp:798-819):
// x_0 = -(I + d V_0)^-1 (d v_0 - c_0), y_0 = v_0 + V_0 x_0.  Inputs: q, c
// [B, T+1, N], r [B, T, M], delta [B], the factor's products, and the
// iterate x, u (read for A and B at n >= kGramN).  Outputs: k [T, M, B],
// v of the child node [T, N, B], x_root and y_root [N, B].
template <class Model>
__global__ void __launch_bounds__(kThreads)
solve_bwd_kernel(int B, const float* __restrict__ q,
                 const float* __restrict__ c, const float* __restrict__ r,
                 const float* __restrict__ delta,
                 const float* __restrict__ vroot,
                 const float* __restrict__ fc, const float* __restrict__ g,
                 const float* __restrict__ kg, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ x,
                 const float* __restrict__ u, float* __restrict__ k_out,
                 float* __restrict__ v_out, float* __restrict__ xr_out,
                 float* __restrict__ yr_out) {
  constexpr int T = Model::T, N = Model::N, M = Model::M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* qb = q + static_cast<size_t>(b) * (T + 1) * N;
  const float* cb = c + static_cast<size_t>(b) * (T + 1) * N;
  const float* rb = r + static_cast<size_t>(b) * T * M;
  const float* xb = x + static_cast<size_t>(b) * (T + 1) * N;
  const float* ub = u + static_cast<size_t>(b) * T * M;
  const float d = delta[b];
  const float sdi = rsqrtf(d);

  float v[N];
  load_row<N>(qb + T * N, v);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;
    float Lf[N][N], Lg[M][M], K[M][N], A[N][N], Bm[N][M];
    load_sym<N>(fc, e, b, B, Lf);
    riccati::load_mat<M, M>(g, e, b, B, Lg);
    riccati::load_mat<M, N>(kg, e, b, B, K);
    edge_jacobians<Model>(a, bm, xb, ub, e, b, B, A, Bm);

    float fh[N], finv_fh[N], gg[N];
#pragma unroll
    for (int i = 0; i < N; ++i) fh[i] = sdi * (d * v[i] - cb[(e + 1) * N + i]);
    riccati::cho_solve_vec<N>(Lf, fh, finv_fh);
#pragma unroll
    for (int i = 0; i < N; ++i) gg[i] = v[i] - sdi * (fh[i] - finv_fh[i]);

    float h[M], kneg[M], kv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = Bm[0][i] * gg[0];
#pragma unroll
      for (int k = 1; k < N; ++k) s += Bm[k][i] * gg[k];
      h[i] = rb[e * M + i] + s;
    }
    riccati::cho_solve_vec<M>(Lg, h, kneg);
#pragma unroll
    for (int i = 0; i < M; ++i) kv[i] = -kneg[i];

    riccati::store_vec<M>(k_out, e, b, B, kv);
    riccati::store_vec<N>(v_out, e, b, B, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float atg = A[0][i] * gg[0];
#pragma unroll
      for (int k = 1; k < N; ++k) atg += A[k][i] * gg[k];
      float kth = K[0][i] * h[0];
#pragma unroll
      for (int k = 1; k < M; ++k) kth += K[k][i] * h[k];
      v[i] = qb[e * N + i] + atg + kth;
    }
  }

  // the root solve (a failed Cholesky surfaces as NaN in x_root)
  float Vr[N][N], Fr[N][N], Lfr[N][N], fr[N], sol[N], xr[N], yr[N];
  load_sym<N>(vroot, 0, b, B, Vr);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Fr[i][j] = d * Vr[i][j] + (i == j ? 1.0f : 0.0f);
    fr[i] = d * v[i] - cb[i];
  }
  riccati::chol<N>(Fr, Lfr);
  riccati::cho_solve_vec<N>(Lfr, fr, sol);
#pragma unroll
  for (int i = 0; i < N; ++i) xr[i] = -sol[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Vr[i][0] * xr[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += Vr[i][j] * xr[j];
    yr[i] = v[i] + s;
  }
  riccati::store_vec<N>(xr_out, 0, b, B, xr);
  riccati::store_vec<N>(yr_out, 0, b, B, yr);
}

// Forward rollout per edge e = 0 .. T-1, carrying x of the parent node
// (reference: lqr.cpp:821-870): u = k + K x, x_child = (I + d V)^-1
// (A x + B u + c - d v) through F_chol, y = v + V x_child.  Writes the
// Newton direction in the port's layout: du [B, T, M], dx and dy
// [B, T+1, N], the root rows (x_root, y_root) included.
template <class Model>
__global__ void __launch_bounds__(kThreads)
solve_fwd_kernel(int B, const float* __restrict__ xr,
                 const float* __restrict__ yr, const float* __restrict__ kv,
                 const float* __restrict__ kg, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ x,
                 const float* __restrict__ u, const float* __restrict__ c,
                 const float* __restrict__ delta,
                 const float* __restrict__ vv, const float* __restrict__ vc,
                 const float* __restrict__ fc, float* __restrict__ du,
                 float* __restrict__ dx, float* __restrict__ dy) {
  constexpr int T = Model::T, N = Model::N, M = Model::M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* cb = c + static_cast<size_t>(b) * (T + 1) * N;
  const float* xb = x + static_cast<size_t>(b) * (T + 1) * N;
  const float* ub = u + static_cast<size_t>(b) * T * M;
  float* dub = du + static_cast<size_t>(b) * T * M;
  float* dxb = dx + static_cast<size_t>(b) * (T + 1) * N;
  float* dyb = dy + static_cast<size_t>(b) * (T + 1) * N;
  const float d = delta[b];
  const float sd = sqrtf(d);
  const float sdi = 1.0f / sd;

  float xp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    xp[i] = xr[soa(0, i, N, b, B)];
    dxb[i] = xp[i];
    dyb[i] = yr[soa(0, i, N, b, B)];
  }
#pragma unroll 1
  for (int e = 0; e < T; ++e) {
    float kvec[M], K[M][N], A[N][N], Bm[N][M], vcv[N], Vc[N][N], Lf[N][N];
    riccati::load_vec<M>(kv, e, b, B, kvec);
    riccati::load_mat<M, N>(kg, e, b, B, K);
    edge_jacobians<Model>(a, bm, xb, ub, e, b, B, A, Bm);
    riccati::load_vec<N>(vv, e, b, B, vcv);
    load_sym<N>(vc, e, b, B, Vc);
    load_sym<N>(fc, e, b, B, Lf);

    float uu[M], rhs[N], xs[N], xc[N];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float s = K[i][0] * xp[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s += K[i][j] * xp[j];
      uu[i] = kvec[i] + s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float ax = A[i][0] * xp[0];
#pragma unroll
      for (int j = 1; j < N; ++j) ax += A[i][j] * xp[j];
      float bu = Bm[i][0] * uu[0];
#pragma unroll
      for (int j = 1; j < M; ++j) bu += Bm[i][j] * uu[j];
      rhs[i] = sdi * (cb[(e + 1) * N + i] - d * vcv[i] + ax + bu);
    }
    riccati::cho_solve_vec<N>(Lf, rhs, xs);
#pragma unroll
    for (int i = 0; i < N; ++i) xc[i] = sd * xs[i];
#pragma unroll
    for (int i = 0; i < M; ++i) dub[e * M + i] = uu[i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = Vc[i][0] * xc[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s += Vc[i][j] * xc[j];
      dxb[(e + 1) * N + i] = xc[i];
      dyb[(e + 1) * N + i] = vcv[i] + s;
      xp[i] = xc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel E: per-node evaluation and the packed KKT reductions
// ---------------------------------------------------------------------------

constexpr int kEvalLanes = 32;  // a warp per scenario (ops/fused_iter.py)
constexpr int kEvalScen = 4;    // scenarios per block

// A warp per scenario, lane j on nodes j, j + 32, ... (reference
// model_callback new_x path, sip_optimal_control.cpp:55-125).  Node k < T:
// the objective's node and edge terms, gx = node + edge cost gradients,
// ctx = A^T y_{k+1} - y_k, cdyn_{k+1} = dyn(x_k, u_k) - x_{k+1}, gu,
// ctu = B^T y_{k+1}; node T: its cost, gx = its gradient, ctx = -y_T; node 0
// also the root row cdyn_0 = x0 - x_0.  The reductions max |stat|, max
// |c_dyn| and min / max d*z over the finite lower and upper bounds (JAX
// fused_iter.py:530-591 and :885-918) over the node's rows, then over the
// warp; the objective per lane in node order, then by an xor butterfly.
// Writes gx, ctx, cdyn [B, T+1, N], gu, ctu [B, T, M], f [B], res [B, 6].
template <class Model>
__global__ void __launch_bounds__(kEvalLanes * kEvalScen)
eval_kernel(int B, const float* __restrict__ x, const float* __restrict__ u,
            const float* __restrict__ y, const float* __restrict__ x0,
            const float* __restrict__ zlx, const float* __restrict__ zlu,
            const float* __restrict__ zux, const float* __restrict__ zuu,
            float* __restrict__ gx, float* __restrict__ gu,
            float* __restrict__ ctx, float* __restrict__ ctu,
            float* __restrict__ cdyn, float* __restrict__ f_out,
            float* __restrict__ res_out) {
  constexpr int T = Model::T, N = Model::N, M = Model::M;
  const int lane = threadIdx.x % kEvalLanes;
  const int b = blockIdx.x * kEvalScen + threadIdx.x / kEvalLanes;
  if (b >= B) return;  // the whole warp
  const size_t node0 = static_cast<size_t>(b) * (T + 1) * N;
  const size_t edge0 = static_cast<size_t>(b) * T * M;

  float f = 0.0f, stat = 0.0f, cd = 0.0f;
  float cl_mn = INFINITY, cl_mx = -INFINITY, cu_mn = INFINITY,
        cu_mx = -INFINITY;
#pragma unroll 1
  for (int k = lane; k <= T; k += kEvalLanes) {
    const size_t np = node0 + k * N;
    float xk[N], gxn[N];
    load_row<N>(x + np, xk);
    Model::ncost_grad(xk, k, gxn);
    float fk = Model::ncost(xk, k);
    if (k < T) {
      const size_t nc = np + N, ep = edge0 + k * M;
      float uk[M], yc[N], ge[N + M], vjp[N + M], pred[N];
      load_row<M>(u + ep, uk);
      load_row<N>(y + nc, yc);
      Model::ecost_grad(xk, uk, k, ge);
      Model::dyn_vjp(xk, uk, k, yc, vjp);
      Model::dyn(xk, uk, k, pred);
      fk += Model::ecost(xk, uk, k);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float gx_i = gxn[i] + ge[i];
        const float ctx_i = vjp[i] - y[np + i];
        const float cd_i = pred[i] - x[nc + i];
        gx[np + i] = gx_i;
        ctx[np + i] = ctx_i;
        cdyn[nc + i] = cd_i;
        stat = nan_max(stat, fabsf(gx_i + ctx_i + zux[np + i] - zlx[np + i]));
        cd = nan_max(cd, fabsf(cd_i));
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float gu_i = ge[N + i];
        const float ctu_i = vjp[N + i];
        gu[ep + i] = gu_i;
        ctu[ep + i] = ctu_i;
        stat = nan_max(stat, fabsf(gu_i + ctu_i + zuu[ep + i] - zlu[ep + i]));
      }
      Model::edge_comp(uk, zlu + ep, zuu + ep, cl_mn, cl_mx, cu_mn, cu_mx);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ctx_i = -y[np + i];
        gx[np + i] = gxn[i];
        ctx[np + i] = ctx_i;
        stat = nan_max(stat,
                       fabsf(gxn[i] + ctx_i + zux[np + i] - zlx[np + i]));
      }
    }
    Model::node_comp(xk, zlx + np, zux + np, cl_mn, cl_mx, cu_mn, cu_mx);
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float c0 = x0[static_cast<size_t>(b) * N + i] - xk[i];
        cdyn[node0 + i] = c0;
        cd = nan_max(cd, fabsf(c0));
      }
    }
    f += fk;
  }
#pragma unroll
  for (int off = kEvalLanes / 2; off >= 1; off /= 2) {
    f += __shfl_xor_sync(0xffffffffu, f, off);
    stat = nan_max(stat, __shfl_xor_sync(0xffffffffu, stat, off));
    cd = nan_max(cd, __shfl_xor_sync(0xffffffffu, cd, off));
    cl_mn = nan_min(cl_mn, __shfl_xor_sync(0xffffffffu, cl_mn, off));
    cl_mx = nan_max(cl_mx, __shfl_xor_sync(0xffffffffu, cl_mx, off));
    cu_mn = nan_min(cu_mn, __shfl_xor_sync(0xffffffffu, cu_mn, off));
    cu_mx = nan_max(cu_mx, __shfl_xor_sync(0xffffffffu, cu_mx, off));
  }
  if (lane == 0) {
    f_out[b] = f;
    float* res = res_out + static_cast<size_t>(b) * 6;
    res[0] = stat;
    res[1] = cd;
    res[2] = cl_mn;
    res[3] = cl_mx;
    res[4] = cu_mn;
    res[5] = cu_mx;
  }
}

// ---------------------------------------------------------------------------
// launchers: on `stream`, return the CUDA error code (0 on success)
// ---------------------------------------------------------------------------

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

// The launch configuration of kernel `which` (0 factor, 1 solve_bwd, 2
// solve_fwd, 3 eval) at batch B: grid, block, dynamic shared memory bytes.
template <class Model>
void launch_config(int which, int B, int* out) {
  using Cfg = FactorCfg<Model>;
  if (which == 0) {
    out[0] = (B + Cfg::S - 1) / Cfg::S;
    out[1] = Cfg::kBlock;
    out[2] = Cfg::kSmem;
  } else if (which == 3) {
    out[0] = (B + kEvalScen - 1) / kEvalScen;
    out[1] = kEvalLanes * kEvalScen;
    out[2] = 0;
  } else {
    out[0] = static_cast<int>(grid_for(B).x);
    out[1] = kThreads;
    out[2] = 0;
  }
}

template <class Model>
inline auto factor_kernel_for() {
  if constexpr (FactorCfg<Model>::kTeam) {
    return &factor_team_kernel<Model>;
  } else {
    return &factor_thread_kernel<Model>;
  }
}

template <class Model>
int launch_factor(int B, const float* x, const float* u, const float* y,
                  const float* r1x, const float* r1u, const float* delta,
                  float* vc, float* fc, float* k, float* g, float* a,
                  float* bm, float* vroot, void* stream) {
  using Cfg = FactorCfg<Model>;
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = factor_kernel_for<Model>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + Cfg::S - 1) / Cfg::S, Cfg::kBlock, Cfg::kSmem,
           static_cast<cudaStream_t>(stream)>>>(B, x, u, y, r1x, r1u, delta,
                                                vc, fc, k, g, a, bm, vroot);
  return static_cast<int>(cudaGetLastError());
}

template <class Model>
int launch_solve_bwd(int B, const float* q, const float* c, const float* r,
                     const float* delta, const float* vroot, const float* fc,
                     const float* g, const float* k, const float* a,
                     const float* bm, const float* x, const float* u,
                     float* k_out, float* v_out, float* xr, float* yr,
                     void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  solve_bwd_kernel<Model><<<grid_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      B, q, c, r, delta, vroot, fc, g, k, a, bm, x, u, k_out, v_out, xr, yr);
  return static_cast<int>(cudaGetLastError());
}

template <class Model>
int launch_solve_fwd(int B, const float* xr, const float* yr, const float* kv,
                     const float* k, const float* a, const float* bm,
                     const float* x, const float* u, const float* c,
                     const float* delta, const float* vv, const float* vc,
                     const float* fc, float* du, float* dx, float* dy,
                     void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  solve_fwd_kernel<Model><<<grid_for(B), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      B, xr, yr, kv, k, a, bm, x, u, c, delta, vv, vc, fc, du, dx, dy);
  return static_cast<int>(cudaGetLastError());
}

template <class Model>
int launch_eval(int B, const float* x, const float* u, const float* y,
                const float* x0, const float* zlx, const float* zlu,
                const float* zux, const float* zuu, float* gx, float* gu,
                float* ctx, float* ctu, float* cdyn, float* f, float* res,
                void* stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  eval_kernel<Model><<<(B + kEvalScen - 1) / kEvalScen,
                       kEvalLanes * kEvalScen, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      B, x, u, y, x0, zlx, zlu, zux, zuu, gx, gu, ctx, ctu, cdyn, f, res);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fused_iter
