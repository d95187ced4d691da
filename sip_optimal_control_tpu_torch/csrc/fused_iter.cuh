// Whole-iteration fused chain kernels for Hopper (sm_90a): factor, solve
// backward, solve forward, eval.
//
// Replaces the TPU kernels of sip_optimal_control_tpu/ops/fused_iter.py:
//   factor_team_kernel, factor_thread_kernel  <- _factor_kernel     (:255)
//   solve_bwd_kernel                          <- _solve_bwd_kernel  (:361)
//   solve_fwd_kernel                          <- _solve_fwd_kernel  (:438)
//   eval_kernel                               <- _eval_kernel       (:492)
// and computes what they compute.  The plain PyTorch twins, the codegen
// route and the wrappers are in ops/fused_iter.py.  The team primitives
// (team_chol, team_gram_step, team_cho_solve, team_sum), the cp.async copies
// and the shared-memory sizing are in team.cuh, shared with csrc/riccati.cu.
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
// Here a block holds S = 16 scenarios (fewer where shared memory needs it;
// 256 blocks at the main path's batch of 4096, for 132 SMs) and walks the
// horizon in chunks of C stages, backward from T - 1 or forward from 0.  The
// block copies each chunk's operands with cp.async one chunk ahead, into a
// ring of two buffers per scenario: its rows of the [T, rows, B] products
// (row by row, consecutive threads on consecutive scenarios) and its
// contiguous rows of q, c, r (and x, u at n >= kGramN), so that the
// recursion reads only shared memory.  Its outputs are staged per chunk and
// written by the block, consecutive threads on consecutive addresses.  The
// chunk and S come from the block's share of the SM's shared memory
// (solve_smem: 32 scenarios per SM, one wave for 4096 scenarios).
//   - Team design (n >= kGramN): a team of L lanes per scenario (the
//     factor's), lane r owning row r of the carry (v backward, x forward).
//     The block first evaluates the chunk's dyn_jac into stage slots, row by
//     row (the generated Model::dyn_jac_row), one (stage, row) item per
//     warp.  The triangular solves through F_chol run one row per lane, each
//     solved entry shuffled to the team and folded into the other lanes'
//     partial sums; B^T g (backward) and K x (forward) are summed over the
//     team by an xor butterfly; A^T g, K^T h, A x and V_child x read the
//     exchanged vector from shared memory.  The root solve's Cholesky is
//     team_chol's, in chol's order, so statuses stay the twins'.
//   - Thread design (n < kGramN): A and B come from the factor's products;
//     lane 0 of each team runs the recursion in registers (the Cholesky
//     solves with the diagonal's reciprocals taken first), the team's lanes
//     copy and write.
//
// What bounds them on an H100 (PERF.md §6).  The factor at n = 16: each
// team's dependent chain per stage (16 Cholesky columns, each a shuffle and
// a warp barrier; the 16-step triangular solves, lanes 0-3 doing two; two
// block barriers around the staged writes), and occupancy: 155 registers
// let 3 blocks of 8 scenarios onto an SM, so the 512 blocks of the main
// path's batch run in two waves (capped at 128 registers they fit in one,
// ~1.6x faster, but spill).  At n < 8 the recursion's chain in one lane.
// The eval: the generated stage programs' instructions per node, at chain16
// with 214 registers.  The solve kernels (B = 4096, T = 50; device ms per
// launch against the bound of the bytes each input and output moves once,
// PERF.md §6): chain16 backward 0.253-0.258 against 0.0724, forward
// 0.328-0.332 against 0.1050; cartpole 0.054 against 0.0136 and 0.061
// against 0.0182.  A block's phases per chunk run one after another (the
// copies' issue and the wait for them, the dyn_jac rows, the recursion,
// three block barriers), and at the main path's batch only two blocks share
// an SM, too few for one block's phases to hide another's; the team's chain
// per stage is 2n shuffled substitution steps.  None of the kernels reaches
// the device memory's rate.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "riccati_tiny.cuh"
#include "team.cuh"

namespace fused_iter {

using riccati::cho_solve_rcp;
using riccati::soa;
using team::align4;
using team::block_stride;
using team::cp_async4;
using team::cp_async_commit;
using team::cp_async_wait;
using team::kMaxSmem;
using team::kPackN;
using team::kScenariosPerSM;
using team::load_col;
using team::solve_attributes;
using team::solve_smem;
using team::sym_row;
using team::team_cho_solve;
using team::team_chol;
using team::team_gram_step;
using team::team_mask;
using team::team_scale_columns;
using team::team_sum;
using team::tri;

constexpr int kGramN = 8;  // ops/fused_iter.py: GRAM_N

template <int N>
struct Sym {
  static constexpr int kRows = N >= kPackN ? N * (N + 1) / 2 : N * N;
};

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

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&out)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = p[j];
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
  return block_stride(
      team, align4(align4(2 * c * row) + c * slot + out_rows) + scr_rows);
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

// `count` rows from stage e on (count / rows stages) of the block's
// scenarios, from their rows at `src` in shared memory (stride Cfg::P) to a
// [T, rows, B] output, row by row with consecutive threads on consecutive
// scenarios (full 32-byte sectors from 8 scenarios on).
template <class Cfg>
__device__ __forceinline__ void write_rows(float* __restrict__ dst, int e,
                                           int rows, int count,
                                           const float* src, int b0, int B) {
  constexpr int S = Cfg::S;
  for (int idx = threadIdx.x; idx < count * S; idx += Cfg::kBlock) {
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
                L = Cfg::L, NS = Cfg::NS, NN = N * N,
                NM = N * M;
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
      team_scale_columns<N, M, L>(jac, [&](int) { return sdi; }, r, mask);
      team_chol<N, L>(vrow, d, r, mask, lf);
      team_gram_step<N, M, L>(
          jac,
          [&](int i, int j) {
            return hn[i * N + j] + he[i * N + j] + (i == j ? r1xe[i] : 0.0f);
          },
          [&](int i, int j) {
            return he[NN + NM + i * M + j] + (i == j ? r1ue[i] : 0.0f);
          },
          [&](int i, int j) { return he[NN + i * M + j]; }, r, mask, lf, kk,
          g, scr, vrow);
      __syncthreads();
      write_rows<Cfg>(vc_out, e, NS, NS, smem + Cfg::kOut, b0, B);
      write_rows<Cfg>(fc_out, e, NS, NS, smem + Cfg::kOut + NS, b0, B);
      write_rows<Cfg>(k_out, e, M * N, M * N, smem + Cfg::kOut + 2 * NS, b0,
                      B);
      write_rows<Cfg>(g_out, e, M * M, M * M,
                      smem + Cfg::kOut + 2 * NS + M * N, b0, B);
      __syncthreads();
    }
  }
  if (r < N) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (N < kPackN || j <= r) vc[sym_row<N>(r, j)] = vrow[j];
  }
  __syncthreads();
  write_rows<Cfg>(vroot_out, 0, NS, NS, smem + Cfg::kOut, b0, B);
}

// ---------------------------------------------------------------------------
// the solve kernels, reading the factor's products in place
// ---------------------------------------------------------------------------

// The parts of a solve kernel's chunk buffer, in the buffer's order: the
// [T, rows, B] operands (backward: F_chol, G_chol, K and, at n < kGramN, A
// and B; forward: k of the backward pass, K, v of the backward pass,
// V_child, F_chol, A, B), then the scenario's rows (backward: q_e, c_{e+1},
// r_e; forward: c_{e+1}; at n >= kGramN both: x_e, u_e for dyn_jac).
enum BwdPart { kBwdLf, kBwdLg, kBwdK, kBwdA, kBwdB, kBwdQ, kBwdC, kBwdR,
               kBwdX, kBwdU, kBwdParts };
enum FwdPart { kFwdKv, kFwdK, kFwdV, kFwdVc, kFwdLf, kFwdA, kFwdB, kFwdC,
               kFwdX, kFwdU, kFwdParts };

// chunk buffers of the ring: the next chunk is copied while the block works
// on this one
constexpr int kSolveRing = 2;

// floats per stage of part p
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_part_rows(int p) {
  constexpr int N = Model::N, M = Model::M, NS = Sym<N>::kRows;
  constexpr int AN = N < kGramN ? N * N : 0, BN = N < kGramN ? N * M : 0;
  constexpr int XN = N < kGramN ? 0 : N, UN = N < kGramN ? 0 : M;
  if (kBwd) {
    const int rows[kBwdParts] = {NS, M * M, M * N, AN, BN, N, N, M, XN, UN};
    return rows[p];
  }
  const int rows[kFwdParts] = {M, M * N, N, NS, NS, AN, BN, N, XN, UN};
  return rows[p];
}

// Offset of part p in a buffer of a chunk of c stages (each part c * rows
// floats, at a multiple of 4 floats); p = k*Parts gives the buffer's size.
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_part(int p, int c) {
  int o = 0;
  for (int i = 0; i < p; ++i) o += align4(c * solve_part_rows<Model, kBwd>(i));
  return o;
}

// Offset of staged output p of a chunk of c stages (backward: k [M], v [N];
// forward: du [M], dx [N], dy [N]); p = 2 (3) gives the region's size.
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_out(int p, int c) {
  int o = 0;
  for (int i = 0; i < p; ++i) o += align4(c * (i == 0 ? Model::M : Model::N));
  return o;
}

// Floats per scenario of SolveCfg's map for a chunk of c stages.
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_used(int c) {
  constexpr int N = Model::N, M = Model::M;
  return kSolveRing * solve_part<Model, kBwd>(kBwd ? kBwdParts : kFwdParts, c)
         + (N >= kGramN ? align4(c * (N * N + N * M)) + align4(N) : 0)
         + solve_out<Model, kBwd>(kBwd ? 2 : 3, c);
}

// Scenarios per block: 16, halved while a chunk of one stage exceeds a
// block's shared memory; the chunk: the largest divisor of T up to
// kMaxChunk whose block stays within its share (solve_smem).
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_scenarios() {
  constexpr int l = FactorCfg<Model>::L;
  constexpr bool team = Model::N >= kGramN;
  int s = 16;
  while (s > 32 / l &&
         4 * s * block_stride(team, solve_used<Model, kBwd>(1)) > kMaxSmem)
    s /= 2;
  return s;
}
template <class Model, bool kBwd>
__host__ __device__ constexpr int solve_chunk(int s) {
  constexpr bool team = Model::N >= kGramN;
  for (int c = kMaxChunk; c > 1; --c)
    if (Model::T % c == 0 &&
        4 * s * block_stride(team, solve_used<Model, kBwd>(c)) <=
            solve_smem(s))
      return c;
  return 1;
}

// Shapes and the shared-memory map of a solve kernel for one model.  A
// block holds S scenarios, each owned by a team of L lanes of one warp (the
// factor's teams).  Per scenario, at stride P floats (block_stride),
// regions at multiples of 4 floats:
//   buf   a ring of kSolveRing buffers of a chunk's parts (solve_part),
//         copied with cp.async kSolveRing - 1 chunks ahead
//   slots (team design) C stage slots of dyn_jac: A [N][N], B [N][M]
//   out   the chunk's staged outputs (solve_out)
//   vec   (team design) the vector the team exchanges (g backward, x
//         forward)
// Before the first chunk the ring's last buffer holds the carry's start
// (q_T; x_root and y_root).  After the last chunk K - 1 the buffer chunk K
// would take holds the root solve's operands (V_root and c_0), and chunk
// K - 1's the staged x_root and y_root.
template <class Model, bool kBwd>
struct SolveCfg {
  static constexpr int T = Model::T, N = Model::N, M = Model::M;
  static constexpr bool kTeam = FactorCfg<Model>::kTeam;
  static constexpr int L = FactorCfg<Model>::L, NS = Sym<N>::kRows;
  static constexpr int JAC = N * N + N * M;
  static constexpr int S = solve_scenarios<Model, kBwd>();
  static constexpr int kBlock = L * S;
  static constexpr int C = solve_chunk<Model, kBwd>(S);
  static constexpr int kBuf =
      solve_part<Model, kBwd>(kBwd ? kBwdParts : kFwdParts, C);
  static constexpr int kSlots = kSolveRing * kBuf;
  static constexpr int kOut = kSlots + (kTeam ? align4(C * JAC) : 0);
  static constexpr int kVec = kOut + solve_out<Model, kBwd>(kBwd ? 2 : 3, C);
  static constexpr int kUsed = kVec + (kTeam ? align4(N) : 0);
  static constexpr int P = block_stride(kTeam, kUsed);
  static constexpr int kSmem = 4 * S * P;
  // blocks per SM that the registers must allow: kScenariosPerSM
  static constexpr int kMinBlocks = kScenariosPerSM / S;
  __host__ __device__ static constexpr int part(int p) {
    return solve_part<Model, kBwd>(p, C);
  }
  __host__ __device__ static constexpr int out(int p) {
    return kOut + solve_out<Model, kBwd>(p, C);
  }
  static_assert(kUsed == solve_used<Model, kBwd>(C), "the map is solve_used's");
  static_assert(kSmem <= kMaxSmem, "a solve block's shared memory exceeds a "
                "block's (ops/fused_iter.py: FUSED_MAX_DIM)");
  static_assert(32 % L == 0 && kBlock % 32 == 0, "teams tile warps");
};

// Rows of a [T, rows, B] operand from stage e on, `count` of them (count /
// rows stages), for the block's scenarios into shared memory at `dst` of
// each scenario: cp.async, consecutive threads on consecutive scenarios.
template <class Cfg>
__device__ __forceinline__ void copy_rows(float* smem, int dst,
                                          const float* __restrict__ src,
                                          int e, int rows, int count, int b0,
                                          int B) {
  constexpr int S = Cfg::S;
  for (int idx = threadIdx.x; idx < count * S; idx += Cfg::kBlock) {
    const int row = idx / S, s = idx % S;
    if (b0 + s < B)
      cp_async4(smem + s * Cfg::P + dst + row,
                src + soa(e, row, rows, b0 + s, B));
  }
}

// `count` consecutive floats of each of the block's scenarios (scenario b's
// from src + b * stride) into shared memory at `dst` with cp.async, and
// back out (write_runs): consecutive threads on consecutive addresses.
template <class Cfg>
__device__ __forceinline__ void copy_runs(float* smem, int dst,
                                          const float* __restrict__ src,
                                          size_t stride, int count, int b0,
                                          int B) {
  for (int idx = threadIdx.x; idx < count * Cfg::S; idx += Cfg::kBlock) {
    const int s = idx / count, f = idx - s * count;
    if (b0 + s < B)
      cp_async4(smem + s * Cfg::P + dst + f, src + (b0 + s) * stride + f);
  }
}
template <class Cfg>
__device__ __forceinline__ void write_runs(float* __restrict__ dst,
                                           size_t stride, int count,
                                           const float* src, int b0, int B) {
  for (int idx = threadIdx.x; idx < count * Cfg::S; idx += Cfg::kBlock) {
    const int s = idx / count, f = idx - s * count;
    if (b0 + s < B) dst[(b0 + s) * stride + f] = src[s * Cfg::P + f];
  }
}

// dyn_jac of the chunk's stages into the stage slots for the whole block,
// row by row (the generated Model::dyn_jac_row: row r of A and of B): one
// (stage, row) item per warp, its lanes over the block's scenarios, so that
// a warp runs one program (as produce_chunk_block) and the block's warps
// share a stage's evaluation.
template <class Model, class Cfg, int kX, int kU>
__device__ __forceinline__ void produce_jac(float* smem, int o, int e_lo) {
  constexpr int N = Model::N, M = Model::M, kWarps = Cfg::kBlock / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int k = warp; k < Cfg::C * N; k += kWarps) {
    const int c = k / N, row = k % N;
    for (int t = lane; t < Cfg::S; t += 32) {
      float* sc = smem + t * Cfg::P;
      Model::dyn_jac_row(row, sc + o + Cfg::part(kX) + c * N,
                         sc + o + Cfg::part(kU) + c * M, e_lo + c,
                         sc + Cfg::kSlots + c * Cfg::JAC);
    }
  }
}

// A [R][C] row-major block of shared memory into registers.
template <int R, int C>
__device__ __forceinline__ void load_smat(const float* p, float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = p[i * C + j];
}

// A stored symmetric or lower-triangular block (sym_row), entry (i, j) from
// the (max, min) row: exact for V; the triangular solves read only the
// lower entries of F_chol.
template <int N>
__device__ __forceinline__ float sym_at(const float* p, int i, int j) {
  return p[i >= j ? sym_row<N>(i, j) : sym_row<N>(j, i)];
}
template <int N>
__device__ __forceinline__ void load_symm(const float* p, float (&a)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = sym_at<N>(p, i, j);
}

// One backward edge of the team design (n >= kGramN), lane r carrying v_r
// of the child: the operands from the chunk buffer, A and B from the stage
// slot `jac`; h = r + B^T g summed over the team, k in every lane, g through
// `vec` to every lane for its row of v_parent.  k and v of the child are
// staged.
template <class Model>
__device__ __forceinline__ void bwd_team_stage(const float* buf,
                                               const float* jac, int cs,
                                               int lane, unsigned mask,
                                               float d, float sdi, float& v,
                                               float* sc) {
  using Cfg = SolveCfg<Model, true>;
  constexpr int N = Model::N, M = Model::M, L = Cfg::L, NS = Cfg::NS;
  const int ro = lane < N ? lane : 0;
  const float* lf = buf + Cfg::part(kBwdLf) + cs * NS;
  const float* kk = buf + Cfg::part(kBwdK) + cs * M * N;
  const float* qe = buf + Cfg::part(kBwdQ) + cs * N;
  const float* c1 = buf + Cfg::part(kBwdC) + cs * N;
  const float* re = buf + Cfg::part(kBwdR) + cs * M;
  const float* bj = jac + N * N;
  float* vec = sc + Cfg::kVec;
  const float fh = sdi * (d * v - c1[ro]);
  const float gg = v - sdi * (fh - team_cho_solve<N, L>(lf, fh, lane, mask));
  __syncwarp(mask);
  if (lane < N) vec[lane] = gg;
  __syncwarp(mask);
  float h[M], kneg[M], Lg[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) h[i] = lane < N ? bj[ro * M + i] * gg : 0.0f;
  team_sum<M, L>(h, mask);
#pragma unroll
  for (int i = 0; i < M; ++i) h[i] += re[i];
  load_smat<M, M>(buf + Cfg::part(kBwdLg) + cs * M * M, Lg);
  cho_solve_rcp<M>(Lg, h, kneg);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) sc[Cfg::out(0) + cs * M + i] = -kneg[i];
  }
  if (lane < N) sc[Cfg::out(1) + cs * N + lane] = v;
  float atg = jac[ro] * vec[0];
#pragma unroll
  for (int k = 1; k < N; ++k) atg += jac[k * N + ro] * vec[k];
  float kth = kk[ro] * h[0];
#pragma unroll
  for (int k = 1; k < M; ++k) kth += kk[k * N + ro] * h[k];
  v = qe[ro] + atg + kth;
}

// One backward edge of the thread design (n < kGramN): the recursion of one
// lane in registers, every operand from the chunk buffer.
template <class Model>
__device__ __forceinline__ void bwd_thread_stage(const float* buf, int cs,
                                                 float d, float sdi,
                                                 float (&v)[Model::N],
                                                 float* sc) {
  using Cfg = SolveCfg<Model, true>;
  constexpr int N = Model::N, M = Model::M, NS = Cfg::NS;
  float Lf[N][N], Lg[M][M], K[M][N], A[N][N], Bm[N][M];
  load_symm<N>(buf + Cfg::part(kBwdLf) + cs * NS, Lf);
  load_smat<M, M>(buf + Cfg::part(kBwdLg) + cs * M * M, Lg);
  load_smat<M, N>(buf + Cfg::part(kBwdK) + cs * M * N, K);
  load_smat<N, N>(buf + Cfg::part(kBwdA) + cs * N * N, A);
  load_smat<N, M>(buf + Cfg::part(kBwdB) + cs * N * M, Bm);
  const float* qe = buf + Cfg::part(kBwdQ) + cs * N;
  const float* c1 = buf + Cfg::part(kBwdC) + cs * N;
  const float* re = buf + Cfg::part(kBwdR) + cs * M;

  float fh[N], finv_fh[N], gg[N];
#pragma unroll
  for (int i = 0; i < N; ++i) fh[i] = sdi * (d * v[i] - c1[i]);
  cho_solve_rcp<N>(Lf, fh, finv_fh);
#pragma unroll
  for (int i = 0; i < N; ++i) gg[i] = v[i] - sdi * (fh[i] - finv_fh[i]);

  float h[M], kneg[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = Bm[0][i] * gg[0];
#pragma unroll
    for (int k = 1; k < N; ++k) s += Bm[k][i] * gg[k];
    h[i] = re[i] + s;
  }
  cho_solve_rcp<M>(Lg, h, kneg);
#pragma unroll
  for (int i = 0; i < M; ++i) sc[Cfg::out(0) + cs * M + i] = -kneg[i];
#pragma unroll
  for (int i = 0; i < N; ++i) sc[Cfg::out(1) + cs * N + i] = v[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float atg = A[0][i] * gg[0];
#pragma unroll
    for (int k = 1; k < N; ++k) atg += A[k][i] * gg[k];
    float kth = K[0][i] * h[0];
#pragma unroll
    for (int k = 1; k < M; ++k) kth += K[k][i] * h[k];
    v[i] = qe[i] + atg + kth;
  }
}

// Backward vector pass per edge e = T-1 .. 0, carrying v of the child node
// (reference: lqr.cpp:746-795): fh = d^-1/2 (d v - c_{e+1}), g = v - d^-1/2
// (fh - F^-1 fh) through the child's F_chol, h = r_e + B^T g, k = -G^-1 h,
// v_parent = q_e + A^T g + K^T h.  At the end, the root solve
// (lqr.cpp:798-819): x_0 = -(I + d V_0)^-1 (d v_0 - c_0), y_0 = v_0 + V_0
// x_0; a failed Cholesky surfaces as NaN in x_root.  Inputs: q, c [B, T+1,
// N], r [B, T, M], delta [B], the factor's products, and the iterate x, u
// (read for A and B at n >= kGramN).  Outputs: k [T, M, B], v of the child
// node [T, N, B], x_root and y_root [N, B].  Per chunk of C edges, walked
// backward: the block waits for the chunk's copies, evaluates its dyn_jac
// slots (team design), starts the next chunk's copies, runs the recursion
// (team design: a team per scenario; thread design: lane 0 of each team)
// and writes the staged outputs.
template <class Model>
__global__ void __launch_bounds__(SolveCfg<Model, true>::kBlock,
                                  SolveCfg<Model, true>::kMinBlocks)
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
  using Cfg = SolveCfg<Model, true>;
  constexpr int T = Model::T, N = Model::N, M = Model::M, C = Cfg::C,
                L = Cfg::L, NS = Cfg::NS, K = T / C;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, lane = threadIdx.x % L;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b0 = blockIdx.x * Cfg::S, b = b0 + team;
  const bool valid = b < B;
  const float d = valid ? delta[b] : 1.0f;
  const float sdi = rsqrtf(d);
  const int ro = lane < N ? lane : 0;
  float* sc = smem + team * Cfg::P;
  const size_t node = static_cast<size_t>(T + 1) * N,
               edge = static_cast<size_t>(T) * M;

  // one group of copies: chunk f (edges e_lo .. e_lo + C - 1) into buffer
  // f % kSolveRing, for f = K the root solve's V_root and c_0, past it none
  auto fetch = [&](int f) {
    const int e_lo = T - (f + 1) * C, o = (f % kSolveRing) * Cfg::kBuf;
    if (f > K) {
      cp_async_commit();
      return;
    }
    if (f == K) {
      copy_rows<Cfg>(smem, o, vroot, 0, NS, NS, b0, B);
      copy_runs<Cfg>(smem, o + align4(NS), c, node, N, b0, B);
      cp_async_commit();
      return;
    }
    copy_rows<Cfg>(smem, o + Cfg::part(kBwdLf), fc, e_lo, NS, C * NS, b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kBwdLg), g, e_lo, M * M, C * M * M,
                   b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kBwdK), kg, e_lo, M * N, C * M * N,
                   b0, B);
    if constexpr (Cfg::kTeam) {
      copy_runs<Cfg>(smem, o + Cfg::part(kBwdX), x + e_lo * N, node, C * N,
                     b0, B);
      copy_runs<Cfg>(smem, o + Cfg::part(kBwdU), u + e_lo * M, edge, C * M,
                     b0, B);
    } else {
      copy_rows<Cfg>(smem, o + Cfg::part(kBwdA), a, e_lo, N * N, C * N * N,
                     b0, B);
      copy_rows<Cfg>(smem, o + Cfg::part(kBwdB), bm, e_lo, N * M, C * N * M,
                     b0, B);
    }
    copy_runs<Cfg>(smem, o + Cfg::part(kBwdQ), q + e_lo * N, node, C * N, b0,
                   B);
    copy_runs<Cfg>(smem, o + Cfg::part(kBwdC), c + (e_lo + 1) * N, node,
                   C * N, b0, B);
    copy_runs<Cfg>(smem, o + Cfg::part(kBwdR), r + e_lo * M, edge, C * M, b0,
                   B);
    cp_async_commit();
  };

  // q_T, the carry's start, into the ring's last buffer with chunk 0
  constexpr int kStart = (kSolveRing - 1) * Cfg::kBuf;
  copy_runs<Cfg>(smem, kStart, q + T * N, node, N, b0, B);
#pragma unroll 1
  for (int f = 0; f < kSolveRing - 1; ++f) fetch(f);
  cp_async_wait<kSolveRing - 2>();
  __syncthreads();
  // the carry v (team design: lane r's entry; thread design: all N)
  float v[Cfg::kTeam ? 1 : N];
  if constexpr (Cfg::kTeam) {
    v[0] = sc[kStart + ro];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = sc[kStart + i];
  }

#pragma unroll 1
  for (int kc = 0; kc < K; ++kc) {
    const int e_lo = T - (kc + 1) * C, o = (kc % kSolveRing) * Cfg::kBuf;
    const float* buf = sc + o;
    cp_async_wait<kSolveRing - 2>();
    __syncthreads();  // the chunk has landed; the last one's outputs are out
    if constexpr (Cfg::kTeam) {
      produce_jac<Model, Cfg, kBwdX, kBwdU>(smem, o, e_lo);
      __syncthreads();
    }
    fetch(kc + kSolveRing - 1);  // into the buffer the last chunk freed
    if constexpr (Cfg::kTeam) {
#pragma unroll 1
      for (int cs = C - 1; cs >= 0; --cs)
        bwd_team_stage<Model>(buf, sc + Cfg::kSlots + cs * Cfg::JAC, cs,
                              lane, mask, d, sdi, v[0], sc);
    } else if (lane == 0 && valid) {
#pragma unroll 1
      for (int cs = C - 1; cs >= 0; --cs)
        bwd_thread_stage<Model>(buf, cs, d, sdi, v, sc);
    }
    __syncthreads();
    write_rows<Cfg>(k_out, e_lo, M, C * M, smem + Cfg::out(0), b0, B);
    write_rows<Cfg>(v_out, e_lo, N, C * N, smem + Cfg::out(1), b0, B);
  }

  // the root solve; x_root and y_root staged in the last chunk's buffer
  cp_async_wait<0>();
  __syncthreads();
  const float* vr = sc + (K % kSolveRing) * Cfg::kBuf;
  const float* c0 = vr + align4(NS);
  constexpr int kRoots = ((K - 1) % kSolveRing) * Cfg::kBuf;
  float* roots = sc + kRoots;
  if constexpr (Cfg::kTeam) {
    float vrow[N], xv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) vrow[j] = sym_at<N>(vr, ro, j);
    float* lfr = sc + Cfg::kSlots;
    team_chol<N, L>(vrow, d, lane, mask, lfr);
    const float xr =
        -team_cho_solve<N, L>(lfr, d * v[0] - c0[ro], lane, mask);
    float* vec = sc + Cfg::kVec;
    __syncwarp(mask);
    if (lane < N) vec[lane] = xr;
    __syncwarp(mask);
    load_col<N>(vec, xv);
    float s = vrow[0] * xv[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += vrow[j] * xv[j];
    if (lane < N) {
      roots[lane] = xr;
      roots[N + lane] = v[0] + s;
    }
  } else if (lane == 0 && valid) {
    float Vr[N][N], Fr[N][N], Lfr[N][N], fr[N], sol[N], xr[N];
    load_symm<N>(vr, Vr);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        Fr[i][j] = d * Vr[i][j] + (i == j ? 1.0f : 0.0f);
      fr[i] = d * v[i] - c0[i];
    }
    riccati::chol<N>(Fr, Lfr);
    cho_solve_rcp<N>(Lfr, fr, sol);
#pragma unroll
    for (int i = 0; i < N; ++i) xr[i] = -sol[i];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = Vr[i][0] * xr[0];
#pragma unroll
      for (int j = 1; j < N; ++j) s += Vr[i][j] * xr[j];
      roots[i] = xr[i];
      roots[N + i] = v[i] + s;
    }
  }
  __syncthreads();
  write_rows<Cfg>(xr_out, 0, N, N, smem + kRoots, b0, B);
  write_rows<Cfg>(yr_out, 0, N, N, smem + kRoots + N, b0, B);
}

// One forward edge of the team design, the parent's x in `vec`: u = k + K x
// summed over the team, lane r's row of A x + B u (its row of A read from
// its own diagonal on, so that the team's lanes read distinct banks), the
// team's solve through F_chol, then the child's x through `vec` for y = v +
// V_child x_child.
template <class Model>
__device__ __forceinline__ void fwd_team_stage(const float* buf,
                                               const float* jac, int cs,
                                               int lane, unsigned mask,
                                               float d, float sd, float sdi,
                                               float* sc) {
  using Cfg = SolveCfg<Model, false>;
  constexpr int N = Model::N, M = Model::M, L = Cfg::L, NS = Cfg::NS;
  const int ro = lane < N ? lane : 0;
  const float* kvp = buf + Cfg::part(kFwdKv) + cs * M;
  const float* kk = buf + Cfg::part(kFwdK) + cs * M * N;
  const float* vvp = buf + Cfg::part(kFwdV) + cs * N;
  const float* vcp = buf + Cfg::part(kFwdVc) + cs * NS;
  const float* lf = buf + Cfg::part(kFwdLf) + cs * NS;
  const float* c1 = buf + Cfg::part(kFwdC) + cs * N;
  const float* aj = jac + ro * N;
  const float* bj = jac + N * N + ro * M;
  float* vec = sc + Cfg::kVec;
  float xv[N], uu[M];
  const float xo = vec[ro];
#pragma unroll
  for (int i = 0; i < M; ++i) uu[i] = lane < N ? kk[i * N + ro] * xo : 0.0f;
  team_sum<M, L>(uu, mask);
#pragma unroll
  for (int i = 0; i < M; ++i) uu[i] += kvp[i];
  float ax = aj[ro] * xo;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const int jr = ro + j < N ? ro + j : ro + j - N;
    ax += aj[jr] * vec[jr];
  }
  float bu = bj[0] * uu[0];
#pragma unroll
  for (int j = 1; j < M; ++j) bu += bj[j] * uu[j];
  const float rhs = sdi * (c1[ro] - d * vvp[ro] + ax + bu);
  const float xc = sd * team_cho_solve<N, L>(lf, rhs, lane, mask);
  __syncwarp(mask);
  if (lane < N) vec[lane] = xc;
  __syncwarp(mask);
  load_col<N>(vec, xv);
  float s = sym_at<N>(vcp, ro, 0) * xv[0];
#pragma unroll
  for (int j = 1; j < N; ++j) s += sym_at<N>(vcp, ro, j) * xv[j];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) sc[Cfg::out(0) + cs * M + i] = uu[i];
  }
  if (lane < N) {
    sc[Cfg::out(1) + cs * N + lane] = xc;
    sc[Cfg::out(2) + cs * N + lane] = vvp[ro] + s;
  }
}

// One forward edge of the thread design: one lane's recursion in registers.
template <class Model>
__device__ __forceinline__ void fwd_thread_stage(const float* buf, int cs,
                                                 float d, float sd,
                                                 float sdi,
                                                 float (&xp)[Model::N],
                                                 float* sc) {
  using Cfg = SolveCfg<Model, false>;
  constexpr int N = Model::N, M = Model::M, NS = Cfg::NS;
  float K[M][N], A[N][N], Bm[N][M], Vc[N][N], Lf[N][N];
  load_smat<M, N>(buf + Cfg::part(kFwdK) + cs * M * N, K);
  load_smat<N, N>(buf + Cfg::part(kFwdA) + cs * N * N, A);
  load_smat<N, M>(buf + Cfg::part(kFwdB) + cs * N * M, Bm);
  load_symm<N>(buf + Cfg::part(kFwdVc) + cs * NS, Vc);
  load_symm<N>(buf + Cfg::part(kFwdLf) + cs * NS, Lf);
  const float* kvp = buf + Cfg::part(kFwdKv) + cs * M;
  const float* vvp = buf + Cfg::part(kFwdV) + cs * N;
  const float* c1 = buf + Cfg::part(kFwdC) + cs * N;

  float uu[M], rhs[N], xs[N], xc[N];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = K[i][0] * xp[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += K[i][j] * xp[j];
    uu[i] = kvp[i] + s;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ax = A[i][0] * xp[0];
#pragma unroll
    for (int j = 1; j < N; ++j) ax += A[i][j] * xp[j];
    float bu = Bm[i][0] * uu[0];
#pragma unroll
    for (int j = 1; j < M; ++j) bu += Bm[i][j] * uu[j];
    rhs[i] = sdi * (c1[i] - d * vvp[i] + ax + bu);
  }
  cho_solve_rcp<N>(Lf, rhs, xs);
#pragma unroll
  for (int i = 0; i < N; ++i) xc[i] = sd * xs[i];
#pragma unroll
  for (int i = 0; i < M; ++i) sc[Cfg::out(0) + cs * M + i] = uu[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Vc[i][0] * xc[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += Vc[i][j] * xc[j];
    sc[Cfg::out(1) + cs * N + i] = xc[i];
    sc[Cfg::out(2) + cs * N + i] = vvp[i] + s;
    xp[i] = xc[i];
  }
}

// Forward rollout per edge e = 0 .. T-1, carrying x of the parent node
// (reference: lqr.cpp:821-870): u = k + K x, x_child = (I + d V)^-1 (A x +
// B u + c - d v) through F_chol, y = v + V x_child.  Writes the Newton
// direction in the port's layout: du [B, T, M], dx and dy [B, T+1, N], the
// root rows (x_root, y_root) included.  Chunks of C edges, walked forward,
// as in solve_bwd_kernel; the outputs are staged per chunk and written by
// the block, a scenario's rows of a chunk being contiguous.
template <class Model>
__global__ void __launch_bounds__(SolveCfg<Model, false>::kBlock,
                                  SolveCfg<Model, false>::kMinBlocks)
solve_fwd_kernel(int B, const float* __restrict__ xr,
                 const float* __restrict__ yr, const float* __restrict__ kv,
                 const float* __restrict__ kg, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ x,
                 const float* __restrict__ u, const float* __restrict__ c,
                 const float* __restrict__ delta,
                 const float* __restrict__ vv, const float* __restrict__ vc,
                 const float* __restrict__ fc, float* __restrict__ du,
                 float* __restrict__ dx, float* __restrict__ dy) {
  using Cfg = SolveCfg<Model, false>;
  constexpr int T = Model::T, N = Model::N, M = Model::M, C = Cfg::C,
                L = Cfg::L, NS = Cfg::NS, K = T / C;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, lane = threadIdx.x % L;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b0 = blockIdx.x * Cfg::S, b = b0 + team;
  const bool valid = b < B;
  const float d = valid ? delta[b] : 1.0f;
  const float sd = sqrtf(d);
  const float sdi = 1.0f / sd;
  const int ro = lane < N ? lane : 0;
  float* sc = smem + team * Cfg::P;
  const size_t node = static_cast<size_t>(T + 1) * N,
               edge = static_cast<size_t>(T) * M;

  // one group of copies: chunk f (edges e_lo .. e_lo + C - 1) into buffer
  // f % kSolveRing, past the last chunk none
  auto fetch = [&](int f) {
    const int e_lo = f * C, o = (f % kSolveRing) * Cfg::kBuf;
    if (f >= K) {
      cp_async_commit();
      return;
    }
    copy_rows<Cfg>(smem, o + Cfg::part(kFwdKv), kv, e_lo, M, C * M, b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kFwdK), kg, e_lo, M * N, C * M * N,
                   b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kFwdV), vv, e_lo, N, C * N, b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kFwdVc), vc, e_lo, NS, C * NS, b0, B);
    copy_rows<Cfg>(smem, o + Cfg::part(kFwdLf), fc, e_lo, NS, C * NS, b0, B);
    if constexpr (Cfg::kTeam) {
      copy_runs<Cfg>(smem, o + Cfg::part(kFwdX), x + e_lo * N, node, C * N,
                     b0, B);
      copy_runs<Cfg>(smem, o + Cfg::part(kFwdU), u + e_lo * M, edge, C * M,
                     b0, B);
    } else {
      copy_rows<Cfg>(smem, o + Cfg::part(kFwdA), a, e_lo, N * N, C * N * N,
                     b0, B);
      copy_rows<Cfg>(smem, o + Cfg::part(kFwdB), bm, e_lo, N * M, C * N * M,
                     b0, B);
    }
    copy_runs<Cfg>(smem, o + Cfg::part(kFwdC), c + (e_lo + 1) * N, node,
                   C * N, b0, B);
    cp_async_commit();
  };

  // x_root and y_root, the carry's start, into the ring's last buffer with
  // chunk 0
  constexpr int kStart = (kSolveRing - 1) * Cfg::kBuf;
  copy_rows<Cfg>(smem, kStart, xr, 0, N, N, b0, B);
  copy_rows<Cfg>(smem, kStart + align4(N), yr, 0, N, N, b0, B);
#pragma unroll 1
  for (int f = 0; f < kSolveRing - 1; ++f) fetch(f);
  cp_async_wait<kSolveRing - 2>();
  __syncthreads();
  write_runs<Cfg>(dx, node, N, smem + kStart, b0, B);  // the root rows
  write_runs<Cfg>(dy, node, N, smem + kStart + align4(N), b0, B);
  // the carry x (team design: the team's vec; thread design: registers)
  float xp[Cfg::kTeam ? 1 : N];
  if constexpr (Cfg::kTeam) {
    if (lane < N) sc[Cfg::kVec + lane] = sc[kStart + lane];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) xp[i] = sc[kStart + i];
  }

#pragma unroll 1
  for (int kc = 0; kc < K; ++kc) {
    const int e_lo = kc * C, o = (kc % kSolveRing) * Cfg::kBuf;
    const float* buf = sc + o;
    cp_async_wait<kSolveRing - 2>();
    __syncthreads();  // the chunk has landed; the last one's outputs are out
    if constexpr (Cfg::kTeam) {
      produce_jac<Model, Cfg, kFwdX, kFwdU>(smem, o, e_lo);
      __syncthreads();
    }
    fetch(kc + kSolveRing - 1);  // into the buffer the last chunk freed
    if constexpr (Cfg::kTeam) {
#pragma unroll 1
      for (int cs = 0; cs < C; ++cs)
        fwd_team_stage<Model>(buf, sc + Cfg::kSlots + cs * Cfg::JAC, cs,
                              lane, mask, d, sd, sdi, sc);
    } else if (lane == 0 && valid) {
#pragma unroll 1
      for (int cs = 0; cs < C; ++cs)
        fwd_thread_stage<Model>(buf, cs, d, sd, sdi, xp, sc);
    }
    __syncthreads();
    write_runs<Cfg>(du + e_lo * M, edge, C * M, smem + Cfg::out(0), b0, B);
    write_runs<Cfg>(dx + (e_lo + 1) * N, node, C * N, smem + Cfg::out(1), b0,
                    B);
    write_runs<Cfg>(dy + (e_lo + 1) * N, node, C * N, smem + Cfg::out(2), b0,
                    B);
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

template <class Cfg>
void block_config(int B, int smem, int* out) {
  out[0] = (B + Cfg::S - 1) / Cfg::S;
  out[1] = Cfg::kBlock;
  out[2] = smem;
}

// The launch configuration of kernel `which` (0 factor, 1 solve_bwd, 2
// solve_fwd, 3 eval) at batch B: grid, block, dynamic shared memory bytes.
template <class Model>
void launch_config(int which, int B, int* out) {
  using Bwd = SolveCfg<Model, true>;
  using Fwd = SolveCfg<Model, false>;
  if (which == 0) {
    block_config<FactorCfg<Model>>(B, FactorCfg<Model>::kSmem, out);
  } else if (which == 1) {
    block_config<Bwd>(B, Bwd::kSmem, out);
  } else if (which == 2) {
    block_config<Fwd>(B, Fwd::kSmem, out);
  } else {
    out[0] = (B + kEvalScen - 1) / kEvalScen;
    out[1] = kEvalLanes * kEvalScen;
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
  using Cfg = SolveCfg<Model, true>;
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &solve_bwd_kernel<Model>;
  const cudaError_t err = solve_attributes<Cfg>(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + Cfg::S - 1) / Cfg::S, Cfg::kBlock, Cfg::kSmem,
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
  using Cfg = SolveCfg<Model, false>;
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = &solve_fwd_kernel<Model>;
  const cudaError_t err = solve_attributes<Cfg>(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + Cfg::S - 1) / Cfg::S, Cfg::kBlock, Cfg::kSmem,
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
