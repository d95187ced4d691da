// Chain-Riccati kernels for Hopper (sm_90a): factor, backward vector pass,
// forward rollout.
//
// Replaces the TPU kernels of sip_optimal_control_tpu/ops/pallas_riccati.py:
//   riccati_factor_f32       <- _factor_kernel       (explicit-W form, n < 8)
//   riccati_factor_gram_f32  <- _factor_kernel_gram  (Gram form, n >= 8)
//   riccati_solve_bwd_f32    <- _solve_bwd_kernel
//   riccati_solve_fwd_f32    <- _solve_fwd_kernel
// and computes exactly what they compute (per-row delta with delta <= 0
// replaced by 1, W f through two triangular solves with F_chol).  The plain
// PyTorch twins live in ops/riccati_cuda.py.  The TPU kernels put 1024
// scenarios on the vector lanes of one block and walk the horizon as a
// sequential grid axis, carrying V (or v, x) in VMEM scratch.  Here the
// horizon loop runs inside a kernel, the carry in registers, and a bounds
// check b < B takes the place of the TPU's padding to a multiple of 1024.
// The kernels allocate nothing and launch on the caller's stream.
//
// Two designs.
//   - factor_kernel and solve_fwd_kernel: one thread owns a scenario and
//     unrolls the tiny n x n algebra in registers (riccati_tiny.cuh).
//     Operands arrive in a structure-of-arrays layout [stage, entry,
//     scenario] with the scenario index contiguous, so the 32 threads of a
//     warp read 128 contiguous bytes per matrix entry; the wrappers
//     transpose in and out.  At the main path's batch of 4096 scenarios
//     there are only 32 blocks of 128 threads for 132 SMs, and each thread
//     runs a dependent chain of T stages whose operands it loads entry by
//     entry: latency-bound.  The same redesign as below is later work.
//   - factor_gram_kernel and solve_bwd_kernel: they read and write the
//     solver's own [B, stage, rows] tensors, where a scenario's stage block
//     (A_e: 1 KB at n = 16) is contiguous.  A block holds kScenarios
//     scenarios, each owned by a team of L lanes of one warp at n >= 8
//     (team.cuh's primitives, shared with the fused kernels) and by one lane
//     of a team of 4 below (its other lanes copy); 256 blocks at B = 4096,
//     two per SM (32 scenarios per SM: one wave on 132 SMs, the block's
//     shared memory its share, team::solve_smem).  Each team copies its
//     scenario's stage operands with cp.async into a ring of stage buffers
//     in shared memory, a stage (the factor) or several (solve_bwd, as many
//     as the share holds) ahead, and writes its outputs itself; the teams
//     never wait for each other (no block barrier).
//       factor (Gram form, pallas_riccati.py::_gram_core): lane r holds row
//       r of V; F = I + sd V sd and its Cholesky column by column over the
//       team (team_chol); [A B] scaled by sdi and turned into columns in
//       place (team_scale_columns); then team_gram_step: one column of Z =
//       Lf^-1 [Ah Bh] per lane, G's upper entries strided over the team, H
//       and K by columns, V_parent by rows as the (min, max) entry, so that
//       V_parent is exactly symmetric and lane r writes column r of it
//       (consecutive lanes on consecutive addresses).  The ring holds A, B,
//       M, R and delta of two stages; Q_e, read last, has one buffer,
//       refilled once V_parent is formed and waited for after the Cholesky.
//       solve_bwd (team design): lane r carries v_r; F^-1 fh through the
//       child's F_chol by team_cho_solve (rows at a padded stride, on
//       distinct banks), B^T g and K^T h by xor butterflies and the shared
//       g.  Below n = 8 one lane runs the recursion in registers.
//
// What bounds them on an H100 (PERF.md §6): each team's dependent chain per
// stage (n Cholesky columns, each a shuffle and a warp barrier, and the
// n-step triangular solves of the factor; 2n shuffled substitution steps
// of the backward pass), with 32 scenarios per SM to hide one another's;
// none of the four reaches the device memory's rate.
#include <cuda_runtime.h>

#include "riccati_tiny.cuh"
#include "team.cuh"

namespace riccati {

using team::align4;
using team::block_stride;
using team::cp_async_commit;
using team::cp_async_wait;
using team::kMaxSmem;
using team::solve_smem;
using team::team_cho_solve;
using team::team_chol;
using team::team_copy;
using team::team_gram_step;
using team::team_mask;
using team::team_scale_columns;
using team::team_sum;

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

// ---------------------------------------------------------------------------
// the team kernels: factor_gram_kernel and solve_bwd_kernel
// ---------------------------------------------------------------------------

constexpr int kGramN = 8;  // ops/riccati_cuda.py: GRAM_N
constexpr int kScenarios = 16;   // scenarios per block
constexpr int kThreadLanes = 4;  // lanes of a team below kGramN
constexpr int kMaxRing = 8;      // the most stages of solve_bwd's ring

// Lanes per scenario: a team of the smallest power of two >= n from 8 up
// (n >= kGramN), else kThreadLanes (one lane computes, the others copy).
__host__ __device__ constexpr int team_lanes(int n) {
  return n < kGramN ? kThreadLanes : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// Scenarios per block: kScenarios, halved while a block of scenarios at
// stride p floats exceeds a block's shared memory, down to one warp's worth.
__host__ __device__ constexpr int fit_scenarios(int l, int p) {
  int s = kScenarios;
  while (s > 32 / l && 4 * s * p > kMaxSmem) s /= 2;
  return s;
}

// Blocks that share an SM: the one-wave share kScenariosPerSM / s (at least
// one), fewer where the shared memory does not fit; the register cap
// follows.
__host__ __device__ constexpr int blocks_per_sm(int s, int smem) {
  int k = team::kScenariosPerSM / s > 1 ? team::kScenariosPerSM / s : 1;
  while (k > 1 && k * (smem + 1024) > team::kSmemPerSM) --k;
  return k;
}

// The Gram factor's shared-memory map per scenario (stride P floats,
// regions at multiples of 4 floats):
//   ring  two stage buffers: A [N][N] and B [N][M] (contiguous, then [Ah Bh]
//         by columns), M [N][M], R [M][M], delta_{e+1} [N]
//   q     Q_e [N][N]
//   sd    sqrt(delta_{e+1}), sdi its reciprocal [N] each
//   lf    Lf lower-packed (team::sym_row)
//   k, g  the stage's K [M][N] and G_chol [M][M], written out by the team
//   scr   team_gram_step's Z [N + M][N], H [N][M], G [M][M]
template <int N, int M>
struct GramCfg {
  static constexpr int L = team_lanes(N);
  static constexpr int NN = N * N, NM = N * M, MM = M * M;
  static constexpr int kM = align4(NN + NM), kR = kM + align4(NM),
                       kD = kR + align4(MM), kStage = kD + align4(N);
  static constexpr int kQ = 2 * kStage, kSd = kQ + align4(NN),
                       kSdi = kSd + align4(N), kLf = kSdi + align4(N),
                       kK = kLf + align4(N * (N + 1) / 2),
                       kG = kK + align4(NM), kScr = kG + align4(MM);
  static constexpr int kUsed = kScr + (N + M) * N + NM + MM;
  static constexpr int P = block_stride(true, kUsed);
  static constexpr int S = fit_scenarios(L, P), kBlock = L * S;
  static constexpr int kSmem = 4 * S * P;
  static constexpr int kMinBlocks = blocks_per_sm(S, kSmem);
  static_assert(N >= kGramN && N <= 32, "a team holds at most a warp");
  static_assert(kSmem <= kMaxSmem, "the factor's shared memory exceeds a "
                "block's");
};

// solve_bwd's stage buffer per scenario: F_chol_{e+1} rows at stride kLd,
// G_chol_e, K_e, A_e, B_e, r_e, q_e, c_{e+1}, delta_{e+1}; a ring of D of
// them, then (team design) the exchanged vector g [N].
template <int N, int M>
struct BwdCfg {
  static constexpr bool kTeam = N >= kGramN;
  static constexpr int L = team_lanes(N);
  static constexpr int kLd = kTeam ? N + 4 : N;
  static constexpr int kLf = 0, kLg = align4(N * kLd),
                       kK = kLg + align4(M * M), kA = kK + align4(M * N),
                       kB = kA + align4(N * N), kR = kB + align4(N * M),
                       kQ = kR + align4(M), kC = kQ + align4(N),
                       kD = kC + align4(N), kStage = kD + align4(N);
  static constexpr int kExtra = kTeam ? align4(N) : 0;
  static constexpr int S = fit_scenarios(
      L, block_stride(true, 2 * kStage + kExtra)), kBlock = L * S;
  __host__ __device__ static constexpr int smem_for(int d) {
    return 4 * S * block_stride(true, d * kStage + kExtra);
  }
  // the deepest ring within the block's share of the SM, 2 at least
  __host__ __device__ static constexpr int ring() {
    int d = kMaxRing;
    while (d > 2 && smem_for(d) > solve_smem(S)) --d;
    return d;
  }
  static constexpr int D = ring();
  static constexpr int kVec = D * kStage;
  static constexpr int P = block_stride(true, kVec + kExtra);
  static constexpr int kSmem = 4 * S * P;
  static constexpr int kMinBlocks = blocks_per_sm(S, kSmem);
  static_assert(N <= 32, "a team holds at most a warp");
  static_assert(kSmem <= kMaxSmem, "solve_bwd's shared memory exceeds a "
                "block's");
};

// Gram-form backward factorization over edges e = T-1 .. 0 (team design,
// n >= kGramN), carrying V of the child node: per edge, F = I + sd V sd with
// sd = sqrt(delta_{e+1}), Lf = chol(F), and the Gram-form step by the team
// (team_gram_step): G = sym(R) + Bh^T Bh - Zb^T Zb, G_chol, H = M^T + Bh^T Ah -
// Zb^T Za, K = -G^-1 H, V_parent = sym(Q_e) + Ah^T Ah - Za^T Za + K^T H.  No
// W, F^-1 or W A is formed; W is recomputed outside from F_chol when a
// caller needs it (pallas_riccati.py:403-409).  Inputs [B, stage, ...]: Q
// [T+1, n, n], delta [T+1, n], A [T, n, n], Bm, Mm [T, n, m], R [T, m, m].
// Outputs [B, T, ...]: V of the parent node [n, n], K [m, n], G_chol [m, m].
template <int N, int M>
__global__ void __launch_bounds__(GramCfg<N, M>::kBlock,
                                  GramCfg<N, M>::kMinBlocks)
factor_gram_kernel(int T, int B, const float* __restrict__ Q,
                   const float* __restrict__ delta,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Mm, const float* __restrict__ R,
                   float* __restrict__ v_out, float* __restrict__ k_out,
                   float* __restrict__ g_out) {
  using Cfg = GramCfg<N, M>;
  constexpr int L = Cfg::L, NN = N * N, NM = N * M, MM = M * M;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, r = threadIdx.x % L, ro = r < N ? r : 0;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b = blockIdx.x * Cfg::S + team;
  const bool valid = b < B;
  // a team past the batch runs scenario 0 and writes nothing
  const size_t bv = valid ? b : 0;
  const float* qb = Q + bv * (T + 1) * NN;
  const float* db = delta + bv * (T + 1) * N;
  const float* ab = A + bv * T * NN;
  const float* bb = Bm + bv * T * NM;
  const float* mb = Mm + bv * T * NM;
  const float* rb = R + bv * T * MM;
  float* sc = smem + team * Cfg::P;
  float* qs = sc + Cfg::kQ;
  float* sd = sc + Cfg::kSd;
  float* sdi = sc + Cfg::kSdi;
  float* lf = sc + Cfg::kLf;
  float* kk = sc + Cfg::kK;
  float* g = sc + Cfg::kG;

  // one group of copies each: edge e's A, B, M, R and delta_{e+1} into ring
  // buffer (T - 1 - e) & 1; Q_e into its buffer; none past edge 0
  auto fetch = [&](int e) {
    if (e >= 0) {
      float* st = sc + ((T - 1 - e) & 1) * Cfg::kStage;
      team_copy<L, 1, NN>(st, ab + e * NN, r);
      team_copy<L, 1, NM>(st + NN, bb + e * NM, r);
      team_copy<L, 1, NM>(st + Cfg::kM, mb + e * NM, r);
      team_copy<L, 1, MM>(st + Cfg::kR, rb + e * MM, r);
      team_copy<L, 1, N>(st + Cfg::kD, db + (e + 1) * N, r);
    }
    cp_async_commit();
  };
  auto fetch_q = [&](int e) {
    if (e >= 0) team_copy<L, 1, NN>(qs, qb + e * NN, r);
    cp_async_commit();
  };

  float vrow[N];  // the carry: row r of V, from Q_T
#pragma unroll
  for (int j = 0; j < N; ++j) vrow[j] = qb[T * NN + ro * N + j];
  fetch(T - 1);
  fetch_q(T - 1);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;  // edge e: parent node e, child node e + 1
    float* st = sc + (t & 1) * Cfg::kStage;
    fetch(e - 1);  // into the buffer the last edge freed
    cp_async_wait<2>();  // this edge's ring buffer (Q_e may be in flight)
    __syncwarp(mask);
    if (r < N) {
      const float dl = st[Cfg::kD + r];
      const float s = sqrtf(dl > 0.0f ? dl : 1.0f);
      sd[r] = s;
      sdi[r] = 1.0f / s;
    }
    __syncwarp(mask);
    float frow[N];  // row r of F - I, in the twin's order
    const float sr = sd[ro];
#pragma unroll
    for (int j = 0; j < N; ++j) frow[j] = sr * vrow[j] * sd[j];
    team_chol<N, L>(frow, 1.0f, r, mask, lf);
    team_scale_columns<N, M, L>(st, [&](int k) { return sdi[k]; }, r, mask);
    cp_async_wait<1>();  // Q_e
    __syncwarp(mask);
    const float* me = st + Cfg::kM;
    const float* re = st + Cfg::kR;
    team_gram_step<N, M, L>(
        st, [&](int i, int j) { return qs[i * N + j]; },
        [&](int i, int j) { return re[i * M + j]; },
        [&](int i, int j) { return me[i * M + j]; }, r, mask, lf, kk, g,
        sc + Cfg::kScr, vrow);
    __syncwarp(mask);  // the team is done with this edge's buffers
    fetch_q(e - 1);
    if (valid) {
      const size_t o = bv * T + e;
      // V_parent is exactly symmetric: lane r's row is column r
      if (r < N) {
#pragma unroll
        for (int j = 0; j < N; ++j) v_out[o * NN + j * N + r] = vrow[j];
      }
      for (int f = r; f < NM; f += L) k_out[o * NM + f] = kk[f];
      for (int f = r; f < MM; f += L) g_out[o * MM + f] = g[f];
    }
  }
  cp_async_wait<0>();
}

// One backward edge of solve_bwd's team design, lane r carrying v_r of the
// child node, the edge's operands in stage buffer `st`; returns v_r of the
// parent node and leaves k in every lane's kneg (negated).
template <int N, int M>
__device__ __forceinline__ float bwd_team_edge(const float* st, float* vec,
                                               float v, int lane,
                                               unsigned mask,
                                               float (&kneg)[M]) {
  using Cfg = BwdCfg<N, M>;
  constexpr int L = Cfg::L;
  const int ro = lane < N ? lane : 0;
  const float dl = st[Cfg::kD + ro];
  const float sdi = 1.0f / sqrtf(dl > 0.0f ? dl : 1.0f);
  const float fh = sdi * (dl * v - st[Cfg::kC + ro]);
  const float gg =
      v - sdi * (fh - team_cho_solve<N, L, Cfg::kLd>(st + Cfg::kLf, fh, lane,
                                                     mask));
  if (lane < N) vec[lane] = gg;
  __syncwarp(mask);
  const float* bj = st + Cfg::kB + ro * M;
  float h[M], Lg[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) h[i] = lane < N ? bj[i] * gg : 0.0f;
  team_sum<M, L>(h, mask);
#pragma unroll
  for (int i = 0; i < M; ++i) h[i] += st[Cfg::kR + i];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Lg[i][j] = st[Cfg::kLg + i * M + j];
  cho_solve_rcp<M>(Lg, h, kneg);
  const float* a = st + Cfg::kA;
  const float* kk = st + Cfg::kK;
  float atg = a[ro] * vec[0];
#pragma unroll
  for (int k = 1; k < N; ++k) atg += a[k * N + ro] * vec[k];
  float kth = kk[ro] * h[0];
#pragma unroll
  for (int k = 1; k < M; ++k) kth += kk[k * N + ro] * h[k];
  return st[Cfg::kQ + ro] + atg + kth;
}

// One backward edge of solve_bwd's thread design (n < kGramN): the
// recursion of one lane in registers, every operand from stage buffer `st`.
template <int N, int M>
__device__ __forceinline__ void bwd_thread_edge(const float* st,
                                                float (&v)[N],
                                                float (&kneg)[M]) {
  using Cfg = BwdCfg<N, M>;
  float Lf[N][N], Lg[M][M], dl[N], sd[N], sdi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Lf[i][j] = st[Cfg::kLf + i * Cfg::kLd + j];
    dl[i] = st[Cfg::kD + i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) Lg[i][j] = st[Cfg::kLg + i * M + j];
  delta_scalings<N>(dl, sd, sdi);

  float fh[N], finv_fh[N], g[N], h[M];
#pragma unroll
  for (int i = 0; i < N; ++i)
    fh[i] = sdi[i] * (dl[i] * v[i] - st[Cfg::kC + i]);
  cho_solve_rcp<N>(Lf, fh, finv_fh);
#pragma unroll
  for (int i = 0; i < N; ++i) g[i] = v[i] - sdi[i] * (fh[i] - finv_fh[i]);
  const float* bm = st + Cfg::kB;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = bm[i] * g[0];
#pragma unroll
    for (int k = 1; k < N; ++k) s += bm[k * M + i] * g[k];
    h[i] = st[Cfg::kR + i] + s;
  }
  cho_solve_rcp<M>(Lg, h, kneg);
  const float* a = st + Cfg::kA;
  const float* kk = st + Cfg::kK;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float atg = a[i] * g[0];
#pragma unroll
    for (int k = 1; k < N; ++k) atg += a[k * N + i] * g[k];
    float kth = kk[i] * h[0];
#pragma unroll
    for (int k = 1; k < M; ++k) kth += kk[k * N + i] * h[k];
    v[i] = st[Cfg::kQ + i] + atg + kth;
  }
}

// Backward vector pass over edges e = T-1 .. 0, carrying v of the child
// node (reference: lqr.cpp:746-795): fh = sdi (delta v - c_{e+1}), g = v -
// sdi (fh - F^-1 fh) through the child's F_chol, h = r_e + B^T g, k = -G^-1
// h, v_parent = q_e + A^T g + K^T h.  Inputs [B, stage, ...]: q, c, delta
// [T+1, n], r [T, m], F_chol [T+1, n, n], G_chol [T, m, m], K [T, m, n], A
// [T, n, n], Bm [T, n, m].  Outputs [B, T, ...]: k [m], v of the parent
// node [n].  Per edge the team waits for its stage buffer, copies the edge
// D - 1 stages on into the buffer the last edge freed, and runs the edge
// (team design: the team; thread design: lane 0 of the team).
template <int N, int M>
__global__ void __launch_bounds__(BwdCfg<N, M>::kBlock,
                                  BwdCfg<N, M>::kMinBlocks)
solve_bwd_kernel(int T, int B, const float* __restrict__ q,
                 const float* __restrict__ r, const float* __restrict__ c,
                 const float* __restrict__ delta,
                 const float* __restrict__ fchol,
                 const float* __restrict__ gchol, const float* __restrict__ K,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 float* __restrict__ k_out, float* __restrict__ v_out) {
  using Cfg = BwdCfg<N, M>;
  constexpr int L = Cfg::L, D = Cfg::D, NN = N * N, NM = N * M, MM = M * M;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, lane = threadIdx.x % L;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b = blockIdx.x * Cfg::S + team;
  const bool valid = b < B;
  // a team past the batch runs scenario 0 and writes nothing
  const size_t bv = valid ? b : 0;
  const float* qb = q + bv * (T + 1) * N;
  const float* cb = c + bv * (T + 1) * N;
  const float* db = delta + bv * (T + 1) * N;
  const float* fb = fchol + bv * (T + 1) * NN;
  const float* gb = gchol + bv * T * MM;
  const float* kb = K + bv * T * NM;
  const float* ab = A + bv * T * NN;
  const float* bb = Bm + bv * T * NM;
  const float* rb = r + bv * T * M;
  float* sc = smem + team * Cfg::P;

  // one group of copies: step t's edge e = T - 1 - t into buffer t % D,
  // none past edge 0
  auto fetch = [&](int t) {
    const int e = T - 1 - t;
    if (e >= 0) {
      float* st = sc + (t % D) * Cfg::kStage;
      team_copy<L, N, N, Cfg::kLd>(st + Cfg::kLf, fb + (e + 1) * NN, lane);
      team_copy<L, 1, MM>(st + Cfg::kLg, gb + e * MM, lane);
      team_copy<L, 1, NM>(st + Cfg::kK, kb + e * NM, lane);
      team_copy<L, 1, NN>(st + Cfg::kA, ab + e * NN, lane);
      team_copy<L, 1, NM>(st + Cfg::kB, bb + e * NM, lane);
      team_copy<L, 1, M>(st + Cfg::kR, rb + e * M, lane);
      team_copy<L, 1, N>(st + Cfg::kQ, qb + e * N, lane);
      team_copy<L, 1, N>(st + Cfg::kC, cb + (e + 1) * N, lane);
      team_copy<L, 1, N>(st + Cfg::kD, db + (e + 1) * N, lane);
    }
    cp_async_commit();
  };

#pragma unroll 1
  for (int t = 0; t < D - 1; ++t) fetch(t);
  // the carry v from q_T (team design: lane r's entry; thread design: all)
  float v[Cfg::kTeam ? 1 : N];
  if constexpr (Cfg::kTeam) {
    v[0] = qb[T * N + (lane < N ? lane : 0)];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = qb[T * N + i];
  }
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;
    __syncwarp(mask);  // the team is done with the last edge's buffer
    fetch(t + D - 1);
    cp_async_wait<D - 1>();
    __syncwarp(mask);
    const float* st = sc + (t % D) * Cfg::kStage;
    const size_t o = bv * T + e;
    float kneg[M];
    if constexpr (Cfg::kTeam) {
      v[0] = bwd_team_edge<N, M>(st, sc + Cfg::kVec, v[0], lane, mask, kneg);
      if (valid) {
        if (lane < N) v_out[o * N + lane] = v[0];
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (lane == i % L) k_out[o * M + i] = -kneg[i];
      }
    } else if (lane == 0) {
      bwd_thread_edge<N, M>(st, v, kneg);
      if (valid) {
#pragma unroll
        for (int i = 0; i < M; ++i) k_out[o * M + i] = -kneg[i];
#pragma unroll
        for (int i = 0; i < N; ++i) v_out[o * N + i] = v[i];
      }
    }
  }
  cp_async_wait<0>();
}

// A team kernel's launch on `stream`: grid, block and dynamic shared
// memory from its Cfg; returns the CUDA error code (0 on success).
template <class Cfg, class Kernel, class... Args>
int launch_team(Kernel kernel, int T, int B, void* stream, Args... args) {
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = team::solve_attributes<Cfg>(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + Cfg::S - 1) / Cfg::S, Cfg::kBlock, Cfg::kSmem,
           static_cast<cudaStream_t>(stream)>>>(T, B, args...);
  return static_cast<int>(cudaGetLastError());
}

template <class Cfg>
void team_config(int B, int* out) {
  out[0] = (B + Cfg::S - 1) / Cfg::S;
  out[1] = Cfg::kBlock;
  out[2] = Cfg::kSmem;
}

}  // namespace riccati

// (n, m) instantiations.  The explicit-W factor: cartpole (4, 1), planar
// quadrotor (6, 2), double integrator (2, 1) and the small test shapes
// (3, 1), (3, 2); the Gram-form factor: chain16 (16, 4) and the chains
// (8, 3) and (16, 5), whose m * m exceeds the team's lanes and n + m two
// columns per lane; the solve kernels: all of them.  The Python wrapper
// checks the same lists (ops/riccati_cuda.py: SUPPORTED_SHAPES, GRAM_N) and
// raises before calling for anything else.
#define SMALL_SHAPES(CASE) CASE(4, 1) CASE(6, 2) CASE(2, 1) CASE(3, 1) CASE(3, 2)
#define GRAM_SHAPES(CASE) CASE(16, 4) CASE(8, 3) CASE(16, 5)

// One `if` per shape: launch KERNEL<n, m> and return the launch error.
#define RICCATI_LAUNCH(KERNEL, NN, MM, ...)                                  \
  if (n == NN && m == MM) {                                                  \
    riccati::KERNEL<NN, MM><<<grid, block, 0, s>>>(__VA_ARGS__);             \
    return static_cast<int>(cudaGetLastError());                             \
  }

#define RICCATI_PROLOGUE                                                     \
  if (T < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);        \
  const dim3 grid = riccati::grid_for(B), block(riccati::kThreads);          \
  cudaStream_t s = static_cast<cudaStream_t>(stream);

extern "C" {

int riccati_factor_f32(int n, int m, int T, int B, const float* Q,
                       const float* delta, const float* A, const float* Bm,
                       const float* Mm, const float* R, float* v_out,
                       float* w_out, float* k_out, float* g_out,
                       void* stream) {
  RICCATI_PROLOGUE
#define CASE(NN, MM)                                                         \
  RICCATI_LAUNCH(factor_kernel, NN, MM, T, B, Q, delta, A, Bm, Mm, R, v_out,  \
                 w_out, k_out, g_out)
  SMALL_SHAPES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int riccati_factor_gram_f32(int n, int m, int T, int B, const float* Q,
                            const float* delta, const float* A,
                            const float* Bm, const float* Mm, const float* R,
                            float* v_out, float* k_out, float* g_out,
                            void* stream) {
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM)                                                    \
    return riccati::launch_team<riccati::GramCfg<NN, MM>>(                   \
        &riccati::factor_gram_kernel<NN, MM>, T, B, stream, Q, delta, A, Bm,  \
        Mm, R, v_out, k_out, g_out);
  GRAM_SHAPES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int riccati_solve_bwd_f32(int n, int m, int T, int B, const float* q,
                          const float* r, const float* c, const float* delta,
                          const float* fchol, const float* gchol,
                          const float* K, const float* A, const float* Bm,
                          float* k_out, float* v_out, void* stream) {
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM)                                                    \
    return riccati::launch_team<riccati::BwdCfg<NN, MM>>(                    \
        &riccati::solve_bwd_kernel<NN, MM>, T, B, stream, q, r, c, delta,     \
        fchol, gchol, K, A, Bm, k_out, v_out);
  SMALL_SHAPES(CASE)
  GRAM_SHAPES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int riccati_solve_fwd_f32(int n, int m, int T, int B, const float* x_root,
                          const float* k, const float* K, const float* A,
                          const float* Bm, const float* c, const float* delta,
                          const float* v, const float* V, const float* fchol,
                          float* u_out, float* x_out, float* y_out,
                          void* stream) {
  RICCATI_PROLOGUE
#define CASE(NN, MM)                                                         \
  RICCATI_LAUNCH(solve_fwd_kernel, NN, MM, T, B, x_root, k, K, A, Bm, c,      \
                 delta, v, V, fchol, u_out, x_out, y_out)
  SMALL_SHAPES(CASE)
  GRAM_SHAPES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of team kernel `which` (0 factor_gram, 1
// solve_bwd) at (n, m) and batch B: grid, block, dynamic shared memory
// bytes; zeros for a shape without the kernel.
void riccati_launch_config(int which, int n, int m, int B, int* out) {
  out[0] = out[1] = out[2] = 0;
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM) {                                                  \
    if (which == 1) riccati::team_config<riccati::BwdCfg<NN, MM>>(B, out);    \
    return;                                                                  \
  }
  SMALL_SHAPES(CASE)
#undef CASE
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM) {                                                  \
    if (which == 0) {                                                        \
      riccati::team_config<riccati::GramCfg<NN, MM>>(B, out);                \
    } else {                                                                 \
      riccati::team_config<riccati::BwdCfg<NN, MM>>(B, out);                 \
    }                                                                        \
    return;                                                                  \
  }
  GRAM_SHAPES(CASE)
#undef CASE
}

}  // extern "C"
