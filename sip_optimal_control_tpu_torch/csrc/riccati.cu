// Chain-Riccati kernels for Hopper (sm_90a): factor, backward vector pass,
// forward rollout.
//
// Replaces the TPU kernels of sip_optimal_control_tpu/ops/pallas_riccati.py:
//   riccati_factor_f32       <- _factor_kernel       (explicit-W form, n < 8)
//   riccati_factor_gram_f32  <- _factor_kernel_gram  (Gram form, n >= 8)
//   riccati_solve_bwd_f32    <- _solve_bwd_kernel
//   riccati_solve_fwd_f32    <- _solve_fwd_kernel
// and computes exactly what they compute (per-row delta with delta <= 0
// replaced by 1, the explicit W = sdi (I - F^-1) sdi, W f and x_child
// through two triangular solves with F_chol).  The plain PyTorch twins live
// in ops/riccati_cuda.py.  The TPU kernels put 1024 scenarios on the vector
// lanes of one block and walk the horizon as a sequential grid axis,
// carrying V (or v, x) in VMEM scratch.  Here the horizon loop runs inside
// a kernel, and a bounds check b < B takes the place of the TPU's padding
// to a multiple of 1024.  The kernels allocate nothing and launch on the
// caller's stream.
//
// One design for the four (team.cuh's primitives, shared with the fused
// kernels).  They read and write the solver's own [B, stage, rows] tensors,
// where a scenario's stage block (A_e: 1 KB at n = 16) is contiguous.  A
// block holds kScenarios scenarios, each owned by a team of L lanes of one
// warp at n >= 8 and by one lane of a team of kThreadLanes below (its other
// lanes copy); 256 blocks at B = 4096, two per SM (32 scenarios per SM: one
// wave on 132 SMs, the block's shared memory its share, team::solve_smem).
// Each team copies its scenario's stage operands with cp.async into a ring
// of stage buffers in shared memory, a stage (the Gram factor) or as many
// as the share holds (the others) ahead, and writes its outputs itself; the
// teams never wait for each other (no block barrier).  A team past the
// batch runs scenario 0 and writes nothing.
//   factor (explicit W; instantiated at n < 8 only): lane 0 runs the
//   recursion in registers (riccati_tiny.cuh): F = I + sd V sd, its
//   Cholesky, F^-1, W, G and its Cholesky, H, K, V_parent; the ring holds A,
//   B, M, R, Q_e and delta_{e+1} of each edge.
//   factor_gram (Gram form, pallas_riccati.py::_gram_core): lane r holds row
//   r of V; F = I + sd V sd and its Cholesky column by column over the team
//   (team_chol); [A B] scaled by sdi and turned into columns in place
//   (team_scale_columns); then team_gram_step: one column of Z = Lf^-1 [Ah
//   Bh] per lane, G's upper entries strided over the team, H and K by
//   columns, V_parent by rows as the (min, max) entry, so that V_parent is
//   exactly symmetric and lane r writes column r of it (consecutive lanes on
//   consecutive addresses).  The ring holds A, B, M, R and delta of two
//   stages; Q_e, read last, has one buffer, refilled once V_parent is formed
//   and waited for after the Cholesky.
//   solve_bwd (team design): lane r carries v_r; F^-1 fh through the child's
//   F_chol by team_cho_solve (rows at a padded stride, on distinct banks),
//   B^T g and K^T h by xor butterflies and the shared g.
//   solve_fwd (team design): lane r carries x_r of the parent node; u = k +
//   K x by partial products and butterflies (team_sum), lane r's row of A x
//   + B u with x through the team's shared vector, x_child by
//   team_cho_solve through the child's F_chol, y = v + V x_child with lane
//   r's row of V read from device memory into registers a stage ahead: V
//   stays out of the ring, whose two stages of 16 scenarios at n = 16 then
//   fit the block's share (98 KB; with V 129.5 KB against 113 KB, and one
//   block per SM).
//   Below n = 8 the solves' recursion runs in one lane's registers, every
//   operand in the ring.
//
// What bounds them on an H100 (PERF.md §6): each team's dependent chain per
// stage (n Cholesky columns, each a shuffle and a warp barrier, and the
// n-step triangular solves of the Gram factor; 2n shuffled substitution
// steps and the butterflies of the solves; one lane's n^3 unrolled
// operations of the explicit factor), with 32 scenarios per SM to hide one
// another's; none of the four reaches the device memory's rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include "riccati_tiny.cuh"
#include "team.cuh"

namespace riccati {

using team::align4;
using team::block_stride;
using team::cp_async_commit;
using team::cp_async_wait;
using team::kMaxSmem;
using team::load_col;
using team::solve_smem;
using team::team_cho_solve;
using team::team_chol;
using team::team_copy;
using team::team_gram_step;
using team::team_mask;
using team::team_scale_columns;
using team::team_sum;

constexpr int kGramN = 8;  // ops/riccati_cuda.py: GRAM_N
constexpr int kScenarios = 16;   // scenarios per block
constexpr int kThreadLanes = 4;  // lanes of a team below kGramN
constexpr int kMaxRing = 8;      // the most stages of a ring

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

// The deepest ring of stage buffers (`stage` floats each, `extra` floats
// after them per scenario) whose block of s scenarios fits its share of the
// SM, 2 at least.
__host__ __device__ constexpr int ring_depth(int s, int stage, int extra) {
  int d = kMaxRing;
  while (d > 2 && 4 * s * block_stride(true, d * stage + extra) >
                      solve_smem(s))
    --d;
  return d;
}

// The launch shape of a kernel whose scenarios each hold a ring of stage
// buffers (kStage floats each) and kExtra floats after it: S scenarios per
// block of kBlock threads, ring depth D, scenario stride P floats, kSmem
// bytes of dynamic shared memory, kMinBlocks blocks per SM.
template <int L_, int kStage, int kExtra>
struct Ring {
  static constexpr int L = L_;
  static constexpr int S = fit_scenarios(
      L, block_stride(true, 2 * kStage + kExtra)), kBlock = L * S;
  static constexpr int D = ring_depth(S, kStage, kExtra);
  static constexpr int kVec = D * kStage;
  static constexpr int P = block_stride(true, kVec + kExtra);
  static constexpr int kSmem = 4 * S * P;
  static constexpr int kMinBlocks = blocks_per_sm(S, kSmem);
  static_assert(L <= 32, "a team holds at most a warp");
  static_assert(kSmem <= kMaxSmem, "the ring exceeds a block's shared "
                "memory");
};

// N consecutive floats of device memory into registers: 16-byte loads
// where N is a multiple of 4 and `p` 16-byte aligned.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      load_col<N>(p, out);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = p[k];
}

// An R x C register matrix to R * C consecutive floats of device memory
// at `p`: 16-byte stores where R * C is a multiple of 4 and `p` 16-byte
// aligned.
template <int R, int C>
__device__ __forceinline__ void store_rows(float* p, const float (&a)[R][C]) {
  constexpr int K = R * C;
  auto at = [&](int f) { return a[f / C][f % C]; };
  if constexpr (K % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        float4 v;
        v.x = at(4 * q);
        v.y = at(4 * q + 1);
        v.z = at(4 * q + 2);
        v.w = at(4 * q + 3);
        reinterpret_cast<float4*>(p)[q] = v;
      }
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < K; ++f) p[f] = at(f);
}

// ---------------------------------------------------------------------------
// factor_kernel: the explicit-W factor (thread design, n < kGramN)
// ---------------------------------------------------------------------------

// The explicit factor's stage buffer per scenario: A_e [N][N], B_e [N][M],
// M_e [N][M], R_e [M][M], Q_e [N][N], delta_{e+1} [N].
template <int N, int M>
struct FactorLayout {
  static constexpr int kA = 0, kB = kA + align4(N * N),
                       kM = kB + align4(N * M), kR = kM + align4(N * M),
                       kQ = kR + align4(M * M), kD = kQ + align4(N * N),
                       kStage = kD + align4(N);
};
template <int N, int M>
struct FactorCfg
    : FactorLayout<N, M>,
      Ring<kThreadLanes, FactorLayout<N, M>::kStage, 0> {
  static_assert(N < kGramN, "n >= kGramN takes the Gram-form factor");
};

// One backward edge of the explicit factor (reference: lqr.cpp:487-529,
// :689-719), the edge's operands in stage buffer `st`: V of the child node
// in, V of the parent node out, with the edge's W, K and G_chol.
template <int N, int M>
__device__ __forceinline__ void factor_thread_edge(const float* st,
                                                   float (&V)[N][N],
                                                   float (&W)[N][N],
                                                   float (&K)[M][N],
                                                   float (&Lg)[M][M]) {
  using Cfg = FactorCfg<N, M>;
  float dl[N], sd[N], sdi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dl[i] = st[Cfg::kD + i];
  delta_scalings<N>(dl, sd, sdi);

  // F = I + sd V sd; W = sdi (I - F^{-1}) sdi, F^{-1} in the twin's order
  // of operations: W cancels ~5 digits at the solver's delta, so another
  // order (reciprocals of the diagonal, say) moves W by more than the
  // paths' step-1 agreement with the "scan" backend allows (PERF.md §6)
  float F[N][N], Lf[N][N], Finv[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      F[i][j] = sd[i] * V[i][j] * sd[j] + (i == j ? 1.0f : 0.0f);
  chol<N>(F, Lf);
  cho_inverse<N>(Lf, Finv);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      W[i][j] = sdi[i] * ((i == j ? 1.0f : 0.0f) - Finv[i][j]) * sdi[j];

  // G = R + B^T W B; H = M^T + B^T W A; K = -G^{-1} H
  const float* a = st + Cfg::kA;
  const float* bm = st + Cfg::kB;
  const float* mm = st + Cfg::kM;
  const float* r = st + Cfg::kR;
  float BtW[M][N];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = bm[i] * W[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += bm[k * M + i] * W[k][j];
      BtW[i][j] = s;
    }
  float G[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float s = BtW[i][0] * bm[j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += BtW[i][k] * bm[k * M + j];
      G[i][j] = r[i * M + j] + s;
    }
  chol<M>(G, Lg);

  float WA[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = W[i][0] * a[j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += W[i][k] * a[k * N + j];
      WA[i][j] = s;
    }
  float H[M][N];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = bm[i] * WA[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) s += bm[k * M + i] * WA[k][j];
      H[i][j] = mm[j * M + i] + s;
    }
  float Kneg[M][N];
  cho_solve_mat<M, N>(Lg, H, Kneg);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) K[i][j] = -Kneg[i][j];

  // V_parent = Q_parent + A^T W A + K^T H
  const float* qp = st + Cfg::kQ;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float awa = a[i] * WA[0][j];
#pragma unroll
      for (int k = 1; k < N; ++k) awa += a[k * N + i] * WA[k][j];
      float kh = K[0][i] * H[0][j];
#pragma unroll
      for (int k = 1; k < M; ++k) kh += K[k][i] * H[k][j];
      V[i][j] = qp[i * N + j] + (awa + kh);
    }
}

// Backward factorization over edges e = T-1 .. 0, carrying V of the child
// node in lane 0's registers.  Inputs [B, stage, ...]: Q [T+1, n, n], delta
// [T+1, n], A [T, n, n], Bm, Mm [T, n, m], R [T, m, m].  Outputs [B, T,
// ...]: V of the parent node [n, n], W [n, n], K [m, n], G_chol [m, m].
// Per edge the team waits for its stage buffer, copies the edge D - 1
// stages on into the buffer the last edge freed, and lane 0 runs the edge.
template <int N, int M>
__global__ void __launch_bounds__(FactorCfg<N, M>::kBlock,
                                  FactorCfg<N, M>::kMinBlocks)
factor_kernel(int T, int B, const float* __restrict__ Q,
              const float* __restrict__ delta, const float* __restrict__ A,
              const float* __restrict__ Bm, const float* __restrict__ Mm,
              const float* __restrict__ R, float* __restrict__ v_out,
              float* __restrict__ w_out, float* __restrict__ k_out,
              float* __restrict__ g_out) {
  using Cfg = FactorCfg<N, M>;
  constexpr int L = Cfg::L, D = Cfg::D, NN = N * N, NM = N * M, MM = M * M;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, lane = threadIdx.x % L;
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

  // one group of copies: step t's edge e = T - 1 - t into buffer t % D,
  // none past edge 0
  auto fetch = [&](int t) {
    const int e = T - 1 - t;
    if (e >= 0) {
      float* st = sc + (t % D) * Cfg::kStage;
      team_copy<L, 1, NN>(st + Cfg::kA, ab + e * NN, lane);
      team_copy<L, 1, NM>(st + Cfg::kB, bb + e * NM, lane);
      team_copy<L, 1, NM>(st + Cfg::kM, mb + e * NM, lane);
      team_copy<L, 1, MM>(st + Cfg::kR, rb + e * MM, lane);
      team_copy<L, 1, NN>(st + Cfg::kQ, qb + e * NN, lane);
      team_copy<L, 1, N>(st + Cfg::kD, db + (e + 1) * N, lane);
    }
    cp_async_commit();
  };

#pragma unroll 1
  for (int t = 0; t < D - 1; ++t) fetch(t);
  float V[N][N];  // lane 0's carry, from Q_T
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = qb[T * NN + i * N + j];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int e = T - 1 - t;  // edge e: parent node e, child node e + 1
    __syncwarp(mask);  // the team is done with the last edge's buffer
    fetch(t + D - 1);
    cp_async_wait<D - 1>();
    __syncwarp(mask);
    if (lane == 0) {
      float W[N][N], K[M][N], Lg[M][M];
      factor_thread_edge<N, M>(sc + (t % D) * Cfg::kStage, V, W, K, Lg);
      if (valid) {
        const size_t o = bv * T + e;
        store_rows<N, N>(v_out + o * NN, V);
        store_rows<N, N>(w_out + o * NN, W);
        store_rows<M, N>(k_out + o * NM, K);
        store_rows<M, M>(g_out + o * MM, Lg);
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// factor_gram_kernel: the Gram-form factor (team design, n >= kGramN)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// solve_bwd_kernel: the backward vector pass
// ---------------------------------------------------------------------------

// solve_bwd's stage buffer per scenario: F_chol_{e+1} rows at stride kLd,
// G_chol_e, K_e, A_e, B_e, r_e, q_e, c_{e+1}, delta_{e+1}; a ring of D of
// them, then (team design) the exchanged vector g [N].
template <int N, int M>
struct BwdLayout {
  static constexpr bool kTeam = N >= kGramN;
  static constexpr int kLd = kTeam ? N + 4 : N;
  static constexpr int kLf = 0, kLg = align4(N * kLd),
                       kK = kLg + align4(M * M), kA = kK + align4(M * N),
                       kB = kA + align4(N * N), kR = kB + align4(N * M),
                       kQ = kR + align4(M), kC = kQ + align4(N),
                       kD = kC + align4(N), kStage = kD + align4(N);
};
template <int N, int M>
struct BwdCfg : BwdLayout<N, M>,
                Ring<team_lanes(N), BwdLayout<N, M>::kStage,
                     BwdLayout<N, M>::kTeam ? align4(N) : 0> {};

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

// ---------------------------------------------------------------------------
// solve_fwd_kernel: the forward rollout
// ---------------------------------------------------------------------------

// solve_fwd's stage buffer per scenario: F_chol_{e+1} rows at stride kLd,
// A_e, K_e, B_e, k_e, c_{e+1}, delta_{e+1}, v_{e+1}, and (thread design
// only) V_{e+1}; a ring of D of them, then (team design) the exchanged
// vector x [N].  The team design reads lane r's row of V_{e+1} from device
// memory into registers instead, a stage ahead.
template <int N, int M>
struct FwdLayout {
  static constexpr bool kTeam = N >= kGramN;
  static constexpr int kLd = kTeam ? N + 4 : N;
  static constexpr int kLf = 0, kA = align4(N * kLd),
                       kK = kA + align4(N * N), kB = kK + align4(M * N),
                       kKv = kB + align4(N * M), kC = kKv + align4(M),
                       kD = kC + align4(N), kVv = kD + align4(N),
                       kV = kVv + align4(N),
                       kStage = kV + (kTeam ? 0 : align4(N * N));
};
template <int N, int M>
struct FwdCfg : FwdLayout<N, M>,
                Ring<team_lanes(N), FwdLayout<N, M>::kStage,
                     FwdLayout<N, M>::kTeam ? align4(N) : 0> {};

// One forward edge of solve_fwd's team design, x of the parent node in the
// team's vector `vec`, lane r's row of V_{e+1} in `vrow`, the edge's other
// operands in stage buffer `st`: u = k + K x summed over the team (every
// lane receives u), lane r's row of A x + B u (its row of A read from its
// own diagonal on, so that the team's lanes read distinct banks), x_child
// by the team's solve through F_chol, then x_child through `vec` for y_r =
// v_r + V[r, :] x_child.  Returns x_child,r and leaves x_child in `vec`.
template <int N, int M>
__device__ __forceinline__ float fwd_team_edge(const float* st, float* vec,
                                               const float (&vrow)[N],
                                               int lane, unsigned mask,
                                               float (&u)[M], float& y) {
  using Cfg = FwdCfg<N, M>;
  constexpr int L = Cfg::L;
  const int ro = lane < N ? lane : 0;
  const float xo = vec[ro];
  const float* kk = st + Cfg::kK;
#pragma unroll
  for (int i = 0; i < M; ++i) u[i] = lane < N ? kk[i * N + ro] * xo : 0.0f;
  team_sum<M, L>(u, mask);
#pragma unroll
  for (int i = 0; i < M; ++i) u[i] += st[Cfg::kKv + i];
  const float* aj = st + Cfg::kA + ro * N;
  const float* bj = st + Cfg::kB + ro * M;
  float ax = aj[ro] * xo;
#pragma unroll
  for (int j = 1; j < N; ++j) {
    const int jr = ro + j < N ? ro + j : ro + j - N;
    ax += aj[jr] * vec[jr];
  }
  float bu = bj[0] * u[0];
#pragma unroll
  for (int j = 1; j < M; ++j) bu += bj[j] * u[j];
  const float dl = st[Cfg::kD + ro];
  const float sd = sqrtf(dl > 0.0f ? dl : 1.0f), sdi = 1.0f / sd;
  const float vr = st[Cfg::kVv + ro];
  const float rhs = st[Cfg::kC + ro] - dl * vr + ax + bu;
  const float xc =
      sd * team_cho_solve<N, L, Cfg::kLd>(st + Cfg::kLf, sdi * rhs, lane,
                                          mask);
  __syncwarp(mask);  // every lane has read the parent's x
  if (lane < N) vec[lane] = xc;
  __syncwarp(mask);
  float xv[N];
  load_col<N>(vec, xv);
  float s = vrow[0] * xv[0];
#pragma unroll
  for (int j = 1; j < N; ++j) s += vrow[j] * xv[j];
  y = vr + s;
  return xc;
}

// One forward edge of solve_fwd's thread design (n < kGramN): the
// recursion of one lane in registers, every operand from stage buffer `st`;
// x of the parent node in, of the child node out.
template <int N, int M>
__device__ __forceinline__ void fwd_thread_edge(const float* st,
                                                float (&x)[N], float (&u)[M],
                                                float (&y)[N]) {
  using Cfg = FwdCfg<N, M>;
  const float* kg = st + Cfg::kK;
  const float* a = st + Cfg::kA;
  const float* bm = st + Cfg::kB;
  const float* vm = st + Cfg::kV;
  float Lf[N][N], dl[N], sd[N], sdi[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Lf[i][j] = st[Cfg::kLf + i * Cfg::kLd + j];
    dl[i] = st[Cfg::kD + i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = kg[i * N] * x[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += kg[i * N + j] * x[j];
    u[i] = st[Cfg::kKv + i] + s;
  }
  float scaled[N], xs[N];
  delta_scalings<N>(dl, sd, sdi);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ax = a[i * N] * x[0];
#pragma unroll
    for (int j = 1; j < N; ++j) ax += a[i * N + j] * x[j];
    float bu = bm[i * M] * u[0];
#pragma unroll
    for (int j = 1; j < M; ++j) bu += bm[i * M + j] * u[j];
    scaled[i] = sdi[i] * (st[Cfg::kC + i] - dl[i] * st[Cfg::kVv + i] + ax +
                          bu);
  }
  cho_solve_vec<N>(Lf, scaled, xs);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = sd[i] * xs[i];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = vm[i * N] * x[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += vm[i * N + j] * x[j];
    y[i] = st[Cfg::kVv + i] + s;
  }
}

// Forward rollout over edges e = 0 .. T-1, carrying x of the parent node
// (reference: lqr.cpp:821-870): u = k + K x, x_child = (I + delta V)^{-1}
// (A x + B u + c - delta v) through F_chol, y = v + V x_child.  Inputs [B,
// ...]: x_root [n], k [T, m], K [T, m, n], A [T, n, n], Bm [T, n, m], and
// the node-indexed c, delta, v [T+1, n], V, F_chol [T+1, n, n].  Outputs
// [B, T, ...]: u [m], x and y of the child node [n].  Per edge as
// solve_bwd_kernel, walked forward.
template <int N, int M>
__global__ void __launch_bounds__(FwdCfg<N, M>::kBlock,
                                  FwdCfg<N, M>::kMinBlocks)
solve_fwd_kernel(int T, int B, const float* __restrict__ x_root,
                 const float* __restrict__ k, const float* __restrict__ K,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ c, const float* __restrict__ delta,
                 const float* __restrict__ vv, const float* __restrict__ Vm,
                 const float* __restrict__ fchol, float* __restrict__ u_out,
                 float* __restrict__ x_out, float* __restrict__ y_out) {
  using Cfg = FwdCfg<N, M>;
  constexpr int L = Cfg::L, D = Cfg::D, NN = N * N, NM = N * M;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int team = threadIdx.x / L, lane = threadIdx.x % L;
  const int ro = lane < N ? lane : 0;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const int b = blockIdx.x * Cfg::S + team;
  const bool valid = b < B;
  // a team past the batch runs scenario 0 and writes nothing
  const size_t bv = valid ? b : 0;
  const float* xb = x_root + bv * N;
  const float* kvb = k + bv * T * M;
  const float* kb = K + bv * T * NM;
  const float* ab = A + bv * T * NN;
  const float* bb = Bm + bv * T * NM;
  const float* cb = c + bv * (T + 1) * N;
  const float* db = delta + bv * (T + 1) * N;
  const float* vb = vv + bv * (T + 1) * N;
  const float* Vb = Vm + bv * (T + 1) * NN;
  const float* fb = fchol + bv * (T + 1) * NN;
  float* sc = smem + team * Cfg::P;

  // one group of copies: edge t into buffer t % D, none past edge T - 1
  auto fetch = [&](int t) {
    if (t < T) {
      float* st = sc + (t % D) * Cfg::kStage;
      team_copy<L, N, N, Cfg::kLd>(st + Cfg::kLf, fb + (t + 1) * NN, lane);
      team_copy<L, 1, NN>(st + Cfg::kA, ab + t * NN, lane);
      team_copy<L, 1, NM>(st + Cfg::kK, kb + t * NM, lane);
      team_copy<L, 1, NM>(st + Cfg::kB, bb + t * NM, lane);
      team_copy<L, 1, M>(st + Cfg::kKv, kvb + t * M, lane);
      team_copy<L, 1, N>(st + Cfg::kC, cb + (t + 1) * N, lane);
      team_copy<L, 1, N>(st + Cfg::kD, db + (t + 1) * N, lane);
      team_copy<L, 1, N>(st + Cfg::kVv, vb + (t + 1) * N, lane);
      if constexpr (!Cfg::kTeam)
        team_copy<L, 1, NN>(st + Cfg::kV, Vb + (t + 1) * NN, lane);
    }
    cp_async_commit();
  };

#pragma unroll 1
  for (int t = 0; t < D - 1; ++t) fetch(t);
  // the carry x from x_root (team design: the team's vector, and lane r's
  // row of V_1; thread design: registers)
  float x[Cfg::kTeam ? 1 : N], vrow[Cfg::kTeam ? N : 1];
  if constexpr (Cfg::kTeam) {
    if (lane < N) sc[Cfg::kVec + lane] = xb[lane];
    load_row<N>(Vb + NN + ro * N, vrow);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xb[i];
  }
#pragma unroll 1
  for (int e = 0; e < T; ++e) {
    __syncwarp(mask);  // the team is done with the last edge's buffer
    fetch(e + D - 1);
    cp_async_wait<D - 1>();
    __syncwarp(mask);
    const float* st = sc + (e % D) * Cfg::kStage;
    const size_t o = bv * T + e;
    float u[M];
    if constexpr (Cfg::kTeam) {
      float y;
      const float xc =
          fwd_team_edge<N, M>(st, sc + Cfg::kVec, vrow, lane, mask, u, y);
      // lane r's row of the next edge's V (node e + 2; node T past the end)
      load_row<N>(Vb + (e + 2 <= T ? e + 2 : T) * NN + ro * N, vrow);
      if (valid) {
        if (lane < N) {
          x_out[o * N + lane] = xc;
          y_out[o * N + lane] = y;
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
          if (lane == i % L) u_out[o * M + i] = u[i];
      }
    } else if (lane == 0) {
      float y[N];
      fwd_thread_edge<N, M>(st, x, u, y);
      if (valid) {
#pragma unroll
        for (int i = 0; i < M; ++i) u_out[o * M + i] = u[i];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          x_out[o * N + i] = x[i];
          y_out[o * N + i] = y[i];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// A kernel's launch on `stream`: grid, block and dynamic shared memory from
// its Cfg; returns the CUDA error code (0 on success).
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

extern "C" {

int riccati_factor_f32(int n, int m, int T, int B, const float* Q,
                       const float* delta, const float* A, const float* Bm,
                       const float* Mm, const float* R, float* v_out,
                       float* w_out, float* k_out, float* g_out,
                       void* stream) {
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM)                                                    \
    return riccati::launch_team<riccati::FactorCfg<NN, MM>>(                 \
        &riccati::factor_kernel<NN, MM>, T, B, stream, Q, delta, A, Bm, Mm,   \
        R, v_out, w_out, k_out, g_out);
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
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM)                                                    \
    return riccati::launch_team<riccati::FwdCfg<NN, MM>>(                    \
        &riccati::solve_fwd_kernel<NN, MM>, T, B, stream, x_root, k, K, A,    \
        Bm, c, delta, v, V, fchol, u_out, x_out, y_out);
  SMALL_SHAPES(CASE)
  GRAM_SHAPES(CASE)
#undef CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration of kernel `which` (0 factor, 1 factor_gram, 2
// solve_bwd, 3 solve_fwd) at (n, m) and batch B: grid, block, dynamic
// shared memory bytes; zeros for a shape without the kernel (a factor at
// the other form's shapes).
void riccati_launch_config(int which, int n, int m, int B, int* out) {
  out[0] = out[1] = out[2] = 0;
#define SOLVES(NN, MM)                                                       \
  if (which == 2) riccati::team_config<riccati::BwdCfg<NN, MM>>(B, out);      \
  if (which == 3) riccati::team_config<riccati::FwdCfg<NN, MM>>(B, out);
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM) {                                                  \
    if (which == 0) riccati::team_config<riccati::FactorCfg<NN, MM>>(B, out); \
    SOLVES(NN, MM)                                                           \
    return;                                                                  \
  }
  SMALL_SHAPES(CASE)
#undef CASE
#define CASE(NN, MM)                                                         \
  if (n == NN && m == MM) {                                                  \
    if (which == 1) riccati::team_config<riccati::GramCfg<NN, MM>>(B, out);   \
    SOLVES(NN, MM)                                                           \
    return;                                                                  \
  }
  GRAM_SHAPES(CASE)
#undef CASE
#undef SOLVES
}

}  // extern "C"
