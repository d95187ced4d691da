// Fused line-search probe for Hopper (sm_90a), chain topologies.
//
// Replaces the TPU kernel sip_optimal_control_tpu/ops/pallas_ls.py::
// _probe_kernel and computes what it computes: for each scenario and each
// candidate step size alpha, over the whole chain at once,
//   f     = sum_t node_cost(x_t(alpha), t) + edge_cost(x_t, u_t, t)
//           + node_cost(x_T, T),
//   theta = sum_t |dynamics(x_t, u_t, t) - x_{t+1}(alpha)|_1
//           + |x0 - x_0(alpha)|_1                     (the root row),
//   logb  = sum of log(v - lb) + log(ub - v) over the finite bounds of
//           u_t and x_t, -inf at any distance <= 0,
// with v(alpha) = v + alpha dv and float32 accumulators.
//
// The user's stage functions are not known here.  ops/ls_probe.py
// generates, per model, a struct `Model` with the horizon and dims as
// constants, the stage functions as straight-line float32 code
// (ops/stage_codegen.py::emit_cuda; closure constants are literals) and the
// bound terms with the finite bounds baked in, and instantiates
// `launch<Model>` below behind a plain C entry point.
//
// Design.  The stage terms are independent once the candidate point is
// known; only the three sums run across stages.  A team of L lanes of one
// warp owns one scenario (csrc/team.cuh's teams: L = 32 from T = 31 on, the
// power of two above T below, so short chains share a warp).  The team
// takes the T + 1 stages (stage T the terminal node) in windows of W = L:
// it copies a window's rows of x, dx (one more: x_{t+1} of the last stage),
// u and du into shared memory, the scenario's [B, stage, dim] tensors read
// in place on consecutive addresses, so each stage's operands are loaded
// from device memory once for every candidate; the rows are padded so that
// lanes reading consecutive rows hit distinct banks.  Then the window's
// items, its (stage, candidate) pairs for up to kGroup candidates, go to
// the lanes in turn, stage-major within a candidate (item j = k wn + (t -
// w0) to lane j mod L); a lane adds each item's f, theta and logb terms
// into its own sums of that candidate; lane 0 starts its theta sums with
// the root row.  The team then adds the 3 kGroup sums by an xor butterfly
// (team::team_sum) and its lanes write them to [B, chunk], one entry each.
// A chunk above kGroup takes more passes, the last one with the rest.  At
// the main path's B = 4096, T = 50 and 6 candidates that is 4096 warps of
// 10 items a lane (306 items, 96% of the lanes busy), where one thread per
// (scenario, candidate) walking the 50 stages in turn gave 768 warps, each
// a chain of 50 dependent stages, and read each warp's rows across 6
// scenarios' lines.  scripts/ls_probe_variants.py timed the alternatives
// (PERF.md): each lane on whole stages for all 6 candidates at once (20% of
// the lanes idle at T = 50, and 227 registers at chain16), 2, 3 or 6
// candidates evaluated together from one load, rows read straight from
// device memory (16 lines per warp load at n = 16), and register caps.
//
// Summation order.  Per candidate, lane r adds the terms of its items in
// turn: the windows in order, in a window its stages in increasing order
// (a stage's f term is node_cost + edge_cost, its theta term the L1
// residual summed over the entries in order, its logb term the stage's
// bound terms in order; lane 0's theta starts at the root row); then the
// butterfly adds the lanes' sums, offsets L/2 down to 1 (a + b and b + a
// round alike, so every lane ends with the same sum).  That is not the TPU
// kernel's sequential order (pallas_ls.py:209-278), nor the one of the
// twins in ops/ls_probe.py: each sum is within (ceil((T + 2) / L) +
// log2 L) float32 epsilons times the sum of its terms' magnitudes of the
// exact sum of the same terms, and tests/test_torch_ls_probe_host.py holds
// it within (T + 1) of them of a float64 sequential sum, and within
// 2e-5 relative of the twin (tests/test_pallas_ls.py's bar).
//
// Confinement.  A team reads only its scenario's rows, an item's terms go
// only into its own candidate's sums, and lanes without an item, and teams
// past the batch, add nothing: a NaN stays in its scenario, a -inf in its
// candidate's logb.
//
// What bounds it: issuing the stage functions' instructions (RK4 with
// precise sinf / cosf for cartpole, a 16 x 16 matrix-vector product with
// 16 tanhf and 16 divisions for chain16: ~1,100 and ~1,270 SASS
// instructions of code per item) at 96% of the lanes busy, two waves of
// 4096 warps at 72 and 128 registers; see PERF.md for the bound at the
// main path's shapes and the times measured.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "riccati_tiny.cuh"  // team.cuh's Gram step names riccati::
#include "team.cuh"

namespace ls_probe {

constexpr int kThreads = 128;
constexpr int kGroup = 6;  // candidates of a pass (the paths' chunk)

// log of a bound distance; -inf for a non-positive (or NaN) distance, so
// infeasible candidates are rejected exactly like the standard probe
// (pallas_ls.py:194-200)
__device__ __forceinline__ float safe_log(float d) {
  return d > 0.0f ? logf(fmaxf(d, 1e-30f)) : -INFINITY;
}

// Lanes of a scenario's team: the power of two at or above the T + 1
// stages, at most a warp.
__host__ __device__ constexpr int team_lanes(int T) {
  int lanes = 1;
  while (lanes < 32 && lanes < T + 1) lanes *= 2;
  return lanes;
}

// A row of K floats in shared memory: its stride, 16-byte aligned with an
// odd number of 16-byte units when K is a multiple of 4 (the 8 lanes of a
// quarter-warp reading consecutive rows as float4 hit distinct banks), else
// odd (consecutive rows read as scalars hit distinct banks).
__host__ __device__ constexpr int row_stride(int K) {
  return K % 4 == 0 ? (K / 4 % 2 == 1 ? K : K + 4) : (K | 1);
}

// The shared-memory map of a team: a window of W = L stages' rows of x,
// dx (W + 1 rows: x_{t+1} of the window's last stage) and of u, du, each
// region 16-byte aligned.
template <class Model>
struct Cfg {
  static constexpr int T = Model::T, N = Model::N, M = Model::M;
  static constexpr int L = team_lanes(T), W = L, kTeams = kThreads / L;
  static constexpr int PN = row_stride(N), PM = row_stride(M);
  static constexpr int kXRows = team::align4((W + 1) * PN),
                       kURows = team::align4(W * PM);
  static constexpr int kX = 0, kDX = kXRows, kU = 2 * kXRows,
                       kDU = kU + kURows;
  static constexpr int kTeamFloats = kDU + kURows;
  static constexpr int kSmem = kTeams * kTeamFloats * 4;
  static_assert(kSmem <= team::kMaxSmem, "the block's windows fit (n < 200)");
};

// `rows` rows of K contiguous floats of device memory at `src` into shared
// memory rows of stride P at `dst`, by the team's L lanes on consecutive
// addresses.
template <int L, int K, int P>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int r) {
  for (int f = r; f < rows * K; f += L) dst[(f / K) * P + f % K] = src[f];
}

// Stage t's terms for candidate step `a` of one scenario, its rows in
// shared memory (x_t at xs, dx_t at dxs, x_{t+1} and dx_{t+1} a row of
// stride PN further, u_t at us, du_t at dus): f, theta (without the root
// row) and logb.  Stage T is the terminal node: its cost and its
// state-bound terms.
template <class Model>
__device__ __forceinline__ void stage_terms(int t, const float* xs,
                                            const float* dxs,
                                            const float* us,
                                            const float* dus, float a,
                                            float& f, float& th, float& lb) {
  constexpr int T = Model::T, N = Model::N, M = Model::M;
  constexpr int PN = Cfg<Model>::PN;
  float xt[N], dxt[N], xp[N];
  team::load_col<N>(xs, xt);
  team::load_col<N>(dxs, dxt);
#pragma unroll
  for (int j = 0; j < N; ++j) xp[j] = xt[j] + a * dxt[j];
  if (t < T) {
    float ut[M], dut[M], ue[M], pred[N];
    team::load_col<M>(us, ut);
    team::load_col<M>(dus, dut);
#pragma unroll
    for (int j = 0; j < M; ++j) ue[j] = ut[j] + a * dut[j];
    Model::dynamics(xp, ue, t, pred);
    th = fabsf(pred[0] - (xs[PN] + a * dxs[PN]));
#pragma unroll
    for (int j = 1; j < N; ++j)
      th += fabsf(pred[j] - (xs[PN + j] + a * dxs[PN + j]));
    f = Model::node_cost(xp, t) + Model::edge_cost(xp, ue, t);
    lb = Model::stage_logb(xp, ue);
  } else {
    f = Model::node_cost(xp, T);
    th = 0.0f;
    lb = Model::terminal_logb(0.0f, xp);
  }
}

// Up to kGroup candidates a pass.  The stages go in windows of W: the team
// copies a window's rows into shared memory, then its items, the (stage t,
// candidate k) pairs, item j = k wn + (t - w0) of the window's wn stages
// from w0, go to lane r in turn: j = r, r + L, ...
template <class Model>
__global__ void __launch_bounds__(kThreads)
probe_kernel(int B, int chunk, const float* __restrict__ x,
             const float* __restrict__ dx, const float* __restrict__ u,
             const float* __restrict__ du, const float* __restrict__ x0,
             const float* __restrict__ alphas, long long a_sb,
             long long a_sk, float* __restrict__ f_out,
             float* __restrict__ th_out, float* __restrict__ lb_out) {
  using C = Cfg<Model>;
  constexpr int T = C::T, N = C::N, M = C::M, L = C::L, S = T + 1;
  constexpr int W = C::W, K = kGroup;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int r = threadIdx.x % L, team_id = threadIdx.x / L;
  float* sm = reinterpret_cast<float*>(smem4) + team_id * C::kTeamFloats;
  const long long b =
      static_cast<long long>(blockIdx.x) * C::kTeams + team_id;
  // a team past the batch copies, adds and writes nothing, but takes part
  // in its warp's shuffles and barriers
  const bool valid = b < B;
  const long long bv = valid ? b : 0;
  const unsigned mask = team::team_mask<L>(threadIdx.x);
  const float* xb = x + bv * S * N;
  const float* dxb = dx + bv * S * N;
  const float* ub = u + bv * T * M;
  const float* dub = du + bv * T * M;

#pragma unroll 1
  for (int k0 = 0; k0 < chunk; k0 += K) {
    const int kc = chunk - k0 < K ? chunk - k0 : K;  // candidates this pass
    // p[k], p[K + k], p[2 K + k]: candidate k0 + k's f, theta, logb
    float a[K], p[3 * K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[k] = alphas[bv * a_sb + (k0 + (k < kc ? k : 0)) * a_sk];
      p[k] = 0.0f;
      p[K + k] = 0.0f;
      p[2 * K + k] = 0.0f;
    }
    if (valid && r == 0) {  // the root row |x0 - x_0(alpha)|
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float th_r = fabsf(x0[bv * N] - (xb[0] + a[k] * dxb[0]));
#pragma unroll
        for (int j = 1; j < N; ++j)
          th_r += fabsf(x0[bv * N + j] - (xb[j] + a[k] * dxb[j]));
        p[K + k] = th_r;
      }
    }
#pragma unroll 1
    for (int w0 = 0; w0 < S; w0 += W) {
      const int wn = S - w0 < W ? S - w0 : W;      // stages in the window
      const int last = w0 + wn < T ? w0 + wn : T;  // its last x row
      __syncwarp(mask);  // the previous window's items are done
      if (valid) {
        copy_rows<L, N, C::PN>(sm + C::kX, xb + w0 * N, last - w0 + 1, r);
        copy_rows<L, N, C::PN>(sm + C::kDX, dxb + w0 * N, last - w0 + 1, r);
        copy_rows<L, M, C::PM>(sm + C::kU, ub + w0 * M, last - w0, r);
        copy_rows<L, M, C::PM>(sm + C::kDU, dub + w0 * M, last - w0, r);
      }
      __syncwarp(mask);
      // lane r's first item (k, tl); each next one L items on
      int k = r / wn, tl = r - k * wn;
#pragma unroll 1
      while (valid && k < kc) {
        float ak = a[0];
#pragma unroll
        for (int q = 1; q < K; ++q)
          if (q == k) ak = a[q];
        float f, th, lb;
        stage_terms<Model>(w0 + tl, sm + C::kX + tl * C::PN,
                           sm + C::kDX + tl * C::PN, sm + C::kU + tl * C::PM,
                           sm + C::kDU + tl * C::PM, ak, f, th, lb);
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (q == k) {
            p[q] += f;
            p[K + q] += th;
            p[2 * K + q] += lb;
          }
        }
        for (tl += L; tl >= wn; tl -= wn) ++k;
      }
    }
    team::team_sum<3 * K, L>(p, mask);
    if (valid) {
#pragma unroll
      for (int q = 0; q < 3 * K; ++q) {
        if (q % L == r && q % K < kc) {
          float* out = q < K ? f_out : q < 2 * K ? th_out : lb_out;
          out[b * chunk + k0 + q % K] = p[q];
        }
      }
    }
  }
}

// The launch at batch B: grid, block, dynamic shared memory bytes, the
// lanes of a scenario's team (and stages of a window).
template <class Model>
void launch_config(int B, int* out) {
  using C = Cfg<Model>;
  out[0] = (B + C::kTeams - 1) / C::kTeams;
  out[1] = kThreads;
  out[2] = C::kSmem;
  out[3] = C::L;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
template <class Model>
int launch(int B, int chunk, const float* x, const float* dx, const float* u,
           const float* du, const float* x0, const float* alphas,
           long long a_sb, long long a_sk, float* f_out, float* th_out,
           float* lb_out, void* stream) {
  if (B < 1 || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  int cfg[4];
  launch_config<Model>(B, cfg);
  auto kernel = &probe_kernel<Model>;
  if (cfg[2] > 48 * 1024) {  // above the default limit (n >= 40)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg[2]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<cfg[0], cfg[1], cfg[2], static_cast<cudaStream_t>(stream)>>>(
      B, chunk, x, dx, u, du, x0, alphas, a_sb, a_sk, f_out, th_out, lb_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ls_probe
