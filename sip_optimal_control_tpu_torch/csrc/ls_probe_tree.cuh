// Fused line-search probe for Hopper (sm_90a), general rooted trees.
//
// Replaces the TPU kernel sip_optimal_control_tpu/ops/pallas_ls.py::
// _probe_kernel_tree and computes what it computes: for each scenario and
// each candidate step size alpha, over the whole tree at once,
//   f     = sum_i node_cost_i(x_i(alpha))
//           + sum_e edge_cost_e(x_parent(e)(alpha), u_e(alpha)),
//   theta = sum_e |dyn_e(x_parent(e), u_e) - x_child(e)(alpha)|_1
//           + |x0 - x_root(alpha)|_1,
//   logb  = sum of log(v - lb) + log(ub - v) over the finite bounds of
//           every u_e and x_i, -inf at any distance <= 0,
// with v(alpha) = v + alpha dv and float32 accumulators.
//
// The tree and the stage functions are not known here.  ops/ls_probe.py
// generates, per model, a struct `Model`: the dims, the root and the edge
// count as constants; each edge's parent and child node and the index of
// its child's node cost, its edge cost and its dynamics among the distinct
// stage functions as tables (device arrays: CUDA reads no constexpr array
// at a run-time index in device code); one switch per kind over those
// distinct functions (ops/ls_probe.py::_dedup_functions); the finite bounds
// baked into `node_logb` and `edge_logb`.  `launch<Model>` below is
// instantiated behind a plain C entry point.  The header includes no other
// of csrc/: its few helpers are its own.
//
// Design.  In a rooted tree every node but the root is the child of exactly
// one edge, so the item (e, k) carries edge e's cost, its L1 dynamics
// residual and its control-bound terms together with its child node's cost
// and state-bound terms, at candidate k; item (E, k) is the root's cost,
// its state-bound terms and the root row.  A team of L lanes of one warp
// owns one scenario (team_lanes: the power of two at or above E + 1, at
// least 8 so that each of a pass's kGroup candidates has a lane, at most
// 32, so small trees share a warp).  The team takes the
// edges in the edge list's order in windows of W (window_edges: the power
// of two at or above E + 1, at most kMaxWindow = 64, so one window at
// robust_tree): it gathers into shared memory, through the parent and
// child tables, each window edge's parent row and child row of x and dx,
// and copies the window's rows of u and du, padded as row_stride
// pads them (consecutive slots on distinct banks).  The node numbering does
// not matter: a parent with children in several windows is gathered into
// each (from L1 / L2 after the first).  Up to kGroup candidates a pass, kc
// of them, go to groups of G = L / kc lanes: lane r = k G + g takes
// candidate k and the items e = g, g + G, ... of 0 .. E (lanes from kc G on
// take none), adds each item's terms into its three scalar sums, and at
// the end writes them to shared memory, where lane q adds, for (sum,
// candidate) q, its group's G sums.  A lane's candidate is fixed for the
// pass, so an item picks no candidate and adds into no array, and lanes of
// one warp step work on G consecutive edges, so a step meets few distinct
// stage functions (each item runs them through the switches, and lanes
// that reach different cases run them in turn).  A chunk above kGroup
// takes more passes, the last one with the rest.  At robust_tree (E = 50,
// B = 4096, 6 candidates) that is 4096 warps, 306 items over 30 lanes (G =
// 5), where one thread per (scenario, candidate) walking the 51 nodes and
// 50 edges in turn gave 768 warps of one long dependent chain each.
// scripts/ls_probe_variants.py --tree timed the alternatives (PERF.md):
// items over all lanes stage-major within a candidate (item j = k wn +
// (e - w0) to lane j mod L, as the chain probe) and candidate-minor (j =
// (e - w0) kc + k), each item picking its candidate and adding into 18
// sums that team::team_sum added; lane groups with the root on one lane
// and that butterfly; windows of 32 edges; register caps.
//
// Summation order.  Per candidate, lane g of its group adds its items in
// turn, e increasing (an item's f term is edge_cost + the child's
// node_cost, its theta term the L1 residual summed over the entries in
// order, its logb term the control-bound terms then the child's
// state-bound terms, in order; the root's f term is its node cost, its
// theta term the root row, its logb term its state-bound terms); then
// one lane adds the group's lane sums, g increasing.  That is neither the
// TPU kernel's order (nodes, then edges, then the root row:
// pallas_ls.py:415-468) nor the twins' in ops/ls_probe.py: each sum is
// within (ceil((E + 1) / G) + min(G, E + 1) - 1) <= E + 1 float32
// epsilons times the sum of its terms' magnitudes of the exact sum of the
// same terms, and tests/test_torch_tree_probe_host.py holds it within
// (E + 1) of them of a float64 sequential sum, and within 2e-5 relative of
// the twin (tests/test_pallas_ls.py's bar).
//
// Confinement.  A team reads only its scenario's rows, a lane's items go
// only into its own candidate's sums, and lanes without an item, and teams
// past the batch, add nothing: a NaN stays in its scenario, a -inf in its
// candidate's logb.
//
// What bounds it: issuing the items' instructions (robust_tree: a double
// integrator's few operations per edge and two precise logf of the
// control bounds, ~27 SASS instructions each: ~100 per item) at 30 of 32
// lanes busy; the bytes (x, dx, u, du once per scenario) take ~1.5 us of
// it at the card's memory rate.  See PERF.md for the bound at the main
// path's shapes and the times measured.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ls_probe_tree {

constexpr int kThreads = 128;
constexpr int kGroup = 6;       // candidates of a pass (the path's chunk)
constexpr int kMaxWindow = 64;  // edges of a window at most

// dynamic shared memory a block may hold on sm_90
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int align4(int v) { return (v + 3) / 4 * 4; }

// log of a bound distance; -inf for a non-positive (or NaN) distance, so
// infeasible candidates are rejected exactly like the standard probe
// (pallas_ls.py:401-402)
__device__ __forceinline__ float safe_log(float d) {
  return d > 0.0f ? logf(fmaxf(d, 1e-30f)) : -INFINITY;
}

// Lanes of a scenario's team: the power of two at or above the E + 1
// items of a candidate, at least 8 (a pass's kGroup candidates each take a
// group of lanes), at most a warp.
__host__ __device__ constexpr int team_lanes(int E) {
  int lanes = 8;
  while (lanes < 32 && lanes < E + 1) lanes *= 2;
  return lanes;
}
static_assert(team_lanes(0) >= kGroup, "a lane for each candidate");

// The lanes of the caller's team within its warp.
template <int L>
__device__ __forceinline__ unsigned team_mask(int tid) {
  if constexpr (L == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
  }
}

// A row of K floats in shared memory: its stride, 16-byte aligned with an
// odd number of 16-byte units when K is a multiple of 4 (the 8 lanes of a
// quarter-warp reading consecutive rows as float4 hit distinct banks), else
// odd (consecutive rows read as scalars hit distinct banks).
__host__ __device__ constexpr int row_stride(int K) {
  return K % 4 == 0 ? (K / 4 % 2 == 1 ? K : K + 4) : (K | 1);
}

// `rows` rows of K contiguous floats of device memory at `src` into shared
// memory rows of stride P at `dst`, by the team's L lanes on consecutive
// addresses.
template <int L, int K, int P>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int r) {
  for (int f = r; f < rows * K; f += L) dst[(f / K) * P + f % K] = src[f];
}

// Floats of a team's shared memory: a window of w edges' parent rows
// (slots 0 .. w - 1) and child rows (slots w .. 2 w - 1) of x and of dx
// (rows of pn floats), its rows of u and du (pm floats), and the lanes' 3 L
// sums, each region 16-byte aligned.
__host__ __device__ constexpr int team_floats(int w, int pn, int pm,
                                              int L) {
  return 2 * align4(2 * w * pn) + 2 * align4(w * pm) +
         align4(3 * L);
}

// Edges of a window: the power of two at or above E + 1, at most
// kMaxWindow, halved while the block's windows exceed the shared memory a
// block may hold (at large n; not below L).
__host__ __device__ constexpr int window_edges(int E, int pn, int pm,
                                               int L) {
  int w = 1;
  while (w < kMaxWindow && w < E + 1) w *= 2;
  while (w > L && kThreads / L * team_floats(w, pn, pm, L) * 4 >
                      kMaxSmem)
    w /= 2;
  return w;
}

// The shared-memory map of a team (team_floats).
template <class Model>
struct Cfg {
  static constexpr int E = Model::kEdges, N = Model::N, M = Model::M;
  static constexpr int L = team_lanes(E), kTeams = kThreads / L;
  static constexpr int PN = row_stride(N),
                       PM = row_stride(M);
  static constexpr int W = window_edges(E, PN, PM, L);
  static constexpr int kXRows = align4(2 * W * PN),
                       kURows = align4(W * PM);
  static constexpr int kX = 0, kDX = kXRows, kU = 2 * kXRows,
                       kDU = kU + kURows, kSums = kDU + kURows;
  static constexpr int kTeamFloats = team_floats(W, PN, PM, L);
  static constexpr int kSmem = kTeams * kTeamFloats * 4;
  static_assert(kSmem <= kMaxSmem, "the block's windows fit");
};

// The parent and child rows of x and dx of the window's `wn` edges from
// w0, gathered through the model's tables by the team's L lanes: row
// slot j holds edge w0 + j's parent, slot W + j its child.
template <class Model>
__device__ __forceinline__ void gather_nodes(float* sm, const float* xb,
                                             const float* dxb, int w0,
                                             int wn, int r) {
  using C = Cfg<Model>;
  constexpr int N = C::N, PN = C::PN, L = C::L, W = C::W;
  for (int f = r; f < wn * N; f += L) {
    const int j = f / N, c = f % N;
    const int p = Model::parent(w0 + j) * N + c,
              ch = Model::child(w0 + j) * N + c;
    sm[C::kX + j * PN + c] = xb[p];
    sm[C::kDX + j * PN + c] = dxb[p];
    sm[C::kX + (W + j) * PN + c] = xb[ch];
    sm[C::kDX + (W + j) * PN + c] = dxb[ch];
  }
}

// Item (e, a): edge e's and its child node's terms at candidate step `a`,
// the window's rows in shared memory (parent at xs, dxs; child a W-row
// block further; u_e at us, du_e at dus): f, theta (the L1 residual) and
// logb.
template <class Model>
__device__ __forceinline__ void item_terms(int e, const float* xs,
                                           const float* dxs, const float* us,
                                           const float* dus, float a,
                                           float& f, float& th, float& lb) {
  using C = Cfg<Model>;
  constexpr int N = C::N, M = C::M, CH = C::W * C::PN;
  float xp[N], xc[N], ue[M], pred[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    xp[j] = xs[j] + a * dxs[j];
    xc[j] = xs[CH + j] + a * dxs[CH + j];
  }
#pragma unroll
  for (int j = 0; j < M; ++j) ue[j] = us[j] + a * dus[j];
  Model::dynamics(e, xp, ue, pred);
  th = fabsf(pred[0] - xc[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) th += fabsf(pred[j] - xc[j]);
  f = Model::edge_cost(e, xp, ue) + Model::child_cost(e, xc);
  lb = Model::edge_logb(ue, xc);
}

// Up to kGroup candidates a pass, kc of them: lane r = k G + g (G = L /
// kc) takes candidate k0 + k and the items e = g, g + G, ... of 0 .. E,
// item E the root (lanes from kc G on take none).  The edges go in
// windows of W: the team gathers a window's rows into shared memory, then
// each lane adds its items of the window into its three sums.  Then lane q
// of the team adds, for (sum, candidate) q, the G lanes' sums in lane
// order and writes it.
template <class Model>
__global__ void __launch_bounds__(kThreads)
probe_tree_kernel(int B, int chunk, const float* __restrict__ x,
                  const float* __restrict__ dx, const float* __restrict__ u,
                  const float* __restrict__ du, const float* __restrict__ x0,
                  const float* __restrict__ alphas, long long a_sb,
                  long long a_sk, float* __restrict__ f_out,
                  float* __restrict__ th_out, float* __restrict__ lb_out) {
  using C = Cfg<Model>;
  constexpr int NN = Model::kNodes, E = C::E, N = C::N, M = C::M,
                R = Model::kRoot, L = C::L, W = C::W;
  extern __shared__ float4 smem4[];  // 16-byte aligned
  const int r = threadIdx.x % L, team_id = threadIdx.x / L;
  float* sm = reinterpret_cast<float*>(smem4) + team_id * C::kTeamFloats;
  float* sums = sm + C::kSums;
  const long long b =
      static_cast<long long>(blockIdx.x) * C::kTeams + team_id;
  // a team past the batch copies, adds and writes nothing, but takes part
  // in its warp's barriers
  const bool valid = b < B;
  const long long bv = valid ? b : 0;
  const unsigned mask = team_mask<L>(threadIdx.x);
  const float* xb = x + bv * NN * N;
  const float* dxb = dx + bv * NN * N;
  const float* ub = u + bv * E * M;
  const float* dub = du + bv * E * M;

#pragma unroll 1
  for (int k0 = 0; k0 < chunk; k0 += kGroup) {
    const int kc = chunk - k0 < kGroup ? chunk - k0 : kGroup;
    const int G = L / kc, k = r / G, g = r - k * G;
    const bool busy = valid && k < kc;
    const float a = alphas[bv * a_sb + (k0 + (busy ? k : 0)) * a_sk];
    float f = 0.0f, th = 0.0f, lb = 0.0f;
    int e = g;  // the lane's next item
#pragma unroll 1
    for (int w0 = 0; w0 < E; w0 += W) {
      const int wn = E - w0 < W ? E - w0 : W;  // edges in the window
      __syncwarp(mask);  // the previous window's items are done
      if (valid) {
        gather_nodes<Model>(sm, xb, dxb, w0, wn, r);
        copy_rows<L, M, C::PM>(sm + C::kU, ub + w0 * M, wn, r);
        copy_rows<L, M, C::PM>(sm + C::kDU, dub + w0 * M, wn, r);
      }
      __syncwarp(mask);
#pragma unroll 1
      for (; busy && e < w0 + wn; e += G) {
        const int tl = e - w0;
        float fe, the, lbe;
        item_terms<Model>(e, sm + C::kX + tl * C::PN,
                          sm + C::kDX + tl * C::PN, sm + C::kU + tl * C::PM,
                          sm + C::kDU + tl * C::PM, a, fe, the, lbe);
        f += fe;
        th += the;
        lb += lbe;
      }
    }
    if (busy && e == E) {  // the root: its cost, the root row, its bounds
      float xr[N];
#pragma unroll
      for (int j = 0; j < N; ++j) xr[j] = xb[R * N + j] + a * dxb[R * N + j];
      float th_r = fabsf(x0[bv * N] - xr[0]);
#pragma unroll
      for (int j = 1; j < N; ++j) th_r += fabsf(x0[bv * N + j] - xr[j]);
      f += Model::root_cost(xr);
      th += th_r;
      lb += Model::node_logb(xr);
    }
    __syncwarp(mask);  // the previous pass's sums are read
    sums[r] = f;
    sums[L + r] = th;
    sums[2 * L + r] = lb;
    __syncwarp(mask);
#pragma unroll 1
    for (int q = r; valid && q < 3 * kc; q += L) {
      const int what = q / kc, kq = q - what * kc;
      const float* s = sums + what * L + kq * G;
      float total = s[0];
      for (int j = 1; j < G; ++j) total += s[j];
      float* out = what == 0 ? f_out : what == 1 ? th_out : lb_out;
      out[b * chunk + k0 + kq] = total;
    }
  }
}

// The launch at batch B: grid, block, dynamic shared memory bytes, the
// lanes of a scenario's team (and edges of a window).
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
  auto kernel = &probe_tree_kernel<Model>;
  if (cfg[2] > 48 * 1024) {  // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cfg[2]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<cfg[0], cfg[1], cfg[2], static_cast<cudaStream_t>(stream)>>>(
      B, chunk, x, dx, u, du, x0, alphas, a_sb, a_sk, f_out, th_out, lb_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ls_probe_tree
