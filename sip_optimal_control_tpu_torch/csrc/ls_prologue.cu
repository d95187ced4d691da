// The fused trip's line-search prologue for Hopper (sm_90a): each
// scenario's step limits, barrier merit, slope and infeasibility at the
// iterate, in one pass over the operands.
//
// Replaces no TPU kernel.  The JAX package leaves this block
// (sip_optimal_control_tpu/solver/fused_chain.py:295-327) to XLA, which
// fuses it; PyTorch ran it as ~140 launches over [B, N, n] tensors a trip.
// ops/ls_probe.py::ls_prologue_reference is that block, the plain twin.
// For each scenario b, with the bounds lo, hi shared by every scenario and
// tau = max(1 - mu_b, tau_min):
//   alpha_p  = min(1, -tau dl / dv  over finite lo where dv < 0,
//                     -tau du / -dv over finite hi where dv > 0),
//              dl = v - lo, du = hi - v, v the iterate, dv its direction;
//   alpha_d  = min(1, -tau zl / dzl over finite lo where dzl < 0,
//                     -tau zu / dzu over finite hi where dzu < 0);
//   theta0   = sum |cdyn|                 (the states' equality residuals);
//   phi_bar0 = f_b - mu_b (sum log max(dl, eps) + sum log max(du, eps));
//   d_phi    = sum g dv - mu_b sum dv / dl + mu_b sum dv / du,
// every sum over both leaves (states x [B, N, n], controls u [B, E, m]).
// An entry whose bound is not finite adds 1 to the minima and 0 to the
// sums, as the twin's masks make it; the kernel does not load its operands.
//
// Exact semantics.  The minima take the twin's quotients, rounded as
// PyTorch rounds them ((-tau * d) / dv: a product, then a division; no FMA
// is possible), and propagate a NaN quotient as torch.amin and
// torch.minimum do (fminf would drop it), so they are bit-equal to the
// twin's on the card.  tau and the clamp at eps (sip.py's _EPS in float32:
// 0) keep a NaN as torch.clamp does.  The sums are added in another order
// than PyTorch's reductions (each lane its entries in turn, then an xor
// butterfly over the warp), within float32 roundoff of them.
//
// Design.  The prologue reads each operand once and does a few operations
// per entry, so it is bound by bytes: at the cartpole's shape (N = 51,
// n = 4, E = 50, m = 1) a scenario reads dv, g and cdyn of the states (the
// states are unbounded) and seven control operands, 3,848 bytes.  A warp
// owns one scenario and strides over its rows, 16 bytes a lane where a
// leaf's rows are a multiple of 4 floats and its operands 16-byte aligned,
// 4 bytes a lane otherwise, so a warp's loads are consecutive addresses;
// the bounds (a few hundred floats) stay in L1.  The warp adds its lanes'
// sums and minima by shuffles, with no shared memory, and lane 0 writes the
// scenario's five outputs.  A NaN stays in its scenario.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace ls_probe {

constexpr int kPrologueWarps = 8;  // warps (scenarios) per block

// One leaf (states or controls): the rows of scenario b start at b * rows
// of each [B, rows] operand; c (the equality residuals) only on the states.
struct PrologueLeaf {
  const float* v;
  const float* dv;
  const float* g;
  const float* c;
  const float* zl;
  const float* zu;
  const float* dzl;
  const float* dzu;
  const float* lo;  // [rows], shared by every scenario
  const float* hi;
  long long rows;
  int vec;  // rows a multiple of 4 and every operand 16-byte aligned
};

struct PrologueSums {
  float ap = 1.0f, ad = 1.0f;  // the step minima
  float theta = 0.0f, logb = 0.0f, dot = 0.0f, inv_l = 0.0f, inv_u = 0.0f;
};

__device__ __forceinline__ bool bounded(float v) {
  return fabsf(v) < INFINITY;
}

// min(m, a), a NaN in either kept
__device__ __forceinline__ float min_nan(float m, float a) {
  return (a < m || a != a) ? a : m;
}

// a product rounded on its own, never contracted into an FMA with the sum
// it enters: the twin rounds mu * sum before the subtraction
__device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__device__ __forceinline__ float clamp_log(float d, float eps) {
  return logf(d < eps ? eps : d);
}

// One entry's terms; g dv is added by the caller.
__device__ __forceinline__ void add_entry(PrologueSums& s, float tau,
                                          float eps, float lo, float hi,
                                          float v, float dv, float zl,
                                          float zu, float dzl, float dzu) {
  if (bounded(lo)) {
    const float d = v - lo;
    s.logb += clamp_log(d, eps);
    s.inv_l += dv / d;
    if (dv < 0.0f) s.ap = min_nan(s.ap, (-tau * d) / dv);
    if (dzl < 0.0f) s.ad = min_nan(s.ad, (-tau * zl) / dzl);
  }
  if (bounded(hi)) {
    const float d = hi - v;
    const float ndv = -dv;
    s.logb += clamp_log(d, eps);
    s.inv_u += dv / d;
    if (ndv < 0.0f) s.ap = min_nan(s.ap, (-tau * d) / ndv);
    if (dzu < 0.0f) s.ad = min_nan(s.ad, (-tau * zu) / dzu);
  }
}

__device__ __forceinline__ float4 load4(const float* p, long long k) {
  return reinterpret_cast<const float4*>(p)[k];
}

// A leaf's rows of scenario b, lane `lane`'s share.
__device__ __forceinline__ void add_leaf(PrologueSums& s,
                                         const PrologueLeaf& L, long long b,
                                         int lane, float tau, float eps) {
  const long long base = b * L.rows;
  if (L.vec) {
    const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
    for (long long k = lane; k < L.rows / 4; k += 32) {
      const long long kb = base / 4 + k;
      const float4 lo = load4(L.lo, k), hi = load4(L.hi, k);
      const bool fl = bounded(lo.x) || bounded(lo.y) || bounded(lo.z) ||
                      bounded(lo.w);
      const bool fu = bounded(hi.x) || bounded(hi.y) || bounded(hi.z) ||
                      bounded(hi.w);
      const float4 dv = load4(L.dv, kb), g = load4(L.g, kb);
      if (L.c) {
        const float4 c = load4(L.c, kb);
        s.theta += fabsf(c.x) + fabsf(c.y) + fabsf(c.z) + fabsf(c.w);
      }
      s.dot += g.x * dv.x + g.y * dv.y + g.z * dv.z + g.w * dv.w;
      float4 v = zero, zl = zero, dzl = zero, zu = zero, dzu = zero;
      if (fl || fu) v = load4(L.v, kb);
      if (fl) {
        zl = load4(L.zl, kb);
        dzl = load4(L.dzl, kb);
      }
      if (fu) {
        zu = load4(L.zu, kb);
        dzu = load4(L.dzu, kb);
      }
      add_entry(s, tau, eps, lo.x, hi.x, v.x, dv.x, zl.x, zu.x, dzl.x,
                dzu.x);
      add_entry(s, tau, eps, lo.y, hi.y, v.y, dv.y, zl.y, zu.y, dzl.y,
                dzu.y);
      add_entry(s, tau, eps, lo.z, hi.z, v.z, dv.z, zl.z, zu.z, dzl.z,
                dzu.z);
      add_entry(s, tau, eps, lo.w, hi.w, v.w, dv.w, zl.w, zu.w, dzl.w,
                dzu.w);
    }
    return;
  }
  for (long long j = lane; j < L.rows; j += 32) {
    const long long i = base + j;
    const float lo = L.lo[j], hi = L.hi[j];
    const bool fl = bounded(lo), fu = bounded(hi);
    const float dv = L.dv[i];
    if (L.c) s.theta += fabsf(L.c[i]);
    s.dot += L.g[i] * dv;
    const float v = (fl || fu) ? L.v[i] : 0.0f;
    add_entry(s, tau, eps, lo, hi, v, dv, fl ? L.zl[i] : 0.0f,
              fu ? L.zu[i] : 0.0f, fl ? L.dzl[i] : 0.0f,
              fu ? L.dzu[i] : 0.0f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out [5, B]: alpha_p, alpha_d, theta0, phi_bar0, d_phi
__global__ void __launch_bounds__(32 * kPrologueWarps)
    ls_prologue_kernel(int B, PrologueLeaf x, PrologueLeaf u,
                       const float* __restrict__ f,
                       const float* __restrict__ mu, float tau_min, float eps,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long b =
      static_cast<long long>(blockIdx.x) * kPrologueWarps + threadIdx.x / 32;
  if (b >= B) return;  // the whole warp
  const float m = mu[b];
  const float t = 1.0f - m;
  const float tau = t < tau_min ? tau_min : t;
  PrologueSums s;
  add_leaf(s, x, b, lane, tau, eps);
  add_leaf(s, u, b, lane, tau, eps);
  const float ap = warp_min(s.ap), ad = warp_min(s.ad);
  const float theta = warp_sum(s.theta), logb = warp_sum(s.logb);
  const float dot = warp_sum(s.dot), inv_l = warp_sum(s.inv_l);
  const float inv_u = warp_sum(s.inv_u);
  if (lane == 0) {
    out[b] = ap;
    out[B + b] = ad;
    out[2LL * B + b] = theta;
    out[3LL * B + b] = f[b] - mul_rn(m, logb);
    out[4LL * B + b] = (dot - mul_rn(m, inv_l)) + mul_rn(m, inv_u);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline PrologueLeaf leaf(long long rows, const float* v, const float* dv,
                         const float* g, const float* c, const float* zl,
                         const float* zu, const float* dzl, const float* dzu,
                         const float* lo, const float* hi) {
  PrologueLeaf L{v, dv, g, c, zl, zu, dzl, dzu, lo, hi, rows, 0};
  bool vec = rows % 4 == 0;
  for (const float* p : {v, dv, g, c, zl, zu, dzl, dzu, lo, hi})
    vec = vec && (p == nullptr || aligned16(p));
  L.vec = vec;
  return L;
}

}  // namespace ls_probe

// Operands per leaf: the iterate, its direction, the objective gradient,
// the residuals (states only; null for the controls), the bound
// multipliers zl, zu and their directions, the bounds lo, hi.
extern "C" int ls_prologue_f32(
    int B, long long x_rows, long long u_rows, const float* x,
    const float* dx, const float* gx, const float* cdyn, const float* zlx,
    const float* zux, const float* dzlx, const float* dzux, const float* lox,
    const float* hix, const float* u, const float* du, const float* gu,
    const float* cu, const float* zlu, const float* zuu, const float* dzlu,
    const float* dzuu, const float* lou, const float* hiu, const float* f,
    const float* mu, float tau_min, float eps, float* out, void* stream) {
  using namespace ls_probe;
  if (B <= 0) return 0;
  const PrologueLeaf xl =
      leaf(x_rows, x, dx, gx, cdyn, zlx, zux, dzlx, dzux, lox, hix);
  const PrologueLeaf ul =
      leaf(u_rows, u, du, gu, cu, zlu, zuu, dzlu, dzuu, lou, hiu);
  const int grid = (B + kPrologueWarps - 1) / kPrologueWarps;
  ls_prologue_kernel<<<grid, 32 * kPrologueWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      B, xl, ul, f, mu, tau_min, eps, out);
  return static_cast<int>(cudaGetLastError());
}
