// Team primitives of the Hopper kernels: a team of L lanes of one warp owns
// one scenario of a batched chain recursion and shares its n x n algebra.
//
// Included by csrc/fused_iter.cuh (the fused factor and solve kernels) and
// csrc/riccati.cu (the standard iteration's Gram-form factor and backward
// vector pass): the Cholesky of F = I + d V column by column with the pivot
// shuffled to the team (team_chol), the Gram-form edge step with the
// Riccati operands read through accessors (team_gram_step), the triangular
// solves of a vector through a stored factor (team_cho_solve), butterflies
// over the team (team_sum), and the asynchronous copies global -> shared and
// the shared-memory sizing that both files' kernels use.  Compiled for the
// host by tests/test_torch_fused_iter_host.py and
// tests/test_torch_riccati_host.py against tests/host_cuda/cuda_runtime.h.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace team {

constexpr int kPackN = 6;  // ops/fused_iter.py: PACK_N

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__host__ __device__ constexpr int align4(int v) { return (v + 3) / 4 * 4; }

// dynamic shared memory a block may hold on sm_90
constexpr int kMaxSmem = 232448;

// A scenario's stride in shared memory for `used` floats of its regions:
// team design 4 mod 8 (16-byte aligned regions, two teams of a warp on
// distinct banks), thread design odd (a row read across the block's
// scenarios on distinct banks).
__host__ __device__ constexpr int block_stride(bool team, int used) {
  return team ? (used + 7) / 8 * 8 + 4 : used | 1;
}

// Shared memory of an SM (228 KB), and the scenarios an SM holds at once
// so that the main path's 4096 run in one wave on 132 SMs: a solve block of
// s scenarios may take its share of the SM's shared memory, less the 1 KB
// the runtime keeps per block.
constexpr int kSmemPerSM = 233472;
constexpr int kScenariosPerSM = 32;
__host__ __device__ constexpr int solve_smem(int s) {
  return kSmemPerSM / (kScenariosPerSM / s) - 1024;
}

// The lanes of the caller's team within its warp.
template <int L>
__device__ __forceinline__ unsigned team_mask(int tid) {
  if constexpr (L == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << L) - 1u) << ((tid & 31) & ~(L - 1));
  }
}

// Asynchronous copies global -> shared (sm_80+), committed in groups.
// Compiled for the host (tests/host_cuda/cuda_runtime.h), plain copies.
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
// Asynchronous 16-byte copy global -> shared (both addresses 16-byte
// aligned), bypassing L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  for (int k = 0; k < 4; ++k) dst[k] = src[k];
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

// Row (i, j) of a Cholesky factor in shared memory: at kLd = 0 the stored
// symmetric / triangular layout (sym_row), else row-major with leading
// dimension kLd.
template <int N, int kLd>
__device__ __forceinline__ int factor_row(int i, int j) {
  if constexpr (kLd == 0) {
    return sym_row<N>(i, j);
  } else {
    return i * kLd + j;
  }
}

// R rows of C contiguous floats at `src` (global) into shared memory at
// `dst`, row i at dst + i * kLd, by the team's L lanes (lane r starts at
// element r): cp.async of 16 bytes where the rows allow it (C and kLd
// multiples of 4, `src` and `dst` 16-byte aligned), else of 4 bytes;
// consecutive lanes on consecutive addresses.
template <int L, int R, int C, int kLd = C>
__device__ __forceinline__ void team_copy(float* dst, const float* src,
                                          int r) {
  if constexpr (C % 4 == 0 && kLd % 4 == 0) {
    if (((reinterpret_cast<uintptr_t>(src) |
          reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
      constexpr int Q = C / 4;
#pragma unroll
      for (int f = r; f < R * Q; f += L)
        cp_async16(dst + (f / Q) * kLd + 4 * (f % Q), src + 4 * f);
      return;
    }
  }
#pragma unroll
  for (int f = r; f < R * C; f += L)
    cp_async4(dst + (f / C) * kLd + f % C, src + f);
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

// A [N][N] and B [N][M], row-major and contiguous at `jac`, become [Ah Bh]
// = d^-1/2 [A B] by columns in place: column c at c * N, row k scaled by
// sdi(k).  Lane r holds columns r, r + L, ... while the team swaps them.
template <int N, int M, int L, class Sdi>
__device__ __forceinline__ void team_scale_columns(float* jac, Sdi sdi,
                                                   int r, unsigned mask) {
  constexpr int W = N + M, NC = (W + L - 1) / L;
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
      if (r + q * L < W) jac[(r + q * L) * N + k] = sdi(k) * col[q][k];
  __syncwarp(mask);
}

// The Gram-form edge step by a team (pallas_riccati.py::_gram_core's
// arithmetic; ops/riccati_cuda.py::_gram_core is its twin), on ab = [Ah Bh]
// by columns: lane c solves column c of Z = Lf^-1 [Ah Bh] (and columns
// c + L, ...), lane (i, j) entry G[i][j] of the upper triangle (and entries
// i * M + j + L, ...), lane j column j of H and K, lane i row i of V_parent
// (entry (i, j) as _gram_core's (min, max) entry, so V_parent is exactly
// symmetric).  Q, R and M are read by entry through q_at(i, j), r_at(i, j)
// and m_at(i, j) (Q and R symmetrized as _gram_core reads them).  A lane
// keeps its own columns in registers and reads the others' from shared
// memory, where every lane of the team reads the same column (a broadcast).
template <int N, int M, int L, class QAt, class RAt, class MAt>
__device__ __forceinline__ void team_gram_step(
    const float* ab, QAt q_at, RAt r_at, MAt m_at, int r, unsigned mask,
    const float* lf, float* kk, float* g, float* scr, float (&vrow)[N]) {
  constexpr int W = N + M;
  float* Z = scr;        // [W][N]: column c of Z at c * N
  float* H = Z + W * N;  // [N][M]: column j of H at j * M
  float* G = H + N * M;  // [M][M]
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
      h[i] = m_at(j, i) + s;
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

// x = F^-1 b through F's Cholesky factor `lf` (shared memory, at
// factor_row<N, kLd>: lower-packed, or row-major with leading dimension
// kLd) by a team, lane i holding b_i and receiving x_i: forward then back
// substitution, each solved entry shuffled from its lane to the team and
// folded by the others into their partial sums (forward in
// riccati::tri_solve_vec's order; backward from the last row up).  A lane
// keeps its row and column of the factor in registers.
template <int N, int L, int kLd = 0>
__device__ __forceinline__ float team_cho_solve(const float* lf, float b,
                                                int r, unsigned mask) {
  const int ro = r < N ? r : 0;
  float lrow[N], lcol[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    lrow[k] = k < ro ? lf[factor_row<N, kLd>(ro, k)] : 0.0f;
    lcol[k] = k > ro ? lf[factor_row<N, kLd>(k, ro)] : 0.0f;
  }
  const float inv = 1.0f / lf[factor_row<N, kLd>(ro, ro)];
  float acc = b, t = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float tj = __shfl_sync(mask, acc * inv, j, L);
    t = r == j ? tj : t;
    acc -= lrow[j] * tj;
  }
  acc = t;
  float x = 0.0f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    const float xj = __shfl_sync(mask, acc * inv, j, L);
    x = r == j ? xj : x;
    acc -= lcol[j] * xj;
  }
  return x;
}

// Each of the K partial sums summed over the team's lanes by an xor
// butterfly; every lane receives the sums.
template <int K, int L>
__device__ __forceinline__ void team_sum(float (&p)[K], unsigned mask) {
#pragma unroll
  for (int off = L / 2; off >= 1; off /= 2)
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] += __shfl_xor_sync(mask, p[i], off, L);
}

// A kernel's dynamic shared memory (Cfg::kSmem), with the SM's carveout at
// its largest so that the blocks of 32 scenarios (solve_smem) share an SM.
template <class Cfg, class Kernel>
cudaError_t solve_attributes(Kernel kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace team
