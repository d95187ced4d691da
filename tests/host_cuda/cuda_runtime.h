// A host stand-in for the CUDA runtime, enough to compile and run
// sip_optimal_control_tpu_torch/csrc/fused_iter.cuh with a C++20 host
// compiler (tests/test_torch_fused_iter_host.py).  Every GPU thread of a
// block is an OS thread and blocks run one after another; __syncthreads
// and __syncwarp are barriers of the block and of the warp (the kernels
// call __syncwarp at points every lane of the warp reaches), the shuffles
// exchange through an array of the warp.  Dynamic shared memory is
// fused_iter::smem4, defined by the test's translation unit; launches are
// rewritten by the test into emu_launch calls.
#pragma once
#include <barrier>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__

struct alignas(16) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct EmuIndex { unsigned x, y, z; };
inline thread_local EmuIndex threadIdx, blockIdx, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline float rsqrtf(float v) { return 1.0f / sqrtf(v); }

struct EmuWarp {
  std::barrier<> bar{32};
  float slot[32];
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
};
inline thread_local EmuBlock* emu_block;
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline EmuWarp& emu_warp() { return *emu_block->warps[threadIdx.x / 32]; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp().bar.arrive_and_wait();
}
inline float emu_exchange(float v, int src) {
  EmuWarp& w = emu_warp();
  w.slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  const float r = w.slot[src];
  w.bar.arrive_and_wait();
  return r;
}
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  return emu_exchange(v, (threadIdx.x % 32 & ~(width - 1)) + src);
}
inline float __shfl_xor_sync(unsigned, float v, int off, int = 32) {
  return emu_exchange(v, threadIdx.x % 32 ^ off);
}

struct EmuCfg {
  unsigned grid, block;
  EmuCfg(dim3 g, int b, int, cudaStream_t) : grid(g.x), block(b) {}
  EmuCfg(int g, int b, int, cudaStream_t) : grid(g), block(b) {}
};
template <class K, class... A>
void emu_launch(K kernel, EmuCfg cfg, A... args) {
  for (unsigned bx = 0; bx < cfg.grid; ++bx) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(cfg.block);
    for (unsigned w = 0; w < (cfg.block + 31) / 32; ++w)
      blk.warps.push_back(std::make_unique<EmuWarp>());
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < cfg.block; ++t)
      threads.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {bx, 0, 0};
        blockDim = {cfg.block, 1, 1};
        emu_block = &blk;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
