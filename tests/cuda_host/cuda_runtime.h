// A host stand-in for the CUDA runtime, enough to build
// tpusim_torch/csrc/xoroshiro.cu with g++ and run its kernel on the CPU
// (tests/test_torch_xoro_host.py). Build with -ffp-contract=off, so that
// every double operation rounds once, as the intrinsics below promise.
//
// A launch runs its blocks one after another; a block's threads run as
// host threads, side by side. The kernel's block-level hooks are defined
// here: its dynamic shared memory (a buffer a block, filled with garbage),
// __syncthreads (block_sync) and its named barriers (barrier_arrive,
// barrier_wait), each a std::barrier over all the block's threads.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
using cudaStream_t = void*;

struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  void* attrs;
  unsigned numAttrs;
};

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

using std::max;
using std::min;

inline int __double2hiint(double x) {
  uint64_t b;
  std::memcpy(&b, &x, 8);
  return static_cast<int>(static_cast<uint32_t>(b >> 32));
}

inline int __double2loint(double x) {
  uint64_t b;
  std::memcpy(&b, &x, 8);
  return static_cast<int>(static_cast<uint32_t>(b));
}

inline double __hiloint2double(int hi, int lo) {
  const uint64_t b = (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
                     static_cast<uint32_t>(lo);
  double x;
  std::memcpy(&x, &b, 8);
  return x;
}

inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __fma_rn(double a, double b, double c) { return ::fma(a, b, c); }

// The block a host thread runs in: its shared memory and its barriers (0 for
// block_sync, 1-15 the named ones).
struct HostBlock {
  std::vector<unsigned char> smem;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
};
inline thread_local HostBlock* host_block;

inline unsigned char* block_smem() { return host_block->smem.data(); }
inline void block_sync() { host_block->bars[0]->arrive_and_wait(); }
inline void barrier_arrive(int id) { (void)host_block->bars[id]->arrive(); }
inline void barrier_wait(int id) { host_block->bars[id]->arrive_and_wait(); }

template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}

template <typename... Exp, typename... Act>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(Exp...),
                               Act&&... args) {
  blockDim = cfg->blockDim;
  gridDim = cfg->gridDim;
  const unsigned n = cfg->blockDim.x;
  for (unsigned b = 0; b < cfg->gridDim.x; ++b) {
    HostBlock block;
    block.smem.assign(cfg->dynamicSmemBytes, 0xA5);
    for (int i = 0; i < 16; ++i) block.bars.push_back(std::make_unique<std::barrier<>>(n));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < n; ++t) {
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        host_block = &block;
        kernel(static_cast<Exp>(args)...);
      });
    }
    for (auto& th : threads) th.join();
  }
  return cudaSuccess;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : "invalid argument";
}
