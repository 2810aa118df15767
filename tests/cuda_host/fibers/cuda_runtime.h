// A host stand-in for the CUDA runtime that runs a kernel whose threads meet
// at warp collectives: tpusim_torch/csrc/event_loop.cu built with g++
// (tests/test_torch_fast_selfish_kernel_host.py). A launch runs its blocks
// one after another; a block's threads are fibers (ucontext) of one host
// thread, switched round-robin. Each collective is a barrier over the
// lanes of its mask, keyed by (warp, mask): the last lane to arrive
// computes every lane's result, the others wait for it, so lanes of one
// mask that meet at different collectives, or a block in which no thread
// can move, abort (on the card the first is undefined and the second a
// hang). __syncthreads is a barrier over the block. The source's launch
// (`kernel<<<grid, block, smem, stream>>>(args)`) becomes host_launch(kernel,
// grid, block, smem, args) and its dynamic shared memory
// `host_smem()`, a buffer a block filled with garbage. Everything here has
// internal linkage (an unnamed namespace): a process that loads libraries
// built against tests/cuda_host/cuda_runtime.h too must not bind one's
// inline variables to the other's.
#pragma once

#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

namespace {

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
using cudaStream_t = void*;
using std::max;
using std::min;

struct HostFiber {
  ucontext_t ctx;
  std::vector<char> stack;
  dim3 tid;
  bool done = false;
};

// One collective of one mask in one warp: the lanes arrived, the values
// they brought and the results.
struct HostMeet {
  unsigned arrived = 0;
  long gen = 0;
  int op = -1;
  long long vals[32], res[32];
  int arg[32];
};

struct HostBlock {
  std::vector<HostFiber> fibers;
  ucontext_t main;
  int cur = 0;
  dim3 bid, bdim, gdim;
  std::vector<unsigned char> smem;
  std::vector<std::map<unsigned, HostMeet>> warps;
  int bar_arrived = 0;
  long bar_gen = 0;
  bool moved = false;
  std::function<void()> body;
};
HostBlock* host_block = nullptr;

#define threadIdx (host_block->fibers[host_block->cur].tid)
#define blockIdx (host_block->bid)
#define blockDim (host_block->bdim)
#define gridDim (host_block->gdim)

inline unsigned char* host_smem() { return host_block->smem.data(); }
inline void host_yield() {
  swapcontext(&host_block->fibers[host_block->cur].ctx, &host_block->main);
}

enum { kHostMax, kHostMin, kHostAdd, kHostBallot, kHostShfl, kHostAny, kHostSync };

inline long long host_collective(int op, unsigned mask, long long v, int arg) {
  const unsigned tid = threadIdx.x;
  const int lane = tid % 32;
  HostMeet& m = host_block->warps[tid / 32][mask];
  if (!((mask >> lane) & 1u) || (m.arrived != 0 && m.op != op)) {
    fprintf(stderr, "thread %u: collective %d on mask %x, lanes there at %d\n", tid, op, mask,
            m.op);
    abort();
  }
  m.op = op;
  m.vals[lane] = v;
  m.arg[lane] = arg;
  m.arrived |= 1u << lane;
  host_block->moved = true;
  if (m.arrived == mask) {
    long long acc = 0;
    bool first = true;
    for (int l = 0; l < 32; ++l) {
      if (!((mask >> l) & 1u)) continue;
      const long long x = m.vals[l];
      if (op == kHostMax) acc = first ? x : std::max(acc, x);
      if (op == kHostMin) acc = first ? x : std::min(acc, x);
      if (op == kHostAdd) acc += x;
      if (op == kHostBallot || op == kHostAny) acc |= x ? 1ll << l : 0;
      first = false;
    }
    for (int l = 0; l < 32; ++l) {
      const int width = m.arg[l] >> 8, src = m.arg[l] & 0xFF;
      if (!((mask >> l) & 1u)) continue;
      m.res[l] = op == kHostShfl ? m.vals[(l & ~(width - 1)) + src % width]
                 : op == kHostAny ? acc != 0 : acc;
    }
    m.arrived = 0;
    ++m.gen;
    return m.res[lane];
  }
  const long gen = m.gen;
  while (m.gen == gen) host_yield();
  return m.res[lane];
}

inline int __reduce_max_sync(unsigned m, int v) { return host_collective(kHostMax, m, v, 0); }
inline int __reduce_min_sync(unsigned m, int v) { return host_collective(kHostMin, m, v, 0); }
inline int __reduce_add_sync(unsigned m, int v) { return host_collective(kHostAdd, m, v, 0); }
inline unsigned __ballot_sync(unsigned m, bool p) {
  return static_cast<unsigned>(host_collective(kHostBallot, m, p, 0));
}
inline bool __any_sync(unsigned m, bool p) { return host_collective(kHostAny, m, p, 0) != 0; }
inline int __shfl_sync(unsigned m, int v, int src, int width = 32) {
  return static_cast<int>(host_collective(kHostShfl, m, v, (width << 8) | (src & 0xFF)));
}
inline void __syncwarp(unsigned m = 0xFFFFFFFFu) { host_collective(kHostSync, m, 0, 0); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline void __syncthreads() {
  const long gen = host_block->bar_gen;
  host_block->moved = true;
  if (++host_block->bar_arrived == static_cast<int>(host_block->bdim.x)) {
    host_block->bar_arrived = 0;
    ++host_block->bar_gen;
    return;
  }
  while (host_block->bar_gen == gen) host_yield();
}

template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t err) {
  return err == cudaSuccess ? "no error" : "invalid argument";
}

inline void host_fiber() {
  host_block->body();
  host_block->fibers[host_block->cur].done = true;
  host_block->moved = true;
  swapcontext(&host_block->fibers[host_block->cur].ctx, &host_block->main);
}

template <typename... Exp, typename... Act>
void host_launch(void (*kernel)(Exp...), dim3 grid, dim3 block, size_t smem, Act... args) {
  HostBlock hb;
  host_block = &hb;
  hb.gdim = grid;
  hb.bdim = block;
  hb.body = [&] { kernel(static_cast<Exp>(args)...); };
  for (unsigned b = 0; b < grid.x; ++b) {
    hb.bid = dim3(b);
    hb.smem.assign(smem, 0xA5);
    hb.warps.assign((block.x + 31) / 32, {});
    hb.fibers.clear();
    hb.fibers.resize(block.x);
    for (unsigned t = 0; t < block.x; ++t) {
      HostFiber& f = hb.fibers[t];
      f.tid = dim3(t);
      f.stack.resize(256 * 1024);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, host_fiber, 0);
    }
    for (bool all_done = false; !all_done;) {
      all_done = true;
      hb.moved = false;
      for (unsigned t = 0; t < block.x; ++t) {
        if (hb.fibers[t].done) continue;
        hb.cur = static_cast<int>(t);
        swapcontext(&hb.main, &hb.fibers[t].ctx);
        all_done = all_done && hb.fibers[t].done;
      }
      if (!all_done && !hb.moved) {
        fprintf(stderr, "block %u: no thread can move\n", b);
        abort();
      }
    }
  }
  host_block = nullptr;
}

}  // namespace
