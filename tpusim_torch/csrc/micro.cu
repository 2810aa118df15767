// Layout micro-benchmarks (S1) for Hopper (sm_90a).
//
// Replaces the seven kernels of scripts/mosaic_micro.py (bench.make_kernel
// and timed, :91-118, pallas_call at :110): each runs N chained iterations
// of one int32 op inside one launch, the result of an iteration feeding the
// next through the accumulator, so no iteration is dead code. The ops, on
// the exact kernel's shapes with M = 9 (runs-last, R lanes):
//   0 sel3      acc' = where(c1 + acc[0,0,0] > 1, val[o], where(c2 > 1, cp, acc)) + cp
//               on (M, M, M, R), conditions (M, M, 1, R), val (M, R)
//   1 sel_flat  the same on (M^3, R) rows with conditions and values per row
//   2 reshape   acc' = reshape(reshape(x + acc, (M^2, R)) + 1, (M, M, R))
//   3 repeat    acc'[i*M + j] = src[i] + acc[i], (M, R) -> (M^2, R)
//   4 tile      acc'[i*M + j] = src[j] + acc[j]
//   5 segsum    acc'[i] = sum_j (x[i*M + j] + acc[0]), (M^2, R) -> (M, R)
//   6 contract  acc'[j, o] = sum_i cp[i, j, o] * b[i] + acc[j, o], the cpb
//               contraction of the one-hot exact kernel (K5b)
// The plain PyTorch versions are tpusim_torch/micro.py.
//
// Design. One thread owns one lane r and walks its N iterations in order;
// its accumulator lives in the output, runs-last, so a warp's access to one
// entry is 32 neighbouring words, and an iteration reads and rewrites it in
// place (an entry that the iteration reads from elsewhere, acc[0] or the
// first M rows, is read into registers before any write). The pointers may
// alias, so no load can move above an earlier store: the ops over M^3
// entries load a group of M entries (sel3, sel_flat) or M rows of cp
// (contract) before they store any. A GPU has no sublane padding, so the
// layout question of the TPU original (what Mosaic's relayouts cost) does
// not arise here: the (M, M, R) <-> (M^2, R) reshape is the same memory,
// and only the ops' arithmetic and accesses remain.
//
// Arithmetic. The reference adds in int32, which wraps (segsum's
// accumulator grows ninefold an iteration and passes 2^31 within ten), and
// signed overflow is undefined in CUDA C++, so every sum is taken in
// uint32_t, which wraps to the same bits; comparisons read the bits back as
// int32.
//
// What bounds it. Per iteration the ops need at most 4,374 int32 operations
// a lane (sel_flat) and no memory traffic beyond reading each input and
// writing the output once, so operations bound them all; at R = 8192 and
// N = 512 that is 0.02-1.1 ms, and chip_smoke.py counts each op's bound. In
// practice each iteration re-reads the inputs and the accumulator through
// L1 and L2, one dependent chain a thread.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int M = 9;
constexpr int kThreads = 128;
using u32 = uint32_t;

__device__ __forceinline__ int as_int(u32 x) { return static_cast<int>(x); }

struct Ops {
  const int* in[4];
  u32* acc;
  int iters;
  long R;
};

__global__ void __launch_bounds__(kThreads) sel3_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int *cp = a.in[0] + r, *c1 = a.in[1] + r, *c2 = a.in[2] + r;
  u32* acc = a.acc + r;
  u32 val[M];
#pragma unroll
  for (int o = 0; o < M; ++o) val[o] = static_cast<u32>(a.in[3][o * R + r]);
  for (int e = 0; e < M * M * M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
    const u32 a0 = acc[0];
    for (int ij = 0; ij < M * M; ++ij) {
      const bool s1 = as_int(static_cast<u32>(c1[ij * R]) + a0) > 1;
      const bool s2 = c2[ij * R] > 1;
      u32 c[M], x[M];
#pragma unroll
      for (int o = 0; o < M; ++o) {
        c[o] = static_cast<u32>(cp[(ij * M + o) * R]);
        x[o] = acc[(ij * M + o) * R];
      }
#pragma unroll
      for (int o = 0; o < M; ++o) {
        acc[(ij * M + o) * R] = (s1 ? val[o] : (s2 ? c[o] : x[o])) + c[o];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) sel_flat_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int *cp = a.in[0] + r, *c1 = a.in[1] + r, *c2 = a.in[2] + r, *val = a.in[3] + r;
  u32* acc = a.acc + r;
  for (int e = 0; e < M * M * M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
    const u32 a0 = acc[0];
    for (int k0 = 0; k0 < M * M * M; k0 += M) {
      u32 c[M], x[M];
#pragma unroll
      for (int u = 0; u < M; ++u) {
        const long e = (k0 + u) * R;
        c[u] = static_cast<u32>(cp[e]);
        const bool s1 = as_int(static_cast<u32>(c1[e]) + a0) > 1;
        x[u] = s1 ? static_cast<u32>(val[e]) : (c2[e] > 1 ? c[u] : acc[e]);
      }
#pragma unroll
      for (int u = 0; u < M; ++u) acc[(k0 + u) * R] = x[u] + c[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads) reshape_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int* x = a.in[0] + r;
  u32* acc = a.acc + r;
  for (int e = 0; e < M * M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
#pragma unroll 9
    for (int k = 0; k < M * M; ++k) acc[k * R] = static_cast<u32>(x[k * R]) + acc[k * R] + 1u;
  }
}

// repeat (TILE = false) and tile (TILE = true): the first M accumulator rows
// and src broadcast to M^2 rows, by the row's first or second index.
template <bool TILE>
__global__ void __launch_bounds__(kThreads) expand_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int* src = a.in[0] + r;
  u32* acc = a.acc + r;
  for (int e = 0; e < M * M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
    u32 head[M];
#pragma unroll
    for (int i = 0; i < M; ++i) head[i] = static_cast<u32>(src[i * R]) + acc[i * R];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) acc[(i * M + j) * R] = head[TILE ? j : i];
    }
  }
}

__global__ void __launch_bounds__(kThreads) segsum_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int* x = a.in[0] + r;
  u32* acc = a.acc + r;
  for (int e = 0; e < M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
    const u32 a0 = acc[0];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      u32 s = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) s += static_cast<u32>(x[(i * M + j) * R]) + a0;
      acc[i * R] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads) contract_kernel(Ops a) {
  const long r = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long R = a.R;
  const int* cp = a.in[0] + r;
  u32* acc = a.acc + r;
  u32 b[M];
#pragma unroll
  for (int i = 0; i < M; ++i) b[i] = static_cast<u32>(a.in[1][i * R + r]);
  for (int e = 0; e < M * M; ++e) acc[e * R] = 0;
  for (int n = 0; n < a.iters; ++n) {
    for (int j = 0; j < M; ++j) {
      u32 s[M];
#pragma unroll
      for (int o = 0; o < M; ++o) {
        s[o] = acc[(j * M + o) * R];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          s[o] += static_cast<u32>(cp[((i * M + j) * M + o) * R]) * b[i];
        }
      }
#pragma unroll
      for (int o = 0; o < M; ++o) acc[(j * M + o) * R] = s[o];
    }
  }
}

}  // namespace

extern "C" {

// Launch op `op` (0..6, in the order above) on `stream`: `ins` holds its
// inputs' device addresses (int32, runs-last, R lanes), `out` its int32
// accumulator, which the kernel zeroes and then updates `iters` times.
// Returns the launch's cudaError_t (0 on success).
int tpusim_micro_launch(int op, void* const* ins, void* out, int iters, int runs,
                        void* stream) {
  if (runs <= 0 || iters < 0 || op < 0 || op > 6) return static_cast<int>(cudaErrorInvalidValue);
  Ops a{};
  const int n_in = op <= 1 ? 4 : (op == 6 ? 2 : 1);
  for (int i = 0; i < n_in; ++i) a.in[i] = static_cast<const int*>(ins[i]);
  a.acc = static_cast<u32*>(out);
  a.iters = iters;
  a.R = runs;
  const dim3 grid((runs + kThreads - 1) / kThreads), block(kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: sel3_kernel<<<grid, block, 0, s>>>(a); break;
    case 1: sel_flat_kernel<<<grid, block, 0, s>>>(a); break;
    case 2: reshape_kernel<<<grid, block, 0, s>>>(a); break;
    case 3: expand_kernel<false><<<grid, block, 0, s>>>(a); break;
    case 4: expand_kernel<true><<<grid, block, 0, s>>>(a); break;
    case 5: segsum_kernel<<<grid, block, 0, s>>>(a); break;
    default: contract_kernel<<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
