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
// Design. The TPU original loads its inputs once as values and carries the
// accumulator through its fori_loop; here registers play that part. A
// thread owns one lane r and a group of the op's entries (the k*Groups
// constants below): it loads its entries' inputs once, runs the N
// iterations with their accumulator entries in registers, and stores them
// once. Thread t takes lane t % R and group t / R, so a warp's threads are
// neighbouring lanes and every load and store is 32 neighbouring words; a
// group may straddle two blocks. An entry reads only its own inputs and, at
// most, one short chain of the lane's accumulator that reads nothing else
// (acc[0]: entry 0 reads only itself in sel3, sel_flat and segsum; repeat's
// first M rows all hold row 0's value), so each thread recomputes that chain
// from entry 0's inputs and no thread waits for another: no shared memory
// and no barrier. tests/test_torch_micro.py holds these read sets on the
// CPU.
//
// The guard. With the operands in registers the compiler could fold a
// linear chain into closed form (reshape's acc += x + 1, the adds of repeat,
// tile and segsum, contract) or hoist an op's loop-invariant part (c2 > 1,
// segsum's sum of x, contract's whole sum), and the launch would time no
// op. So every iteration passes each operand and each carried value through
// an empty asm (`opaque`), which emits no instruction and hides the value
// from nvcc's optimizer. It does not hide it from ptxas, which sees no
// instruction there: ptxas folded repeat's and tile's adds and shared
// segsum's sums across the copies of an unrolled loop, so those three loops
// are not unrolled (sel3's, sel_flat's, reshape's and contract's are, 4
// times, every copy doing its work); and it hoisted c2 > 1 out of the loop,
// so sel3 and sel_flat compare c2 with `one`, which is 1 but adds the
// launcher's zero each iteration (one uniform add a warp). The loop body
// then issues each iteration what chip_smoke.MICRO_PIPES counts, which
// chip_smoke.py's phase 2 prints from this library's SASS, and the
// reference's N/8 scaling check (micro.main) would expose a loop that did
// not. scripts/micro_variants.py times the forms without these measures.
//
// Arithmetic. The reference adds in int32, which wraps (segsum's
// accumulator grows ninefold an iteration and passes 2^31 within ten), and
// signed overflow is undefined in CUDA C++, so every sum is taken in
// uint32_t, which wraps to the same bits; comparisons read the bits back as
// int32.
//
// What bounds it. An op reads each input once and writes the accumulator
// once, a few MB at R = 8192, so its int32 instructions bound it: each
// iteration issues on the ALU pipe (ISETP, SEL, IADD3) and on the FMA pipe
// (IMAD, IMAD.IADD), which run side by side at 16 lanes an SM
// sub-partition a clock each, so the busier pipe bounds the op
// (chip_smoke.MICRO_PIPES, a lane-iteration): sel_flat 4 ALU an entry
// (2,916), sel3 2 an (i, j) and 2 an entry (1,620), contract one IMAD a cp
// entry (729), reshape one IADD3 an entry (81), segsum 8 IADD3s a row (72),
// repeat and tile one add a head row (9). The threads' copies of acc[0]'s
// chain and the loop counter come on top.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int M = 9;
constexpr int kThreads = 128;
using u32 = uint32_t;

// Threads a lane: sel3 one a group of 3 pairs (i, j) and their 3 M
// entries; sel_flat one a group of M rows; reshape, repeat and tile one a
// row of M entries (repeat i, tile j; kRowGroups); segsum one a group of 4
// of its output rows 1..M-1, with row 0 (acc[0]'s chain) in both; contract
// one a group of 3 of its M^2 entries, with their 27 cp operands. Larger
// groups repeat the chain in fewer threads, within the registers a thread
// has without spilling.
constexpr int kSel3Pairs = 3, kSel3Groups = M * M / kSel3Pairs;
constexpr int kSelFlatGroups = M * M, kRowGroups = M;
constexpr int kSegsumRows = 4, kSegsumGroups = (M - 1) / kSegsumRows;
constexpr int kContractGroup = 3, kContractGroups = M * M / kContractGroup;

__device__ __forceinline__ int as_int(u32 x) { return static_cast<int>(x); }

// The guard: `v` unknown to nvcc's optimizer from here on, at no instruction.
__device__ __forceinline__ void opaque(u32& v) { asm volatile("" : "+r"(v)); }

template <int K>
__device__ __forceinline__ void opaque(u32 (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) opaque(v[k]);
}

struct Ops {
  const int* in[4];
  int* out;
  int iters;
  int R;
  u32 zero;  // always 0; see `one` in sel3 and sel_flat
};

// This thread's lane and group of `groups`; false past the last. The
// launcher keeps R * groups under 2^31.
__device__ __forceinline__ bool slot(const Ops& a, int groups, int& r, int& g) {
  const int t = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (t >= a.R * groups) return false;
  r = t % a.R;
  g = t / a.R;
  return true;
}

// Row `row` of lane r in a runs-last array of R lanes.
__device__ __forceinline__ long at(int row, int R, int r) {
  return static_cast<long>(row) * R + r;
}

__device__ __forceinline__ u32 ld(const int* p, long i) { return static_cast<u32>(p[i]); }

// One entry of sel3 / sel_flat: where(c1 + a0 > 1, val, where(c2 > one, cp, acc)) + cp,
// `one` being 1.
__device__ __forceinline__ u32 sel(u32 cp, u32 c1, u32 c2, u32 val, u32 acc, u32 a0, u32 one) {
  return (as_int(c1 + a0) > 1 ? val : (as_int(c2) > as_int(one) ? cp : acc)) + cp;
}

// sel3: the thread of group g owns the kSel3Pairs pairs (i, j) = ij from
// g * kSel3Pairs on, their entries (i, j, 0..M-1) and their conditions
// c1[i, j], c2[i, j]; acc[0, 0, 0]'s chain reads cp[0, 0, 0], c1[0, 0],
// c2[0, 0] and val[0].
__global__ void __launch_bounds__(kThreads) sel3_kernel(Ops a) {
  constexpr int P = kSel3Pairs;
  int r, g;
  if (!slot(a, kSel3Groups, r, g)) return;
  const int R = a.R;
  u32 cp[P][M], acc[P][M], c1[P], c2[P], val[M];
#pragma unroll
  for (int o = 0; o < M; ++o) val[o] = ld(a.in[3], at(o, R, r));
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ij = g * P + p;
#pragma unroll
    for (int o = 0; o < M; ++o) cp[p][o] = ld(a.in[0], at(ij * M + o, R, r)), acc[p][o] = 0;
    c1[p] = ld(a.in[1], at(ij, R, r)), c2[p] = ld(a.in[2], at(ij, R, r));
  }
  u32 cp0 = ld(a.in[0], r), c10 = ld(a.in[1], r), c20 = ld(a.in[2], r), a0 = 0, one = 1;
#pragma unroll 4
  for (int n = 0; n < a.iters; ++n) {
#pragma unroll
    for (int p = 0; p < P; ++p) opaque(cp[p]), opaque(acc[p]);
    opaque(c1), opaque(c2), opaque(val);
    opaque(cp0), opaque(c10), opaque(c20), opaque(a0);
    one += a.zero;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bool s1 = as_int(c1[p] + a0) > 1, s2 = as_int(c2[p]) > as_int(one);
#pragma unroll
      for (int o = 0; o < M; ++o) {
        acc[p][o] = (s1 ? val[o] : (s2 ? cp[p][o] : acc[p][o])) + cp[p][o];
      }
    }
    a0 = sel(cp0, c10, c20, val[0], a0, a0, one);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int o = 0; o < M; ++o) a.out[at((g * P + p) * M + o, R, r)] = as_int(acc[p][o]);
  }
}

// sel_flat: the thread of group g owns rows g*M .. g*M + M-1 and their
// conditions and values; acc[0]'s chain reads row 0's four inputs.
__global__ void __launch_bounds__(kThreads) sel_flat_kernel(Ops a) {
  int r, g;
  if (!slot(a, kSelFlatGroups, r, g)) return;
  const int R = a.R;
  u32 cp[M], c1[M], c2[M], val[M], acc[M];
#pragma unroll
  for (int u = 0; u < M; ++u) {
    const long e = at(g * M + u, R, r);
    cp[u] = ld(a.in[0], e), c1[u] = ld(a.in[1], e), c2[u] = ld(a.in[2], e);
    val[u] = ld(a.in[3], e), acc[u] = 0;
  }
  u32 cp0 = ld(a.in[0], r), c10 = ld(a.in[1], r), c20 = ld(a.in[2], r), v0 = ld(a.in[3], r);
  u32 a0 = 0, one = 1;
#pragma unroll 4
  for (int n = 0; n < a.iters; ++n) {
    opaque(cp), opaque(c1), opaque(c2), opaque(val), opaque(acc);
    opaque(cp0), opaque(c10), opaque(c20), opaque(v0), opaque(a0);
    one += a.zero;
#pragma unroll
    for (int u = 0; u < M; ++u) acc[u] = sel(cp[u], c1[u], c2[u], val[u], acc[u], a0, one);
    a0 = sel(cp0, c10, c20, v0, a0, a0, one);
  }
#pragma unroll
  for (int u = 0; u < M; ++u) a.out[at(g * M + u, R, r)] = as_int(acc[u]);
}

// reshape: the thread of row i owns entries (i, 0..M-1); each reads only
// its own x (the two reshapes move no data on a GPU).
__global__ void __launch_bounds__(kThreads) reshape_kernel(Ops a) {
  int r, i;
  if (!slot(a, kRowGroups, r, i)) return;
  const int R = a.R;
  u32 x[M], acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) x[j] = ld(a.in[0], at(i * M + j, R, r)), acc[j] = 0;
#pragma unroll 4
  for (int n = 0; n < a.iters; ++n) {
    opaque(x), opaque(acc);
#pragma unroll
    for (int j = 0; j < M; ++j) acc[j] = x[j] + acc[j] + 1u;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) a.out[at(i * M + j, R, r)] = as_int(acc[j]);
}

// repeat: rows i*M + j all hold src[i] + h, where h is the first M rows'
// common value before the iteration, row 0's chain h' = src[0] + h; the
// thread of i computes its value and the chain and stores its M rows once.
__global__ void __launch_bounds__(kThreads) repeat_kernel(Ops a) {
  int r, i;
  if (!slot(a, kRowGroups, r, i)) return;
  const int R = a.R;
  u32 src = ld(a.in[0], at(i, R, r)), src0 = ld(a.in[0], r), h = 0, v = 0;
#pragma unroll 1
  for (int n = 0; n < a.iters; ++n) {
    opaque(src), opaque(src0), opaque(h), opaque(v);
    v = src + h;
    h = src0 + h;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) a.out[at(i * M + j, R, r)] = as_int(v);
}

// tile: rows i*M + j all hold column j's chain c' = src[j] + c, which reads
// nothing else; the thread of j stores its M rows once.
__global__ void __launch_bounds__(kThreads) tile_kernel(Ops a) {
  int r, j;
  if (!slot(a, kRowGroups, r, j)) return;
  const int R = a.R;
  u32 src = ld(a.in[0], at(j, R, r)), c = 0;
#pragma unroll 1
  for (int n = 0; n < a.iters; ++n) {
    opaque(src), opaque(c);
    c = src + c;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) a.out[at(i * M + j, R, r)] = as_int(c);
}

// segsum: the thread of group g (0 or 1) owns output rows 1 + 4g .. 4 + 4g
// and row 0, acc[0]'s chain, which it stores only for g = 0: 5 row sums a
// thread, 10 a lane for its 9 rows. Row i sums x[i*M .. i*M + M-1] plus M
// times acc[0].
__global__ void __launch_bounds__(kThreads) segsum_kernel(Ops a) {
  constexpr int G = kSegsumRows + 1;
  int r, g;
  if (!slot(a, kSegsumGroups, r, g)) return;
  const int R = a.R;
  u32 x[G][M], v[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int row = k == 0 ? 0 : kSegsumRows * g + k;
#pragma unroll
    for (int j = 0; j < M; ++j) x[k][j] = ld(a.in[0], at(row * M + j, R, r));
    v[k] = 0;
  }
#pragma unroll 1
  for (int n = 0; n < a.iters; ++n) {
#pragma unroll
    for (int k = 0; k < G; ++k) opaque(x[k]);
    opaque(v);
    const u32 a0 = v[0];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      u32 s = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) s += x[k][j] + a0;
      v[k] = s;
    }
  }
#pragma unroll
  for (int k = g == 0 ? 0 : 1; k < G; ++k) {
    a.out[at(k == 0 ? 0 : kSegsumRows * g + k, R, r)] = as_int(v[k]);
  }
}

// contract: the thread of group g owns kContractGroup of the M^2 entries
// (j, o), flat e = g * kContractGroup + k, and their M cp operands
// cp[:, j, o] (flat i * M^2 + e), with b[:].
__global__ void __launch_bounds__(kThreads) contract_kernel(Ops a) {
  constexpr int G = kContractGroup;
  int r, g;
  if (!slot(a, kContractGroups, r, g)) return;
  const int R = a.R;
  u32 cp[M][G], b[M], acc[G];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    b[i] = ld(a.in[1], at(i, R, r));
#pragma unroll
    for (int k = 0; k < G; ++k) cp[i][k] = ld(a.in[0], at(i * M * M + g * G + k, R, r));
  }
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0;
#pragma unroll 4
  for (int n = 0; n < a.iters; ++n) {
#pragma unroll
    for (int i = 0; i < M; ++i) opaque(cp[i]);
    opaque(b), opaque(acc);
#pragma unroll
    for (int k = 0; k < G; ++k) {
#pragma unroll
      for (int i = 0; i < M; ++i) acc[k] += cp[i][k] * b[i];
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) a.out[at(g * G + k, R, r)] = as_int(acc[k]);
}

}  // namespace

extern "C" {

// Launch op `op` (0..6, in the order above) on `stream`: `ins` holds its
// inputs' device addresses (int32, runs-last, R lanes), `out` its int32
// accumulator, which the kernel writes once, after `iters` iterations from
// zero. Returns the launch's cudaError_t (0 on success).
int tpusim_micro_launch(int op, void* const* ins, void* out, int iters, int runs,
                        void* stream) {
  const int groups[7] = {kSel3Groups, kSelFlatGroups, kRowGroups,     kRowGroups,
                         kRowGroups,  kSegsumGroups,  kContractGroups};
  if (runs <= 0 || iters < 0 || op < 0 || op > 6 || runs > INT_MAX / groups[op]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Ops a{};
  const int n_in = op <= 1 ? 4 : (op == 6 ? 2 : 1);
  for (int i = 0; i < n_in; ++i) a.in[i] = static_cast<const int*>(ins[i]);
  a.out = static_cast<int*>(out);
  a.iters = iters;
  a.R = runs;
  const int threads = runs * groups[op];
  const dim3 grid((threads - 1) / kThreads + 1), block(kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: sel3_kernel<<<grid, block, 0, s>>>(a); break;
    case 1: sel_flat_kernel<<<grid, block, 0, s>>>(a); break;
    case 2: reshape_kernel<<<grid, block, 0, s>>>(a); break;
    case 3: repeat_kernel<<<grid, block, 0, s>>>(a); break;
    case 4: tile_kernel<<<grid, block, 0, s>>>(a); break;
    case 5: segsum_kernel<<<grid, block, 0, s>>>(a); break;
    default: contract_kernel<<<grid, block, 0, s>>>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
