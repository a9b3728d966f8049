// The kernels and launches of K3 (add, madd), K4 (double) and K3's lifted
// scan variant, generic over the word count NW of the base field and the
// coordinate field (Fq or Fq2). ec_kernel.cu holds the design notes and
// the entry points; each translation unit instantiates them for one (NW,
// ext): ec_kernel.cu for NW = 8 (BN254), ec_kernel_w12_g1.cu and
// ec_kernel_w12_g2.cu (with ec_kernel_w12_g2_scan.cu, the scan over Fq2)
// for NW = 12 (BLS12-381), so that nvcc compiles them in parallel.
#pragma once
#include <cuda_runtime.h>

#include "ec.cuh"

// What the entry points pass to an instantiation: `arg` is the add's mixed
// flag or the scan's phase; p, n0, the curve's a (has_a), u^2 = beta and
// Montgomery one are NW words each (2 NW for a and one over Fq2).
enum class EcOp { add, dbl, scan };
struct EcArgs {
  int arg;
  const uint32_t* p;
  uint32_t n0;
  int beta;
  int has_a;
  const uint32_t* a;
  const uint32_t* one;
  cudaStream_t st;
};

// the 12-word instantiations (ec_kernel_w12_g1.cu, ec_kernel_w12_g2.cu,
// whose scan kernels are ec_kernel_w12_g2_scan.cu's)
int ec_launch_w12_g1(EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A);
int ec_launch_w12_g2(EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A);
int ec_scan_w12_g2(void** c, int64_t n, int64_t d, const EcArgs& A);

namespace {

// K3, K4 and scan phases 2 and 3: blocks of 128 threads, at least
// kMinBlocksG1 / kMinBlocksG2 resident per SM (a register cap of 65536 /
// (128 blocks), at most 255); scan phase 1: blocks of 32 threads with the
// same register caps. Both caps are 255: the G1 add takes 168 registers
// (3 blocks fit), and a cap of 168 or 128 made a G1 scan kernel or the G1
// add spill (tools/kernel_probe.py, PERF.md). The base field is F1c.
// tools/kernel_probe.py times builds with other values through -D.
#ifndef OZL_EC_MIN_BLOCKS_G1
#define OZL_EC_MIN_BLOCKS_G1 2
#endif
#ifndef OZL_EC_MIN_BLOCKS_G2
#define OZL_EC_MIN_BLOCKS_G2 1
#endif
#ifndef OZL_EC_BASE
#define OZL_EC_BASE F1c
#endif
constexpr int kThreads = 128;
constexpr int kMinBlocksG1 = OZL_EC_MIN_BLOCKS_G1;
constexpr int kMinBlocksG2 = OZL_EC_MIN_BLOCKS_G2;
constexpr int kScanThreads = 32;
// elements per chunk of the lifted scan's phases 1 and 3
// (ec_kernel.SCAN_R)
constexpr int kChunk = 4;
// a thread's slot of shared memory for one staged operand (stage_point): an
// odd count of words, so the threads' slots fall in distinct banks
template <class T>
constexpr int kSlotWords = 3 * (int)(sizeof(T) / sizeof(uint32_t)) + 1;

template <class F, bool MIXED, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    ec_add_kernel(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* x2,
                  const int32_t* y2, const int32_t* z2, int32_t* x3, int32_t* y3, int32_t* z3,
                  int64_t N, EcParams<F> E) {
  using T = typename F::T;
  __shared__ uint32_t slots[kThreads * kSlotWords<T>];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  T* tag = nullptr;
  T X1 = load_coord(x1, N, i, tag), Y1 = load_coord(y1, N, i, tag), Z1 = load_coord(z1, N, i, tag);
  const T* Q = stage_point<T>(slots + threadIdx.x * kSlotWords<T>, x2, y2, z2, N, i);
  T X3, Y3, Z3;
  ec_add<F, MIXED>(E, X1, Y1, Z1, Q[0], Q[1], Q[2], X3, Y3, Z3);
  store_coord(x3, N, i, X3);
  store_coord(y3, N, i, Y3);
  store_coord(z3, N, i, Z3);
}

template <class F, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    ec_dbl_kernel(const int32_t* x1, const int32_t* y1, const int32_t* z1, int32_t* x3,
                  int32_t* y3, int32_t* z3, int64_t N, EcParams<F> E) {
  using T = typename F::T;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  T* tag = nullptr;
  T X1 = load_coord(x1, N, i, tag), Y1 = load_coord(y1, N, i, tag), Z1 = load_coord(z1, N, i, tag);
  T X3, Y3, Z3;
  ec_dbl<F>(E, X1, Y1, Z1, X3, Y3, Z3);
  store_coord(x3, N, i, X3);
  store_coord(y3, N, i, Y3);
  store_coord(z3, N, i, Z3);
}

struct BlockSync {
  __host__ __device__ void operator()() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

// Phase 1 of the lifted scan (scan_fold_block, ec.cuh)
template <class F, int NW, int MIN_BLOCKS>
__global__ void __launch_bounds__(kScanThreads, MIN_BLOCKS)
    scan_fold_kernel(const int32_t* x, const int32_t* y, const int32_t* z, const uint8_t* f,
                     int32_t* px, int32_t* py, int32_t* pz, uint8_t* pf, int32_t* tx,
                     int32_t* ty, int32_t* tz, uint8_t* tf, int64_t n, typename F::T one,
                     EcParams<F> E) {
  extern __shared__ uint32_t smem[];
  BlockSync sync;
  scan_fold_block<F, NW, kScanThreads, kChunk>(E, threadIdx.x, blockIdx.x, sync, smem, x, y, z, f,
                                               px, py, pz, pf, tx, ty, tz, tf, n, one);
}

// A narrow level's Hillis-Steele step (scan_step_element, ec.cuh)
template <class F, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    scan_step_kernel(const int32_t* x, const int32_t* y, const int32_t* z, const uint8_t* f,
                     int32_t* ox, int32_t* oy, int32_t* oz, uint8_t* of, int64_t n, int64_t d,
                     typename F::T one, EcParams<F> E) {
  __shared__ uint32_t slots[kThreads * kSlotWords<typename F::T>];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    scan_step_element<F>(E, i, slots + threadIdx.x * kSlotWords<typename F::T>, x, y, z, f, ox, oy,
                         oz, of, n, d, one);
}

// Phase 3 of the lifted scan (scan_offset_element, ec.cuh)
template <class F, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    scan_offset_kernel(const int32_t* ox, const int32_t* oy, const int32_t* oz, int32_t* px,
                       int32_t* py, int32_t* pz, const uint8_t* pf, int64_t n, EcParams<F> E) {
  __shared__ uint32_t slots[kThreads * kSlotWords<typename F::T>];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    scan_offset_element<F, kChunk>(E, i, slots + threadIdx.x * kSlotWords<typename F::T>, ox, oy, oz,
                                   px, py, pz, pf, n);
}

template <class F, int MIN_BLOCKS>
int launch_add(int mixed, void** c, int64_t N, const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto in = (const int32_t**)c;
    auto out = (int32_t**)c;
    if (mixed)
      ec_add_kernel<F, true, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], out[6], out[7], out[8], N, E);
    else
      ec_add_kernel<F, false, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], out[6], out[7], out[8], N, E);
  }
  return (int)cudaGetLastError();
}

template <class F, int MIN_BLOCKS>
int launch_dbl(void** c, int64_t N, const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto in = (const int32_t**)c;
    auto out = (int32_t**)c;
    ec_dbl_kernel<F, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
        in[0], in[1], in[2], out[3], out[4], out[5], N, E);
  }
  return (int)cudaGetLastError();
}

// c: a (x, y, z, f), b (x, y, z, f), c (x, y, z, f) as ozl_ec_lifted_scan
// takes them
template <class F, int NW, int MIN_BLOCKS, int SCAN_MIN_BLOCKS>
int launch_scan(int phase, void** c, int64_t n, int64_t d, const typename F::T& one,
                const EcParams<F>& E, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  auto i32 = [&](int k) { return (int32_t*)c[k]; };
  auto u8 = [&](int k) { return (uint8_t*)c[k]; };
  if (phase == 1) {
    const int64_t m = (n + kChunk - 1) / kChunk;
    const int64_t blocks = (m + kScanThreads - 1) / kScanThreads;
    const size_t bytes = ScanTile<typename F::T, kScanThreads, kChunk>::bytes;
    auto kernel = scan_fold_kernel<F, NW, SCAN_MIN_BLOCKS>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, kScanThreads, bytes, st>>>(
        i32(0), i32(1), i32(2), u8(3), i32(4), i32(5), i32(6), u8(7), i32(8), i32(9), i32(10),
        u8(11), n, one, E);
  } else if (phase == 2) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    scan_step_kernel<F, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
        i32(0), i32(1), i32(2), u8(3), i32(4), i32(5), i32(6), u8(7), n, d, one, E);
  } else {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    scan_offset_kernel<F, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
        i32(0), i32(1), i32(2), i32(4), i32(5), i32(6), u8(7), n, E);
  }
  return (int)cudaGetLastError();
}

template <int NW>
Fp<NW> words1(const uint32_t* v) {
  Fp<NW> r;
  for (int i = 0; i < NW; ++i) r.w[i] = v[i];
  return r;
}


// the coordinate field of one instantiation: Fq (EXT 1) or Fq2 (EXT 2) on
// the base field OZL_EC_BASE<NW>, its register cap and its constants
template <int NW, int EXT>
struct EcField;

template <int NW>
struct EcField<NW, 1> {
  using F = OZL_EC_BASE<NW>;
  static constexpr int kMinBlocks = kMinBlocksG1;
  static EcParams<F> params(const EcArgs& A) { return params1<NW, F>(A.p, A.n0, A.has_a, A.a); }
  static typename F::T one(const uint32_t* w) { return words1<NW>(w); }
};

template <int NW>
struct EcField<NW, 2> {
  using F = F2<NW, OZL_EC_BASE<NW>>;
  static constexpr int kMinBlocks = kMinBlocksG2;
  static EcParams<F> params(const EcArgs& A) {
    return params2<NW, OZL_EC_BASE<NW>>(A.p, A.n0, A.beta, A.has_a, A.a);
  }
  static typename F::T one(const uint32_t* w) { return {words1<NW>(w), words1<NW>(w + NW)}; }
};

// One launch of K3 (op add) or K4 (op dbl) over n points
template <int NW, int EXT>
int ec_law(EcOp op, void** c, int64_t n, const EcArgs& A) {
  using K = EcField<NW, EXT>;
  using F = typename K::F;
  const EcParams<F> E = K::params(A);
  if (op == EcOp::add) return launch_add<F, K::kMinBlocks>(A.arg, c, n, E, A.st);
  return launch_dbl<F, K::kMinBlocks>(c, n, E, A.st);
}

// One launch of phase A.arg of the lifted scan over n elements
template <int NW, int EXT>
int ec_scan(void** c, int64_t n, int64_t d, const EcArgs& A) {
  using K = EcField<NW, EXT>;
  using F = typename K::F;
  return launch_scan<F, NW, K::kMinBlocks, K::kMinBlocks * kThreads / kScanThreads>(A.arg, c, n, d,
                                                                                     K::one(A.one),
                                                                                     K::params(A), A.st);
}

// One launch of K3, K4 or a phase of the lifted scan over n elements, with
// the pointers c as the entry points order them
template <int NW, int EXT>
int ec_launch(EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A) {
  return op == EcOp::scan ? ec_scan<NW, EXT>(c, n, d, A) : ec_law<NW, EXT>(op, c, n, A);
}

}  // namespace
