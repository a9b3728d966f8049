// K3: batched Jacobian point addition (add-2007-bl, or madd-2007-bl with an
// affine second operand), K4: batched doubling (dbl-2009-l, or the generic-a
// double M = 3X^2 + a Z^4), over Fq (G1) or Fq2 (G2), and K3's lifted scan
// variant: the exclusive prefixes of the MSM's chunk totals under the lifted
// monoid of `lifted_add` (ec.cuh).
//
// K3 and K4 replace openzl_tpu/ops/ec_kernel.py `_make_add_kernel` (:288,
// mixed = False/True, through `ec_op("add"|"madd")` :622) and
// `_make_dbl_kernel` (:314, through `ec_op("dbl")`). The formulas and the
// special-case masks are those of `_k_ec_double` / `_add_core` (:193-272):
// doubling when P = Q, the identity (X = Y = 1, Z = 0) when P = -Q,
// pass-through when either input is the identity (Z = 0). Every field
// result is fully reduced, so Jacobian outputs are bit-equal to the
// reference kernels.
//
// One thread per point: the group law is a long dependent chain of field
// operations on a few hundred bits of state, and each coordinate is read and
// written once, coalesced across threads (limb-planar layout). Bound on the
// card: the integer multiplies (11 products and 5 squares per G1 add, 43
// base products per G2 add) and, at 2^16 points, the latency of one add: a
// thread does one, so the kernel lasts about as many adds as it has waves.
// What the design does about it:
//   * the field is F1c (field.cuh, as K5 and K9): carry-chain products and
//     a dedicated square, with fewer instructions than F1's 64-bit C. It
//     needs the top word of p below 0x7FFFFFFF (BN254 Fq);
//   * the add's second operand waits in the thread's slot of shared memory
//     (stage_point, ec.cuh) and is read where the formula uses it, as K9
//     reads its points, instead of in registers: over Fq2 the add then fits
//     255 registers without a spill (with both operands in registers ptxas
//     spilled 344 bytes, tools/kernel_probe.py, PERF.md);
//   * launch bounds: 255 registers at most, over Fq and Fq2 (the G1 add
//     takes 168, so 3 blocks of 128 fit an SM; a cap of 128 spills).
//
// The lifted scan replaces the Hillis-Steele scan of the chunk totals
// (ceil(log2 l) full-width K3 adds) by the reference's work-efficient shape
// (openzl_tpu/ops/scan_utils.py `inclusive_scan`), about 2 l adds in
// O(log_4 l) launches, driven level by level by ec_kernel.lifted_scan:
//   phase 1 (scan_fold_kernel): one thread per chunk of kChunk = 4
//     consecutive elements folds them serially and writes each element's
//     exclusive prefix within its chunk and the chunk's total. A block of
//     32 threads stages its tile, one run of consecutive elements, through
//     shared memory, so the limb-planar loads and stores run over
//     consecutive elements, and the fold reads each element from its slot
//     there;
//   phase 2: the chunk totals are scanned the same way (the wrapper's
//     recursion) while they are wide; a narrow level (a single chunk's
//     serial fold would be longer than its Hillis-Steele steps) runs
//     scan_step_kernel, one Hillis-Steele step of lifted adds per launch;
//   phase 3 (scan_offset_kernel): one thread per element adds its chunk's
//     offset. The chunk's first element holds the identity, whose sum with
//     the offset is the offset itself.
// An element past the end is the identity with a false flag: it leaves the
// running sum as it is, so the kernel skips it. A flagged element replaces
// the running sum without an add. The level of chunks is latency-bound
// (few threads, kChunk serial adds each), a Hillis-Steele step costs one
// add of latency, so the narrow levels take steps (ec_kernel.SCAN_NARROW).
//
// Instantiated for 16-limb base fields (BN254); a 24-limb instantiation
// (BLS12-381) builds too but more than doubles the build time, so it waits
// until a path needs it.
#include <cuda_runtime.h>

#include "ec.cuh"

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

// the checks every entry point makes: 16 limbs, Fq or Fq2, and F1c's bound
// on p
int check_args(int ext, int n_limbs, const void* p) {
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;
  if (n_limbs != 16 || ((const uint32_t*)p)[7] >= 0x7FFFFFFFu) return (int)cudaErrorInvalidValue;
  return 0;
}

using G1F = OZL_EC_BASE<8>;
using G2F = F2<8, G1F>;

}  // namespace

extern "C" int ozl_ec_add(int mixed, int ext, void* x1, void* y1, void* z1, void* x2, void* y2,
                          void* z2, void* x3, void* y3, void* z3, int64_t N, int n_limbs,
                          const void* p, uint32_t n0, int beta, int has_a, const void* a,
                          void* stream) {
  void* c[9] = {x1, y1, z1, x2, y2, z2, x3, y3, z3};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  cudaStream_t st = (cudaStream_t)stream;
  if (int bad = check_args(ext, n_limbs, p)) return bad;
  if (ext == 1)
    return launch_add<G1F, kMinBlocksG1>(mixed, c, N, params1<8, G1F>(pw, n0, has_a, aw), st);
  return launch_add<G2F, kMinBlocksG2>(mixed, c, N, params2<8, G1F>(pw, n0, beta, has_a, aw), st);
}

extern "C" int ozl_ec_dbl(int ext, void* x1, void* y1, void* z1, void* x3, void* y3, void* z3,
                          int64_t N, int n_limbs, const void* p, uint32_t n0, int beta, int has_a,
                          const void* a, void* stream) {
  void* c[6] = {x1, y1, z1, x3, y3, z3};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  cudaStream_t st = (cudaStream_t)stream;
  if (int bad = check_args(ext, n_limbs, p)) return bad;
  if (ext == 1) return launch_dbl<G1F, kMinBlocksG1>(c, N, params1<8, G1F>(pw, n0, has_a, aw), st);
  return launch_dbl<G2F, kMinBlocksG2>(c, N, params2<8, G1F>(pw, n0, beta, has_a, aw), st);
}

// One launch of the lifted scan over n elements. phase 1, chunks of
// kChunk: a = the elements and their flags (n); b = their exclusive
// prefixes within each chunk and the prefixes' flags (n, written); c = the
// chunk totals and flags (ceil(n / kChunk), written). phase 2, the
// Hillis-Steele step at distance d (1 <= d < n; d is unused by the other
// phases): a = the elements, b = the step's result (n, written; the
// exclusive prefixes when 2 d >= n); c unused. phase 3, chunks of kChunk: a
// = the chunk offsets (ceil(n / kChunk); af unused); b = the prefixes and
// flags of phase 1, which become the elements' exclusive prefixes (in
// place); c unused. `one` is Montgomery one of the coordinate field (NW words, then
// NW zero words over Fq2).
extern "C" int ozl_ec_lifted_scan(int phase, int ext, void* ax, void* ay, void* az, void* af,
                                  void* bx, void* by, void* bz, void* bf, void* cx, void* cy,
                                  void* cz, void* cf, int64_t n, int64_t d, int n_limbs, const void* p,
                                  uint32_t n0, int beta, int has_a, const void* a, const void* one,
                                  void* stream) {
  void* c[12] = {ax, ay, az, af, bx, by, bz, bf, cx, cy, cz, cf};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  const uint32_t* ow = (const uint32_t*)one;
  cudaStream_t st = (cudaStream_t)stream;
  if (int bad = check_args(ext, n_limbs, p)) return bad;
  if (phase == 2 ? d < 1 || d >= n : phase != 1 && phase != 3) return (int)cudaErrorInvalidValue;
  if (ext == 1)
    return launch_scan<G1F, 8, kMinBlocksG1, kMinBlocksG1 * kThreads / kScanThreads>(
        phase, c, n, d, words1<8>(ow), params1<8, G1F>(pw, n0, has_a, aw), st);
  return launch_scan<G2F, 8, kMinBlocksG2, kMinBlocksG2 * kThreads / kScanThreads>(
      phase, c, n, d, {words1<8>(ow), words1<8>(ow + 8)}, params2<8, G1F>(pw, n0, beta, has_a, aw),
      st);
}
