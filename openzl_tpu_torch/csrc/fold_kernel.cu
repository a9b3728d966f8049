// K9: sorted-column mixed-add fold of the MSM bucket step, over Fq (G1) or
// Fq2 (G2).
//
// Replaces openzl_tpu/ops/ec_kernel.py `_make_fold_kernel` (:430, through
// `fold_madd()` :600 and `_fold_call` :529), whose oracle is the jnp
// `_fold_columns` loop of openzl_tpu/ops/msm.py (:424-507): the sorted
// (key, point) entries are cut into chunks of r consecutive entries; one
// thread owns one chunk, starts its accumulator at the identity and at each
// entry j takes acc = start[j] ? q : madd(acc, q) (madd-2007-bl with the
// reference's P = Q and identity masks, ec.cuh), then writes the chunk total
// and whether the chunk holds a segment start. Start and tail flags come
// from the neighbouring keys, read in the kernel.
//
// Two things are deliberately not carried over from the TPU kernel:
//   * gather fused: q = pts[pidx[e]] is read from the normalized points by
//     index, instead of from a pre-gathered column-major copy of every
//     entry's point;
//   * pick fused: the running prefix is written only at a segment tail,
//     straight into the tail's bucket slot (the key), with the reference's
//     `bflag` (the segment started in this chunk) and the chunk index,
//     instead of writing every prefix for a later gather (`pick`,
//     msm.py:371-380, reads only the tails).
// The reason is memory: at the 4096-link Groth16 size the G1 MSM has about
// 3 sets x 17 windows x 2^20 = 53 M entries, and a gathered copy plus every
// prefix, at 64 bytes per Fq coordinate, is over 15 GB of traffic that the
// fused form does not move.
//
// Bound on the card: the madd chain, 7 products and 4 squares per entry
// over Fq (29 base products over Fq2), serial within a thread, so the
// chunk count (entries / r) sets the parallelism and one chunk's chain its
// latency. What the design does about it:
//   * the field is F1c (field.cuh): carry-chain products and a dedicated
//     square, fewer instructions and registers than F1's 64-bit C;
//   * the points arrive point-major (the wrapper packs them: X then Y of
//     point i as 32-bit words at pts[i * PW], 64 bytes a G1 point, 128 a
//     G2 point), so one entry's point is PW / 4 16-byte loads instead of
//     2 PW scattered 4-byte loads;
//   * those loads are cp.async copies into a two-slot ring in shared memory
//     per thread, issued one entry ahead (with the next index and key), so
//     the gather's latency hides behind the madd; the madd reads X and Y
//     from shared memory where it uses them instead of holding them in
//     registers;
//   * launch bounds cap the registers so that the chunks of a 2^16-point
//     commit (~53 K threads) are resident at once; the madd chains then
//     share the SMs' integer issue, which bounds the fold.
// Entries are live normalized points (Z = 1): the madd's second Z is
// Montgomery one, as the reference's skip_z fold assumes.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

// Blocks of 128 threads; at least 4 resident per SM over Fq (128 registers
// and 38 bytes of spill stores: the 415 blocks of a 2^16-point commit's 53 K
// chunks run in one wave, where 3 blocks at 167 registers leave some to a
// second) and 2 over Fq2 (241 registers, no spill). The other block sizes
// and bounds that tools/kernel_probe.py times were no faster (PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocksG1 = 4;
constexpr int kMinBlocksG2 = 2;

// The fold's point source on the card: each thread's two slots of a ring in
// shared memory, filled by cp.async. A slot is PW + 4 words: 16-byte aligned
// for cp.async, and eight threads' 16-byte reads fall in distinct banks.
template <class T>
struct RingPoints {
  static constexpr int PW = 2 * (int)(sizeof(T) / sizeof(uint32_t));
  static constexpr int STRIDE = PW + 4;
  const uint32_t* pts;
  uint32_t* base;  // this thread's slot 0; slot 1 is kThreads * STRIDE words on
  __device__ const uint32_t* slot(int j) const { return base + (j & 1) * (kThreads * STRIDE); }
  __device__ void fetch(int j, int64_t i) {
    const uint32_t* g = pts + i * PW;
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(slot(j));
#pragma unroll
    for (int v = 0; v < PW / 4; ++v)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s + 16 * v), "l"(g + 4 * v)
                   : "memory");
  }
  __device__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
  __device__ void wait() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }
  __device__ const T& x(int j) const { return *reinterpret_cast<const T*>(slot(j)); }
  __device__ const T& y(int j) const { return *reinterpret_cast<const T*>(slot(j) + PW / 2); }
};

template <class F, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
    fold_kernel(const int64_t* keys, const int64_t* pidx, int64_t l, int r, const uint32_t* pts,
                int32_t* tx, int32_t* ty, int32_t* tz, uint8_t* tflag, int32_t* bx, int32_t* by,
                int32_t* bz, uint8_t* bflag, int64_t* bchunk, int64_t width, typename F::T one,
                EcParams<F> E) {
  using T = typename F::T;
  using Src = RingPoints<T>;
  __shared__ __align__(16) uint32_t ring[2 * kThreads * Src::STRIDE];
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= l) return;
  Src src{pts, ring + threadIdx.x * Src::STRIDE};
  T ax, ay, az;
  const bool started = fold_chunk<F>(E, keys, pidx, l * r, c, r, src, one, bx, by, bz, bflag,
                                     bchunk, width, ax, ay, az);
  store_coord(tx, l, c, ax);
  store_coord(ty, l, c, ay);
  store_coord(tz, l, c, az);
  tflag[c] = started;
}

template <int NW>
Fp<NW> words1(const uint32_t* v) {
  Fp<NW> r;
  for (int i = 0; i < NW; ++i) r.w[i] = v[i];
  return r;
}

template <int NW>
Fp2<NW> words2(const uint32_t* v) {
  return {words1<NW>(v), words1<NW>(v + NW)};
}

template <class F, int MIN_BLOCKS>
int launch_fold(void** c, int64_t l, int r, int64_t width, const typename F::T& one,
                const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (l + kThreads - 1) / kThreads;
  if (blocks > 0)
    fold_kernel<F, MIN_BLOCKS><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int64_t*)c[0], (const int64_t*)c[1], l, r, (const uint32_t*)c[2], (int32_t*)c[3],
        (int32_t*)c[4], (int32_t*)c[5], (uint8_t*)c[6], (int32_t*)c[7], (int32_t*)c[8],
        (int32_t*)c[9], (uint8_t*)c[10], (int64_t*)c[11], width, one, E);
  return (int)cudaGetLastError();
}

}  // namespace

// c: keys, pidx (int64, l * r), pts (the normalized points, point-major
// 32-bit words: X then Y, 2 * ext * n_limbs / 2 words a point), totals x,
// y, z (l), tflag (l bytes), buckets x, y, z (width), bflag (width bytes),
// bchunk (int64, width). F1c needs the top word of p below 0x7FFFFFFF.
extern "C" int ozl_fold_madd(int ext, void* keys, void* pidx, int64_t l, int r, void* pts,
                             void* tx, void* ty, void* tz, void* tflag, void* bx, void* by,
                             void* bz, void* bflag, void* bchunk, int64_t width, int n_limbs,
                             const void* p, uint32_t n0, int beta, int has_a, const void* a,
                             const void* one, void* stream) {
  void* c[12] = {keys, pidx, pts, tx, ty, tz, tflag, bx, by, bz, bflag, bchunk};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  const uint32_t* ow = (const uint32_t*)one;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_limbs != 16 || r < 1 || pw[7] >= 0x7FFFFFFFu) return (int)cudaErrorInvalidValue;
  if (ext == 1)
    return launch_fold<F1c<8>, kMinBlocksG1>(
        c, l, r, width, words1<8>(ow), params1<8, F1c<8>>(pw, n0, has_a, aw), st);
  if (ext == 2)
    return launch_fold<F2<8, F1c<8>>, kMinBlocksG2>(
        c, l, r, width, words2<8>(ow), params2<8, F1c<8>>(pw, n0, beta, has_a, aw), st);
  return (int)cudaErrorInvalidValue;
}
