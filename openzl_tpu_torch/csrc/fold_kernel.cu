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
//   * gather fused: q = pts[pidx[e]] is read from the normalized point
//     array by index, instead of from a pre-gathered column-major copy of
//     every entry's point;
//   * pick fused: the running prefix is written only at a segment tail,
//     straight into the tail's bucket slot (the key), with the reference's
//     `bflag` (the segment started in this chunk) and the chunk index,
//     instead of writing every prefix for a later gather (`pick`,
//     msm.py:371-380, reads only the tails).
// The reason is memory: at the 4096-link Groth16 size the G1 MSM has about
// 3 sets x 17 windows x 2^20 = 53 M entries, and a gathered copy plus every
// prefix, at 64 bytes per Fq coordinate, is over 15 GB of traffic that the
// fused form does not move. What is left per entry is its key, its index
// and one random read of an affine point (128 bytes over Fq, 256 over Fq2).
//
// Bound on the card: the madd chain, ~7 products and 4 squares per entry
// over Fq (3x over Fq2), in registers; every thread's r steps are serial,
// so the chunk count (entries / r) sets the parallelism. Entries are live
// normalized points (Z = 1): the madd's second Z is Montgomery one, as the
// reference's skip_z fold assumes.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(128)
    fold_kernel(const int64_t* keys, const int64_t* pidx, int64_t l, int r, const int32_t* px,
                const int32_t* py, int64_t n_pts, int32_t* tx, int32_t* ty, int32_t* tz,
                uint8_t* tflag, int32_t* bx, int32_t* by, int32_t* bz, uint8_t* bflag,
                int64_t* bchunk, int64_t width, typename F::T one, EcParams<F> E) {
  using T = typename F::T;
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= l) return;
  T ax, ay, az;
  const bool started = fold_chunk<F>(E, keys, pidx, l * r, c, r, px, py, n_pts, one, bx, by, bz,
                                     bflag, bchunk, width, ax, ay, az);
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

const int kThreads = 128;

template <class F>
int launch_fold(void** c, int64_t l, int r, int64_t n_pts, int64_t width,
                const typename F::T& one, const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (l + kThreads - 1) / kThreads;
  if (blocks > 0)
    fold_kernel<F><<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int64_t*)c[0], (const int64_t*)c[1], l, r, (const int32_t*)c[2],
        (const int32_t*)c[3], n_pts, (int32_t*)c[4], (int32_t*)c[5], (int32_t*)c[6],
        (uint8_t*)c[7], (int32_t*)c[8], (int32_t*)c[9], (int32_t*)c[10], (uint8_t*)c[11],
        (int64_t*)c[12], width, one, E);
  return (int)cudaGetLastError();
}

}  // namespace

// c: keys, pidx (int64, l * r), px, py (the points' X and Y), totals x, y,
// z (l), tflag (l bytes), buckets x, y, z (width), bflag (width bytes),
// bchunk (int64, width)
extern "C" int ozl_fold_madd(int ext, void* keys, void* pidx, int64_t l, int r, void* px,
                             void* py, int64_t n_pts, void* tx, void* ty, void* tz, void* tflag,
                             void* bx, void* by, void* bz, void* bflag, void* bchunk,
                             int64_t width, int n_limbs, const void* p, uint32_t n0, int beta,
                             int has_a, const void* a, const void* one, void* stream) {
  void* c[13] = {keys, pidx, px, py, tx, ty, tz, tflag, bx, by, bz, bflag, bchunk};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  const uint32_t* ow = (const uint32_t*)one;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_limbs != 16 || r < 1) return (int)cudaErrorInvalidValue;
  if (ext == 1)
    return launch_fold(c, l, r, n_pts, width, words1<8>(ow), params1<8>(pw, n0, has_a, aw), st);
  if (ext == 2)
    return launch_fold(c, l, r, n_pts, width, words2<8>(ow), params2<8>(pw, n0, beta, has_a, aw),
                       st);
  return (int)cudaErrorInvalidValue;
}
