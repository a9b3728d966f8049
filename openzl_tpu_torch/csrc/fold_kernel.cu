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
//
// Instantiated for 16-limb base fields (NW = 8: BN254, in this file) and
// 24-limb ones (NW = 12: BLS12-381, in fold_kernel_w12.cu, whose note says
// what bounds it there); the kernel is fold.cuh's template, and
// ozl_fold_madd dispatches on n_limbs.
#include "fold.cuh"

namespace {

// Blocks of 128 threads; at least 4 resident per SM over Fq (128 registers
// and 38 bytes of spill stores: the 415 blocks of a 2^16-point commit's 53 K
// chunks run in one wave, where 3 blocks at 167 registers leave some to a
// second) and 2 over Fq2 (241 registers, no spill). The other block sizes
// and bounds that tools/kernel_probe.py times were no faster (PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocksG1 = 4;
constexpr int kMinBlocksG2 = 2;

}  // namespace

// c: keys, pidx (int64, l * r), pts (the normalized points, point-major
// 32-bit words: X then Y, 2 * ext * n_limbs / 2 words a point), totals x,
// y, z (l), tflag (l bytes), buckets x, y, z (width), bflag (width bytes),
// bchunk (int64, width). 16 or 24 limbs; F1c needs the top word of p (word
// n_limbs / 2 - 1) below 0x7FFFFFFF. A build with -DOZL_NO_W12
// (tools/kernel_probe.py's builds of this file alone) takes 16 only.
extern "C" int ozl_fold_madd(int ext, void* keys, void* pidx, int64_t l, int r, void* pts,
                             void* tx, void* ty, void* tz, void* tflag, void* bx, void* by,
                             void* bz, void* bflag, void* bchunk, int64_t width, int n_limbs,
                             const void* p, uint32_t n0, int beta, int has_a, const void* a,
                             const void* one, void* stream) {
  void* c[12] = {keys, pidx, pts, tx, ty, tz, tflag, bx, by, bz, bflag, bchunk};
  const FoldArgs A{(const uint32_t*)p, n0, beta, has_a, (const uint32_t*)a, (const uint32_t*)one,
                   (cudaStream_t)stream};
  if ((ext != 1 && ext != 2) || r < 1 || (n_limbs != 16 && n_limbs != 24)) return (int)cudaErrorInvalidValue;
  if (A.p[n_limbs / 2 - 1] >= 0x7FFFFFFFu) return (int)cudaErrorInvalidValue;
  if (n_limbs == 16) return fold_launch<8, kThreads, kMinBlocksG1, kThreads, kMinBlocksG2>(ext, c, l, r, width, A);
#ifdef OZL_NO_W12
  return (int)cudaErrorInvalidValue;
#else
  return fold_launch_w12(ext, c, l, r, width, A);
#endif
}
