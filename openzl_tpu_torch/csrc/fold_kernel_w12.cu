// K9, the MSM's sorted-chunk mixed-add fold, over BLS12-381 G1 (Fq) and G2
// (Fq2, u^2 = -1) at NW = 12 words (24 limbs): fold.cuh's kernel
// instantiated in a translation unit of its own (the design notes are
// fold_kernel.cu's).
//
// Replaces openzl_tpu/ops/ec_kernel.py `_make_fold_kernel` (:430), held
// against its oracle, the jnp `_fold_columns` loop of
// openzl_tpu/ops/msm.py (:424-507), at n_limbs = 24.
//
// Bound at 12 words: the madd chain, 7 products and 4 squares per entry
// over Fq (29 base products over Fq2), each product 2.25 times an 8-word
// one, serial within a thread; and the registers that hold the running
// sum (36 over Fq, 72 over Fq2) beside the madd's temporaries. What the
// design does about the limits:
//   * the two-slot cp.async ring of the entry's point (PW + 4 words a slot,
//     PW = 24 over Fq, 48 over Fq2) is static shared memory, 2 x THREADS x
//     (PW + 4) words: 28,672 bytes over Fq at 128 threads, but 53,248 over
//     Fq2 at 128, past the 48 KB static limit. Fq2 therefore runs blocks
//     of 64 threads (26,624 bytes);
//   * both fields cap registers at 255 (Fq: at least 2 blocks of 128 a SM;
//     Fq2: at least 2 of 64, the same 128 threads as the 8-word build's
//     2 x 128 at 241 registers would give per SM at 255). A spill past
//     the cap stays correct. ptxas (-Xptxas -v, sm_90a): Fq 230
//     registers, no spill; Fq2 255 and 498 bytes of spill stores.
#include "fold.cuh"

int fold_launch_w12(int ext, void** c, int64_t l, int r, int64_t width, const FoldArgs& A) {
  return fold_launch<12, 128, 2, 64, 2>(ext, c, l, r, width, A);
}
