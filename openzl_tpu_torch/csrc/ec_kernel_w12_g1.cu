// K3 (add, madd), K4 and K3's lifted scan variant over BLS12-381 G1: the
// base field Fq at NW = 12 words (24 limbs), the kernels of
// ec_kernel.cuh instantiated for one coordinate field in a translation unit
// of its own (the design notes are ec_kernel.cu's).
//
// Replaces openzl_tpu/ops/ec_kernel.py `_make_add_kernel` (:288, mixed =
// False/True), `_make_dbl_kernel` (:314) and, for the scan, the
// reference's `inclusive_scan` (openzl_tpu/ops/scan_utils.py:71) with the
// lifted combine of openzl_tpu/ops/msm.py:362, at n_limbs = 24: the Pallas
// kernels take any limb count, these one.
//
// Bound at 12 words: the integer multiplies, 2.25 times those of 8 words
// per product (NW^2 word products for a b, as many for the reduction), and
// one add's latency per wave, as at 8 words. A point's X, Y and Z are 36
// registers. The design keeps what ec_kernel.cu does at 8 words: F1c, the
// add's second operand staged in the thread's slot of shared memory (3 x
// 12 + 1 = 37 words a thread, 128 threads: 18,944 bytes of static shared
// memory), the scan's tile as dynamic shared memory (32 threads x (4 x 37
// + 1 words + 4 flag bytes) = 19,200 bytes), and a 255-register cap (2
// blocks of 128 threads a SM). ptxas (-Xptxas -v, sm_90a): add 255
// registers, madd 214, dbl 128, scan fold 255, step 224, offset 215; no
// spill.
#include "ec_kernel.cuh"

int ec_launch_w12_g1(EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A) {
  return ec_launch<12, 1>(op, c, n, d, A);
}
