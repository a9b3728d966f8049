// K3 (add, madd), K4 and K3's lifted scan variant over BLS12-381 G2: the
// coordinate field Fq2 (u^2 = -1) over Fq at NW = 12 words (24 limbs), the
// kernels of ec_kernel.cuh instantiated for one coordinate field in a
// translation unit of its own (the design notes are ec_kernel.cu's).
//
// Replaces openzl_tpu/ops/ec_kernel.py `_make_add_kernel` (:288, mixed =
// False/True, over `_OpsF2`), `_make_dbl_kernel` (:314) and, for the scan,
// the reference's `inclusive_scan` (openzl_tpu/ops/scan_utils.py:71) with
// the lifted combine of openzl_tpu/ops/msm.py:362, at n_limbs = 24.
//
// Bound at 12 words: the integer multiplies (43 base products per add,
// each 2.25 times an 8-word one) and registers. A point's X, Y and Z over
// Fq2 are 72 registers, and at 8 words the add already took the whole
// 255-register cap with its second operand waiting in shared memory, so
// here the add, the madd and the scan kernels spill to local memory (L1
// first). A spill stays correct; this instantiation takes it. What the
// design keeps from 8 words: the second operand staged in the thread's slot
// of shared memory (3 x 24 + 1 = 73 words a thread, 128 threads: 37,376
// bytes of static shared memory, under the 48 KB static limit), the
// scan's tile as dynamic shared memory (32 threads x (4 x 73 + 1 words + 4
// flag bytes) = 37,632 bytes, under the attribute ec_kernel.cuh sets), and
// one block of 128 threads a SM at a 255-register cap. ptxas (-Xptxas -v,
// sm_90a): add 255 registers and 1,360 bytes of spill stores, madd 255 and
// 276, dbl 230 and none; the scan's fold, step and offset kernels 255 and
// 1,464, 1,560, 1,496. Staging the first operand too, or a split formula,
// is later work (ROADMAP).
#include "ec_kernel.cuh"

// K3 and K4 here; the scan's three kernels in ec_kernel_w12_g2_scan.cu, so
// that the two halves compile side by side (this instantiation is the
// longest of the build)
int ec_launch_w12_g2(EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A) {
  return op == EcOp::scan ? ec_scan_w12_g2(c, n, d, A) : ec_law<12, 2>(op, c, n, A);
}
