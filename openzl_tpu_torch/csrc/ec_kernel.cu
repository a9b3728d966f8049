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
// Instantiated for 16-limb base fields (NW = 8 words: BN254 Fq, in this
// file) and 24-limb ones (NW = 12: BLS12-381 Fq, in ec_kernel_w12_g1.cu
// and ec_kernel_w12_g2.cu, whose notes say what bounds them). The kernels
// and launches are ec_kernel.cuh's templates; each instantiation is its
// own translation unit, so nvcc builds them side by side, and the entry
// points below dispatch on n_limbs. F1c needs the top word of p below
// 0x7FFFFFFF (BN254 Fq 0x30644e72, BLS12-381 Fq 0x1a0111ea); the entry
// points check word NW - 1.
#include "ec_kernel.cuh"

namespace {

// the checks every entry point makes: 16 or 24 limbs, Fq or Fq2, and F1c's
// bound on the top word of p (word NW - 1)
int check_args(int ext, int n_limbs, const uint32_t* p) {
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;
  if (n_limbs != 16 && n_limbs != 24) return (int)cudaErrorInvalidValue;
  if (p[n_limbs / 2 - 1] >= 0x7FFFFFFFu) return (int)cudaErrorInvalidValue;
  return 0;
}

// one launch at the instantiation for (n_limbs, ext). A build with
// -DOZL_NO_W12 (tools/kernel_probe.py's builds of this file alone) has only
// the 8-word one.
int dispatch(int ext, int n_limbs, EcOp op, void** c, int64_t n, int64_t d, const EcArgs& A) {
  if (int bad = check_args(ext, n_limbs, A.p)) return bad;
  if (n_limbs == 16) return ext == 1 ? ec_launch<8, 1>(op, c, n, d, A) : ec_launch<8, 2>(op, c, n, d, A);
#ifdef OZL_NO_W12
  return (int)cudaErrorInvalidValue;
#else
  return ext == 1 ? ec_launch_w12_g1(op, c, n, d, A) : ec_launch_w12_g2(op, c, n, d, A);
#endif
}

}  // namespace

extern "C" int ozl_ec_add(int mixed, int ext, void* x1, void* y1, void* z1, void* x2, void* y2,
                          void* z2, void* x3, void* y3, void* z3, int64_t N, int n_limbs,
                          const void* p, uint32_t n0, int beta, int has_a, const void* a,
                          void* stream) {
  void* c[9] = {x1, y1, z1, x2, y2, z2, x3, y3, z3};
  const EcArgs A{mixed, (const uint32_t*)p, n0, beta, has_a, (const uint32_t*)a, nullptr,
                 (cudaStream_t)stream};
  return dispatch(ext, n_limbs, EcOp::add, c, N, 0, A);
}

extern "C" int ozl_ec_dbl(int ext, void* x1, void* y1, void* z1, void* x3, void* y3, void* z3,
                          int64_t N, int n_limbs, const void* p, uint32_t n0, int beta, int has_a,
                          const void* a, void* stream) {
  void* c[6] = {x1, y1, z1, x3, y3, z3};
  const EcArgs A{0, (const uint32_t*)p, n0, beta, has_a, (const uint32_t*)a, nullptr,
                 (cudaStream_t)stream};
  return dispatch(ext, n_limbs, EcOp::dbl, c, N, 0, A);
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
  if (phase == 2 ? d < 1 || d >= n : phase != 1 && phase != 3) return (int)cudaErrorInvalidValue;
  const EcArgs A{phase, (const uint32_t*)p, n0, beta, has_a, (const uint32_t*)a,
                 (const uint32_t*)one, (cudaStream_t)stream};
  return dispatch(ext, n_limbs, EcOp::scan, c, n, d, A);
}
