// K3's lifted scan variant over BLS12-381 G2 (Fq2 over Fq at NW = 12 words,
// 24 limbs): its fold, step and offset kernels, split from
// ec_kernel_w12_g2.cu (whose note says what they replace and what bounds
// them) into a translation unit of their own, so that nvcc compiles the two
// halves side by side.
#include "ec_kernel.cuh"

int ec_scan_w12_g2(void** c, int64_t n, int64_t d, const EcArgs& A) { return ec_scan<12, 2>(c, n, d, A); }
