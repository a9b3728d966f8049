// K5: classic Poseidon permutation, and K6: the optimized permutation.
//
// K5 replaces openzl_tpu/ops/poseidon_kernel.py `_kernel` (:158, through
// `permute_lanes()` / `permute()` / `hash_batch()`): per round add the round
// keys, S-box x^5 (every element in full rounds, element 0 in partial
// rounds), then the dense MDS product M x. K6 replaces `_kernel_opt` (:198,
// through `permute_lanes_opt()`): the same permutation with the constants
// moved after the S-box and the partial rounds' MDS factored into sparse
// matrices. The rounds are `poseidon_rounds` and `poseidon_opt_rounds` in
// poseidon.cuh.
//
// Design: one thread per state; the width-3 state is 3 x 8 32-bit words in
// registers for all rounds, so device memory is touched once to read the
// state and once to write it. The round constants and matrices (6.2 KB for
// K5, 11.6 KB for K6 at width 3) are staged in shared memory by each block
// and read as warp-wide broadcasts. Rounds are a runtime loop (`#pragma
// unroll 1`) with only the word loops unrolled, which keeps the code to one
// round body (nvcc time, instruction cache). Bound on the card: integer
// multiplies. A width-3 state costs 804 Montgomery products in K5 and 584 in
// K6, each 136 32x32->64-bit word products (CIOS at 8 words), against 192 B
// of state traffic each way: compute-bound by more than an order of
// magnitude. The TPU kernel's (n_blocks, n, S, 128) lane layout and its
// batch multiple of 4096 were VMEM tiling artefacts; any batch runs here.
#include <cuda_runtime.h>

#include "poseidon.cuh"

// Instantiated for width 3 over 16-limb (8-word) fields; anything else is
// refused with cudaErrorInvalidValue (the wrapper checks first).
extern "C" int ozl_poseidon_permute(void* out, const void* in, const void* consts, int64_t B,
                                    int width, int full_rounds, int partial_rounds, int n_limbs,
                                    const void* p, uint32_t n0, void* stream) {
  if (width != 3 || n_limbs != 16) return (int)cudaErrorInvalidValue;
  return launch_permute<kPoseidon, 3, 8>(out, in, consts, B, full_rounds, partial_rounds,
                                         poseidon_words<3>(full_rounds, partial_rounds, 8),
                                         (const uint32_t*)p, n0, (cudaStream_t)stream);
}

extern "C" int ozl_poseidon_permute_opt(void* out, const void* in, const void* consts, int64_t B,
                                        int width, int full_rounds, int partial_rounds,
                                        int n_limbs, const void* p, uint32_t n0, void* stream) {
  if (width != 3 || n_limbs != 16) return (int)cudaErrorInvalidValue;
  return launch_permute<kPoseidonOpt, 3, 8>(out, in, consts, B, full_rounds, partial_rounds,
                                            poseidon_opt_words<3>(full_rounds, partial_rounds, 8),
                                            (const uint32_t*)p, n0, (cudaStream_t)stream);
}
