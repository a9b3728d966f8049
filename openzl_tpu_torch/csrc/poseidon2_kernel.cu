// K7: Poseidon2 permutation.
//
// Replaces openzl_tpu/ops/poseidon2_kernel.py `_kernel` (:53, through
// `permute_lanes()` / `permute()` / `hash_batch()`): one external layer
// before the first round, then R_F / 2 external rounds (add keys, S-box all,
// external layer), R_P internal rounds (add a key to element 0, S-box it,
// internal layer) and R_F / 2 external rounds (`poseidon2_rounds` in
// poseidon.cuh). At width 3 the external layer is circ(2, 1, 1), x_i +
// sum x; the internal layer is sum x + diag_i x_i with small integers
// diag_i, taken by doublings and additions. Results are fully reduced, so
// any correct product is bit-equal to the reference's.
//
// Design as K5 at width 3 (poseidon_kernel.cu): one thread per state held
// in registers, the keys (1.9 KB at width 3) and the diagonal staged in
// shared memory, the rounds a runtime loop with one round body. Bound on
// the card: integer multiplies, 240 Montgomery products of 136 word
// products per state against 192 B of state traffic each way.
//
// Built at every width Poseidon2 has round numbers for (ROUND_NUMBERS_128
// of crypto/poseidon2: 2, 3, 4, 8 and 12), one instantiation each. At
// width 4k the external layer is M4 on each block of four plus the sum of
// the blocks (ext_layer); no layer needs a temporary state, so even width
// 12 (96 words of state) stays in registers.
#include <cuda_runtime.h>

#include "poseidon.cuh"

namespace {

template <int W>
int launch_width(void* out, const void* in, const void* consts, int64_t B, int full_rounds,
                 int partial_rounds, const void* p, uint32_t n0, void* stream) {
  return launch_permute<kPoseidon2, W, 8>(out, in, consts, B, full_rounds, partial_rounds,
                                          poseidon2_words(W, full_rounds, partial_rounds, 8),
                                          (const uint32_t*)p, n0, (cudaStream_t)stream);
}

}  // namespace

// Instantiated over 16-limb (8-word) fields; any other width or limb count
// is refused with cudaErrorInvalidValue (the wrapper checks first).
extern "C" int ozl_poseidon2_permute(void* out, const void* in, const void* consts, int64_t B,
                                     int width, int full_rounds, int partial_rounds, int n_limbs,
                                     const void* p, uint32_t n0, void* stream) {
  if (n_limbs != 16) return (int)cudaErrorInvalidValue;
  switch (width) {
    case 2: return launch_width<2>(out, in, consts, B, full_rounds, partial_rounds, p, n0, stream);
    case 3: return launch_width<3>(out, in, consts, B, full_rounds, partial_rounds, p, n0, stream);
    case 4: return launch_width<4>(out, in, consts, B, full_rounds, partial_rounds, p, n0, stream);
    case 8: return launch_width<8>(out, in, consts, B, full_rounds, partial_rounds, p, n0, stream);
    case 12: return launch_width<12>(out, in, consts, B, full_rounds, partial_rounds, p, n0, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
