// K7: Poseidon2 permutation.
//
// Replaces openzl_tpu/ops/poseidon2_kernel.py `_kernel` (:53, through
// `permute_lanes()` / `permute()` / `hash_batch()`): one external layer
// before the first round, then R_F / 2 external rounds (add keys, S-box all,
// external layer), R_P internal rounds (add a key to element 0, S-box it,
// internal layer) and R_F / 2 external rounds (`poseidon2_rounds` in
// poseidon.cuh). At width 2 or 3 the external layer is circ(2, 1[, 1]),
// x_i + sum x; at width 4k it is M4 on each block of four plus the sum of
// the blocks; the internal layer is sum x + diag_i x_i with small integers
// diag_i. Results are fully reduced, so any correct product is bit-equal
// to the reference's.
//
// What bounds it on the card: the integer issue. Its only Montgomery
// products are the S-boxes (80 at width 3, 153 at width 12, each of 104 to
// 132 word products); the rest is the linear layers' additions, at width
// 12 at least a fifth as many issues as the S-boxes' word products
// (chip_smoke.py `_p2_addition_issues`), several times that when every
// addition is reduced and the diagonal taken by doublings. The design cuts
// the instructions of both:
//   - the S-boxes run on F1c's carry-chain product and dedicated square
//     where p's top word allows (`carry_chains`: BN254 Fr, BLS12-381 Fr),
//     F1 otherwise, one instantiation of each a width; on F1c the key
//     addition is left unreduced (x + k < 2p, which F1c's square and
//     product take);
//   - the linear layers are summed unreduced in NW + 1 words (one extra
//     carry word): M4 by the paper's chain of additions and doublings
//     (funnel shifts), the diagonal as one row of word products on the
//     shared sum (`wide_mac`), and each output reduced once
//     (`reduce_wide`: a quotient q' of v / p from v's top two words and a
//     precomputed reciprocal, v - q' p < 2p, one conditional subtraction).
// The bound that keeps every intermediate below what the next step takes,
// for the largest coefficients of every built width (inputs of a layer
// below p; p / R = 0.189 for BN254 Fr, 0.453 for BLS12-381 Fr):
//   width | external layer output | internal output (W + max diag)
//   2     | 3p                    | 4p  (diag 1, 2; both fields)
//   3     | 4p                    | 6p BN254 (1, 2, 3), 7p BLS (1, 2, 4)
//   4     | 32p (2 M4, row 16)    | 14p BN254 (max 10), 13p BLS (9)
//   8     | 48p                   | 27p BN254 (19), 34p BLS (26)
//   12    | 64p                   | 31p BN254 (19), 29p BLS (17)
// so every sum is below 64p < 2^261, inside NW + 1 words with the top
// word below 32, and reduce_wide's quotient is exact to one for any
// K p with K < 2^15. The S-box input x + k < 2p meets F1c's square
// (x^2 < 4p^2 and 4p < 2R: its redc subtracts p at most twice) and its
// product x^4 x (the CIOS sum stays below p (1 + 2p / R) < 2p).
//
// One thread per state in registers, the keys and the diagonal staged in
// shared memory, the rounds a runtime loop with one round body for every
// width. Not split over lanes: at 2^16 states the kernel is bound by
// its instruction issue, and Poseidon2's internal rounds have one S-box
// and no other product, so lanes beside the S-box's would idle through
// its three products (K5's split lanes pay because they take MDS
// products; PERF.md).
//
// Built at every width Poseidon2 has round numbers for (ROUND_NUMBERS_128
// of crypto/poseidon2: 2, 3, 4, 8 and 12).
#include <cuda_runtime.h>

#include "poseidon.cuh"

namespace {

template <int W>
int launch_width(void* out, const void* in, const void* consts, int64_t B, int full_rounds,
                 int partial_rounds, const void* p, uint32_t n0, void* stream) {
  const uint32_t* pw = (const uint32_t*)p;
  const int n_words = poseidon2_words(W, full_rounds, partial_rounds, 8);
  if (carry_chains<8>(pw))
    return launch_poseidon2<F1c<8>, W, 8>(out, in, consts, B, full_rounds, partial_rounds, n_words, pw, n0,
                                          (cudaStream_t)stream);
  return launch_poseidon2<F1<8>, W, 8>(out, in, consts, B, full_rounds, partial_rounds, n_words, pw, n0,
                                       (cudaStream_t)stream);
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
