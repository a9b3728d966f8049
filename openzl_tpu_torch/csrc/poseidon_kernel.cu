// K5: classic Poseidon permutation, and K6: the optimized permutation.
//
// K5 replaces openzl_tpu/ops/poseidon_kernel.py `_kernel` (:158, through
// `permute_lanes()` / `permute()` / `hash_batch()`): per round add the round
// keys, S-box x^5 (every element in full rounds, element 0 in partial
// rounds), then the dense MDS product M x. K6 replaces `_kernel_opt` (:198,
// through `permute_lanes_opt()`): the same permutation with the constants
// moved after the S-box and the partial rounds' MDS factored into sparse
// matrices. The rounds are in poseidon.cuh (`poseidon_rounds` and
// `poseidon_split_lane` for K5, `poseidon_opt_rounds` for K6).
//
// K5 has two variants; the wrapper picks one from the batch B
// (ops/poseidon_kernel.py `SPLIT_MAX_B`):
//   * wide (large B): one thread per state. Bound on the card: integer
//     multiplies. The field arithmetic is F1c (field.cuh): CIOS products on
//     PTX carry chains, a dedicated square for the S-box, and each MDS row
//     as W products summed unreduced with one reduction (at width 3 a row
//     costs 3 NW^2 + NW^2 + NW/2 word products instead of 3 (2 NW^2 +
//     NW/2)).
//   * split (narrow B, e.g. the upper levels of a Merkle build): four lanes
//     per state (poseidon_split_lane). A level of a few thousand states
//     leaves most of the card idle, so the time is one state's serial chain
//     of products; spreading the state over lanes cuts that chain to about
//     half (3 S-box products and one row per full round, 4 products per
//     partial round), at twice the total work.
// Both read and write the (n_limbs, W, B) limb layout of the port and
// return fully reduced elements, so each is bit-equal to `permute_plain`.
// The constants (6.2 KB for K5, 11.6 KB for K6 at width 3) are staged in
// shared memory by each block and read as broadcasts.
//
// K6 runs one thread per state (poseidon_opt_kernel below, the state in
// registers, at width 3) on K5's arithmetic: F1c, the S-box's dedicated
// square, and every dense output, M x in the full rounds, the boundary
// round's x pre_sparse (its columns laid out as rows by the host) and
// each partial round's w_hat row, as a row of products summed unreduced
// and reduced once per group (mds_row); each partial round's W - 1
// updates x_j + x_0 v_rest_j are one reduction each, x_j folded into it
// (mul_add). Bound on the card: the integer multiply issue of those word
// products, which the design cuts from one full Montgomery product (and
// one reduced addition) per matrix entry, as K6 was first written, to one
// multiply-accumulate per entry and one reduction per row or group.
//
// Every other width, 2 and 4 to 17 (arity 1 to 16, the reference's pinned
// widths 2-6, 9 and 17 and the searched ones between), runs one kernel
// whose width is a run-time argument (slot_kernel in poseidon.cuh), for K5
// and for K6, through the same round functions as width 3 (on a `Slot`
// instead of `Regs`): a thread keeps its state in its slot of shared
// memory beside the constants (45.7 KB for K5 and 87.0 KB for K6 at width
// 17) and writes each round's MDS product, one element at a time, into a
// second slot; the block shrinks from 128 threads where the two exceed
// 227 KB. Both sum a row unreduced in groups of at most K products with K
// p < 2 R (10 for BN254 Fr, 4 for BLS12-381 Fr: mac_group), one reduction
// a group, so BLS12-381 Fr rows past width 4 stay exact. No split variant:
// the Merkle tree, the one caller with narrow batches, hashes at width 3.
#include <cuda_runtime.h>

#include "poseidon.cuh"

namespace {

constexpr int kThreads = 128;

__device__ void stage_consts(uint32_t* sm, const int32_t* consts, int n_words) {
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = (uint32_t)consts[e];
  __syncthreads();
}

template <int W, int NW>
__global__ void __launch_bounds__(kThreads)
    poseidon_wide_kernel(int32_t* out, const int32_t* in, const int32_t* consts, int64_t B,
                         int full_rounds, int partial_rounds, int n_words, FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  stage_consts(sm, consts, n_words);
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  F1c<NW> F;
  F.f = f;
  Regs<W, NW> x, y{};
  load_state<W, NW>(x.v, in, B, b);
  x = poseidon_rounds<Regs<W, NW>, NW>(F, x, y, W, sm, full_rounds, partial_rounds);
  store_state<W, NW>(out, B, b, x.v);
}

// K6 on registers, with no launch bounds: ptxas gives it 88 registers and
// no spill. Bounds of kThreads and one block an SM gave 138 registers and
// a slower kernel, six blocks 80 registers and 8 B of spill stores
// (PERF.md).
template <int W, int NW>
__global__ void poseidon_opt_kernel(int32_t* out, const int32_t* in, const int32_t* consts,
                                    int64_t B, int full_rounds, int partial_rounds, int n_words,
                                    FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  stage_consts(sm, consts, n_words);
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  F1c<NW> F;
  F.f = f;
  Regs<W, NW> x, y{};
  load_state<W, NW>(x.v, in, B, b);
  x = poseidon_opt_rounds<Regs<W, NW>, NW>(F, x, y, W, sm, full_rounds, partial_rounds);
  store_state<W, NW>(out, B, b, x.v);
}

template <int W, int NW>
int launch_poseidon_opt(void* out, const void* in, const void* consts, int64_t B, int full_rounds,
                        int partial_rounds, const uint32_t* p, uint32_t n0, cudaStream_t st) {
  const int n_words = poseidon_opt_words(W, full_rounds, partial_rounds, NW);
  const size_t smem = sizeof(uint32_t) * (size_t)n_words;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0)
    poseidon_opt_kernel<W, NW><<<(unsigned)blocks, kThreads, smem, st>>>(
        (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, full_rounds, partial_rounds,
        n_words, make_params<NW>(p, n0));
  return (int)cudaGetLastError();
}

// the lane exchange of poseidon_split_lane: groups of kSplit lanes
struct WarpGroup {
  __device__ uint32_t shfl(uint32_t v, int src) { return __shfl_sync(0xffffffffu, v, src, kSplit); }
};

// Every lane of a warp reaches every shuffle: the lanes of groups past B
// repeat the last state and store nothing.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    poseidon_split_kernel(int32_t* out, const int32_t* in, const int32_t* consts, int64_t B,
                          int full_rounds, int partial_rounds, int n_words, FieldParams<NW> f) {
  constexpr int W = 3;
  extern __shared__ uint32_t sm[];
  stage_consts(sm, consts, n_words);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t % kSplit);
  const int64_t b = t / kSplit;
  const int64_t bl = b < B ? b : B - 1;
  const int o = lane < W ? lane : 0;
  F1c<NW> F;
  F.f = f;
  WarpGroup g;
  const Fp<NW> mine = load_fp<NW>(in + o * B, (int64_t)W * B, bl);
  Fp<NW> x[W];
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = shfl_fp<NW>(g, mine, k);
  poseidon_split_lane<NW>(F, g, lane, x, sm, full_rounds, partial_rounds);
  if (b < B && lane < W) store_fp<NW>(out + lane * B, (int64_t)W * B, b, pick<W, NW>(x, lane));
}

template <int W, int NW>
int launch_poseidon(void* out, const void* in, const void* consts, int64_t B, int split,
                    int full_rounds, int partial_rounds, const uint32_t* p, uint32_t n0,
                    cudaStream_t st) {
  const int n_words = poseidon_words(W, full_rounds, partial_rounds, NW);
  const size_t smem = sizeof(uint32_t) * (size_t)n_words;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int64_t threads = split ? B * kSplit : B;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  const FieldParams<NW> f = make_params<NW>(p, n0);
  if (blocks > 0) {
    if (split)
      poseidon_split_kernel<NW><<<(unsigned)blocks, kThreads, smem, st>>>(
          (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, full_rounds,
          partial_rounds, n_words, f);
    else
      poseidon_wide_kernel<W, NW><<<(unsigned)blocks, kThreads, smem, st>>>(
          (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, full_rounds,
          partial_rounds, n_words, f);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Built for 16-limb (8-word) fields: K5 and K6 at widths 2 to
// kMaxWidth, width 3 through its own instantiations, where the top word
// of p is below 0x7FFFFFFF (F1c). Anything else is refused with
// cudaErrorInvalidValue (the wrapper checks first). `split` picks K5's
// four-lanes-per-state variant, built for width 3 only.
constexpr int kMaxWidth = 17;

extern "C" int ozl_poseidon_permute(void* out, const void* in, const void* consts, int64_t B,
                                    int split, int width, int full_rounds, int partial_rounds,
                                    int n_limbs, const void* p, uint32_t n0, void* stream) {
  const uint32_t* pw = (const uint32_t*)p;
  if (width < 2 || width > kMaxWidth || n_limbs != 16 || pw[7] >= 0x7FFFFFFFu || (split && width != 3))
    return (int)cudaErrorInvalidValue;
  if (width == 3)
    return launch_poseidon<3, 8>(out, in, consts, B, split, full_rounds, partial_rounds, pw, n0,
                                 (cudaStream_t)stream);
  return launch_slot<kPoseidon, 8>(out, in, consts, B, width, mac_group(pw[7]), full_rounds, partial_rounds,
                                   poseidon_words(width, full_rounds, partial_rounds, 8), pw, n0,
                                   (cudaStream_t)stream);
}

extern "C" int ozl_poseidon_permute_opt(void* out, const void* in, const void* consts, int64_t B,
                                        int width, int full_rounds, int partial_rounds,
                                        int n_limbs, const void* p, uint32_t n0, void* stream) {
  const uint32_t* pw = (const uint32_t*)p;
  if (width < 2 || width > kMaxWidth || n_limbs != 16 || pw[7] >= 0x7FFFFFFFu)
    return (int)cudaErrorInvalidValue;
  if (width == 3)
    return launch_poseidon_opt<3, 8>(out, in, consts, B, full_rounds, partial_rounds, pw, n0,
                                     (cudaStream_t)stream);
  return launch_slot<kPoseidonOpt, 8>(out, in, consts, B, width, mac_group(pw[7]), full_rounds, partial_rounds,
                                      poseidon_opt_words(width, full_rounds, partial_rounds, 8), pw, n0,
                                      (cudaStream_t)stream);
}
