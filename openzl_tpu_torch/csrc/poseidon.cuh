// The round functions of the Poseidon kernels (poseidon_kernel.cu, K5 and
// K6; poseidon2_kernel.cu, K7) on one state held in registers, and what
// they share: the state layout at the kernel boundary, the constant buffer
// layout and the S-box. Compiles as host C++ too (field.cuh's OZL_HD), so
// the rounds can be run on the host against the plain torch versions.
#pragma once
#include <stddef.h>

#include "field.cuh"

// A batch of states is (n_limbs, W, B) int32 16-bit limbs: limb k of
// element j of state b at base[(k W + j) B + b], so neighbouring threads
// (states) read neighbouring addresses.
template <int W, int NW>
OZL_HD void load_state(Fp<NW> (&x)[W], const int32_t* base, int64_t B, int64_t b) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = load_fp<NW>(base + j * B, (int64_t)W * B, b);
}

template <int W, int NW>
OZL_HD void store_state(int32_t* base, int64_t B, int64_t b, const Fp<NW> (&x)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) store_fp<NW>(base + j * B, (int64_t)W * B, b, x[j]);
}

// one field element of NW consecutive words of a constant buffer
template <int NW>
OZL_HD Fp<NW> word_fp(const uint32_t* s) {
  Fp<NW> r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.w[w] = s[w];
  return r;
}

// x^5 as two squarings and a product
template <int NW>
OZL_HD Fp<NW> pow5(const F1<NW>& F, const Fp<NW>& x) {
  Fp<NW> x2 = F.sqr(x);
  Fp<NW> x4 = F.sqr(x2);
  return F.mul(x4, x);
}

// out_o = sum_k M(o, k) x_k with M(o, k) at m[(o * so + k * sk) * NW]:
// (so, sk) = (W, 1) is the product M x, (1, W) the row vector at left x M
template <int W, int NW>
OZL_HD void mat_apply(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* m, int so, int sk) {
  Fp<NW> y[W];
#pragma unroll
  for (int o = 0; o < W; ++o) {
    y[o] = F.mul(x[0], word_fp<NW>(m + (size_t)(o * so) * NW));
#pragma unroll
    for (int k = 1; k < W; ++k) y[o] = F.add(y[o], F.mul(x[k], word_fp<NW>(m + (size_t)(o * so + k * sk) * NW)));
  }
#pragma unroll
  for (int o = 0; o < W; ++o) x[o] = y[o];
}

// K5 rounds over the constant buffer [round keys (rounds, W, NW);
// MDS (W, W, NW)]: add keys, S-box (every element in full rounds, element
// 0 in partial rounds), M x
template <int W, int NW>
OZL_HD void poseidon_rounds(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
                            int partial_rounds) {
  const int rounds = full_rounds + partial_rounds;
  const int half = full_rounds / 2;
  const uint32_t* mds = c + (size_t)rounds * W * NW;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const uint32_t* kr = c + (size_t)r * W * NW;
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = F.add(x[j], word_fp<NW>(kr + j * NW));
    x[0] = pow5(F, x[0]);
    if (r < half || r >= half + partial_rounds) {
#pragma unroll
      for (int j = 1; j < W; ++j) x[j] = pow5(F, x[j]);
    }
    mat_apply<W, NW>(F, x, mds, W, 1);
  }
}

template <int W>
OZL_HD int poseidon_words(int full_rounds, int partial_rounds, int NW) {
  return ((full_rounds + partial_rounds) * W + W * W) * NW;
}

// K6 rounds over [initial (W, NW); full keys (R_F - 1, W, NW); partial keys
// (R_P, NW); pre_sparse (W, W, NW); MDS (W, W, NW); w_hat (R_P, W, NW);
// v_rest (R_P, W - 1, NW)]. Full round r: S-box, post-S-box keys (none in
// the last round), M x; the boundary round half - 1 applies pre_sparse as a
// row vector at left (x M, it is not symmetric) and is followed by every
// partial round: x_0 = x_0^5 + key, then out_0 = sum_i x_i w_hat_i and
// out_j = x_j + x_0 v_rest_j.
template <int W, int NW>
OZL_HD void poseidon_opt_rounds(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* c,
                                int full_rounds, int partial_rounds) {
  const int half = full_rounds / 2;
  const uint32_t* init = c;
  const uint32_t* fkeys = init + W * NW;
  const uint32_t* pkeys = fkeys + (size_t)(full_rounds - 1) * W * NW;
  const uint32_t* pre = pkeys + (size_t)partial_rounds * NW;
  const uint32_t* mds = pre + W * W * NW;
  const uint32_t* w_hat = mds + W * W * NW;
  const uint32_t* v_rest = w_hat + (size_t)partial_rounds * W * NW;
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = F.add(x[j], word_fp<NW>(init + j * NW));
#pragma unroll 1
  for (int r = 0; r < full_rounds; ++r) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      x[j] = pow5(F, x[j]);
      if (r < full_rounds - 1) x[j] = F.add(x[j], word_fp<NW>(fkeys + ((size_t)r * W + j) * NW));
    }
    const bool boundary = r == half - 1;
    mat_apply<W, NW>(F, x, boundary ? pre : mds, boundary ? 1 : W, boundary ? W : 1);
    if (!boundary) continue;
#pragma unroll 1
    for (int q = 0; q < partial_rounds; ++q) {
      const uint32_t* wh = w_hat + (size_t)q * W * NW;
      const uint32_t* vr = v_rest + (size_t)q * (W - 1) * NW;
      const Fp<NW> x0 = F.add(pow5(F, x[0]), word_fp<NW>(pkeys + (size_t)q * NW));
      Fp<NW> out0 = F.mul(x0, word_fp<NW>(wh));
#pragma unroll
      for (int i = 1; i < W; ++i) out0 = F.add(out0, F.mul(x[i], word_fp<NW>(wh + i * NW)));
#pragma unroll
      for (int j = 1; j < W; ++j) x[j] = F.add(x[j], F.mul(x0, word_fp<NW>(vr + (j - 1) * NW)));
      x[0] = out0;
    }
  }
}

template <int W>
OZL_HD int poseidon_opt_words(int full_rounds, int partial_rounds, int NW) {
  return (W + (full_rounds - 1) * W + partial_rounds + 2 * W * W + partial_rounds * W +
          partial_rounds * (W - 1)) * NW;
}

// c x for a small non-negative integer c, by doublings and additions
template <int NW>
OZL_HD Fp<NW> small_mul(const F1<NW>& F, const Fp<NW>& x, uint32_t c) {
  Fp<NW> acc = F1<NW>::zero();
  Fp<NW> d = x;
  while (c) {
    if (c & 1) acc = F.add(acc, d);
    c >>= 1;
    if (c) d = F.dbl(d);
  }
  return acc;
}

// Poseidon2 external layer at width 2 or 3, circ(2, 1[, 1]): x_i + sum x
template <int W, int NW>
OZL_HD void ext_layer(const F1<NW>& F, Fp<NW> (&x)[W]) {
  static_assert(W == 2 || W == 3, "the external layer x_i + sum x is for width 2 or 3");
  Fp<NW> s = x[0];
#pragma unroll
  for (int i = 1; i < W; ++i) s = F.add(s, x[i]);
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = F.add(x[i], s);
}

// K7 rounds over [ext keys (R_F, W, NW); int keys (R_P, NW); diag (W,)]:
// one external layer, R_F / 2 external rounds (add keys, S-box all,
// external layer), R_P internal rounds (add a key to x_0, S-box x_0,
// sum x + diag_i x_i), R_F / 2 external rounds
template <int W, int NW>
OZL_HD void poseidon2_rounds(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
                             int partial_rounds) {
  const int half = full_rounds / 2;
  const uint32_t* ext_keys = c;
  const uint32_t* int_keys = c + (size_t)full_rounds * W * NW;
  const uint32_t* diag = int_keys + (size_t)partial_rounds * NW;
  ext_layer<W, NW>(F, x);
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
    const bool external = r < half || r >= half + partial_rounds;
    const uint32_t* k = external ? ext_keys + (size_t)(r < half ? r : r - partial_rounds) * W * NW
                                 : int_keys + (size_t)(r - half) * NW;
    x[0] = pow5(F, F.add(x[0], word_fp<NW>(k)));
    if (external) {
#pragma unroll
      for (int j = 1; j < W; ++j) x[j] = pow5(F, F.add(x[j], word_fp<NW>(k + j * NW)));
      ext_layer<W, NW>(F, x);
    } else {
      Fp<NW> s = x[0];
#pragma unroll
      for (int i = 1; i < W; ++i) s = F.add(s, x[i]);
#pragma unroll
      for (int i = 0; i < W; ++i) x[i] = F.add(s, small_mul(F, x[i], diag[i]));
    }
  }
}

template <int W>
OZL_HD int poseidon2_words(int full_rounds, int partial_rounds, int NW) {
  return (full_rounds * W + partial_rounds) * NW + W;
}

enum PermKind { kPoseidon = 0, kPoseidonOpt = 1, kPoseidon2 = 2 };

template <int KIND, int W, int NW>
OZL_HD void run_rounds(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
                       int partial_rounds) {
  if constexpr (KIND == kPoseidon) poseidon_rounds<W, NW>(F, x, c, full_rounds, partial_rounds);
  if constexpr (KIND == kPoseidonOpt) poseidon_opt_rounds<W, NW>(F, x, c, full_rounds, partial_rounds);
  if constexpr (KIND == kPoseidon2) poseidon2_rounds<W, NW>(F, x, c, full_rounds, partial_rounds);
}

#ifdef __CUDACC__
// One thread per state: stage the constants in shared memory (every thread
// of the block reaches the barrier), load the state, run the rounds, store.
template <int KIND, int W, int NW>
__global__ void permute_kernel(int32_t* out, const int32_t* in, const int32_t* consts, int64_t B,
                               int full_rounds, int partial_rounds, int n_words,
                               FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = (uint32_t)consts[e];
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const F1<NW> F{f};
  Fp<NW> x[W];
  load_state<W, NW>(x, in, B, b);
  run_rounds<KIND, W, NW>(F, x, sm, full_rounds, partial_rounds);
  store_state<W, NW>(out, B, b, x);
}

// Launch on `st` with 128 threads a block and the constants in shared
// memory; returns cudaGetLastError().
template <int KIND, int W, int NW>
int launch_permute(void* out, const void* in, const void* consts, int64_t B, int full_rounds,
                   int partial_rounds, int n_words, const uint32_t* p, uint32_t n0,
                   cudaStream_t st) {
  constexpr int threads = 128;
  const size_t smem = sizeof(uint32_t) * (size_t)n_words;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(permute_kernel<KIND, W, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    permute_kernel<KIND, W, NW><<<(unsigned)blocks, threads, smem, st>>>(
        (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, full_rounds, partial_rounds,
        n_words, make_params<NW>(p, n0));
  return (int)cudaGetLastError();
}
#endif
