// The round functions of the Poseidon kernels (poseidon_kernel.cu, K5 and
// K6; poseidon2_kernel.cu, K7) on one state held in registers (K5 also on
// a group of four lanes), and what they share: the state layout at the
// kernel boundary, the constant buffer layout and the S-box. Compiles as host C++ too (field.cuh's OZL_HD), so
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

// x^5 as two squarings and a product (over F1, or F1c for K5)
template <class Fd, int NW>
OZL_HD Fp<NW> pow5(const Fd& F, const Fp<NW>& x) {
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

// K5's MDS product M x: output o is sum_k M(o, k) x_k, W products summed
// unreduced (F1c::mac_sum) and reduced once; needs W p < 2 R (W = 3:
// BN254 Fr and BLS12-381 Fr)
template <int W, int NW>
OZL_HD Fp<NW> mds_row(const F1c<NW>& F, const Fp<NW> (&x)[W], const uint32_t* row) {
  Fp<NW> m[W];
#pragma unroll
  for (int k = 0; k < W; ++k) m[k] = word_fp<NW>(row + k * NW);
  uint32_t acc[2 * NW + 1];
  F1c<NW>::template mac_sum<W>(acc, x, m);
  return F.redc(acc);
}

// K5 rounds on one state over the constant buffer [round keys (rounds, W,
// NW); MDS (W, W, NW)]: add keys, S-box (every element in full rounds,
// element 0 in partial rounds), M x
template <int W, int NW>
OZL_HD void poseidon_rounds(const F1c<NW>& F, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
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
    Fp<NW> y[W];
#pragma unroll
    for (int o = 0; o < W; ++o) y[o] = mds_row<W, NW>(F, x, mds + (size_t)o * W * NW);
#pragma unroll
    for (int o = 0; o < W; ++o) x[o] = y[o];
  }
}

// x[o] for a lane-dependent o, by selects (no local-memory indexing)
template <int W, int NW>
OZL_HD Fp<NW> pick(const Fp<NW> (&x)[W], int o) {
  Fp<NW> r = x[0];
#pragma unroll
  for (int k = 1; k < W; ++k)
    if (o == k) r = x[k];
  return r;
}

// K5 for narrow batches: one width-3 state on a group of kSplit = 4 lanes
// that run the same instructions on different operands. Every lane holds
// the whole state between rounds; lane o < 3 owns state element and MDS row
// o, lane 3 helps with row 0. Full round: lanes 0-2 take their element's
// S-box at once, exchange the results, and each reduces its row once
// (mds_row). Partial round, three products on every lane: lane 0 computes
// x0^2, x0^4, x0^5, while lane o computes M(o, 1) x1 and M(o, 2) x2 (lane
// 3 for row 0) and adds them; lane 0 trades x0^5 for row 0's part, and
// every lane ends with one product, part + M(o, 0) x0^5. The serial chain
// per round is 3 S-box products and one row (full) or 4 products
// (partial), against 3 S-boxes and 3 rows (full) or 1 S-box and 3 rows
// (partial) on one thread. `G` exchanges one word within the group:
// g.shfl(v, src) returns lane src's v (__shfl_sync on the card).
constexpr int kSplit = 4;

template <int NW, class G>
OZL_HD Fp<NW> shfl_fp(G& g, const Fp<NW>& v, int src) {
  Fp<NW> r;
#pragma unroll
  for (int w = 0; w < NW; ++w) r.w[w] = g.shfl(v.w[w], src);
  return r;
}

template <int NW, class G>
OZL_HD void poseidon_split_lane(const F1c<NW>& F, G& g, int lane, Fp<NW> (&x)[3], const uint32_t* c,
                                int full_rounds, int partial_rounds) {
  constexpr int W = 3;
  static_assert(W + 1 == kSplit, "three rows and a helper lane");
  const int rounds = full_rounds + partial_rounds;
  const int half = full_rounds / 2;
  const uint32_t* mds = c + (size_t)rounds * W * NW;
  const int o = lane < W ? lane : 0;
  const uint32_t* row = mds + (size_t)o * W * NW;
  const bool head = lane == 0;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const uint32_t* kr = c + (size_t)r * W * NW;
#pragma unroll
    for (int j = 0; j < W; ++j) x[j] = F.add(x[j], word_fp<NW>(kr + j * NW));
    Fp<NW> y;
    if (r < half || r >= half + partial_rounds) {
      const Fp<NW> z = pow5(F, pick<W, NW>(x, o));
      Fp<NW> zs[W];
#pragma unroll
      for (int k = 0; k < W; ++k) zs[k] = shfl_fp<NW>(g, z, k);
      y = mds_row<W, NW>(F, zs, row);
    } else {
      const Fp<NW> m1 = word_fp<NW>(row + NW), m2 = word_fp<NW>(row + 2 * NW);
      const Fp<NW> u = F.mul(head ? x[0] : m1, head ? x[0] : x[1]);
      const Fp<NW> v = F.mul(head ? u : m2, head ? u : x[2]);
      const Fp<NW> s = F.mul(v, x[0]);
      const Fp<NW> part = F.add(u, v);
      const Fp<NW> got = shfl_fp<NW>(g, head ? s : part, head ? W : 0);
      y = F.add(head ? got : part, F.mul(word_fp<NW>(row), head ? s : got));
    }
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = shfl_fp<NW>(g, y, k);
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

// K6 and K7 run through permute_kernel; K5 has its own (poseidon_kernel.cu)
enum PermKind { kPoseidonOpt = 1, kPoseidon2 = 2 };

template <int KIND, int W, int NW>
OZL_HD void run_rounds(const F1<NW>& F, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
                       int partial_rounds) {
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
