// The round functions of the Poseidon kernels (poseidon_kernel.cu, K5 and
// K6; poseidon2_kernel.cu, K7) and what they share: the state layout at the
// kernel boundary, the constant buffer layout and the S-box. K5's and K6's
// rounds are written once over a state accessor: `Regs`, the state in
// registers at a compile-time width (width 3), or `Slot`, the state in a
// thread's slot of shared memory at a run-time width (every other width);
// K5 also runs on a group of four lanes at width 3. Compiles as host C++
// too (field.cuh's OZL_HD), so the rounds can be run on the host against
// the plain torch versions.
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

// x^5 as two squarings and a product (over F1c for K5 and K6, F1 for K7)
template <class Fd, int NW>
OZL_HD Fp<NW> pow5(const Fd& F, const Fp<NW>& x) {
  Fp<NW> x2 = F.sqr(x);
  Fp<NW> x4 = F.sqr(x2);
  return F.mul(x4, x);
}

// A thread's state of W elements, read and written one element at a time
// by the round functions below. Regs: in registers, W fixed at compile
// time, every loop over the elements unrolled (kUnroll = W). Slot: in
// shared memory, W a run-time argument, the loops rolled (kUnroll = 1), so
// one instantiation serves every width; word w of element j lies at
// base[(j NW + w) stride] (stride = the block's threads, so a warp's
// accesses fall in distinct banks). A state of W NW words fills the
// registers from width 5 or so, and with the W results of an MDS product
// it overflows them: the other widths keep it in a slot, and each round
// writes its product one element at a time into a second slot.
template <int W, int NW>
struct Regs {
  static constexpr int kUnroll = W;
  Fp<NW> v[W];

  OZL_HD int width() const { return W; }
  OZL_HD Fp<NW> get(int j) const { return v[j]; }
  OZL_HD void set(int j, const Fp<NW>& a) { v[j] = a; }
};

template <int NW>
struct Slot {
  static constexpr int kUnroll = 1;
  uint32_t* base;
  int stride;
  int w;

  OZL_HD int width() const { return w; }

  OZL_HD Fp<NW> get(int j) const {
    Fp<NW> r;
#pragma unroll
    for (int k = 0; k < NW; ++k) r.w[k] = base[(j * NW + k) * stride];
    return r;
  }

  OZL_HD void set(int j, const Fp<NW>& v) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) base[(j * NW + k) * stride] = v.w[k];
  }
};

// acc (2 NW + 1 words) += a b, the sum known to fit: row i adds a b_i at
// word i and carries up to the top word
template <int NW>
OZL_HD void mac_acc(uint32_t* acc, const Fp<NW>& a, const Fp<NW>& b) {
  Carry cc;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t* t = acc + i;
    const int top = 2 * NW - i;
    const uint32_t bi = b.w[i];
    t[0] = mad_lo_cc(a.w[0], bi, t[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(a.w[j], bi, t[j], cc);
#pragma unroll
    for (int j = NW; j < top; ++j) t[j] = addc_cc(t[j], 0, cc);
    t[top] = addc(t[top], 0, cc);
    t[1] = mad_hi_cc(a.w[0], bi, t[1], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1], cc);
#pragma unroll
    for (int j = NW + 1; j < top; ++j) t[j] = addc_cc(t[j], 0, cc);
    t[top] = addc(t[top], 0, cc);
  }
}

// The most products F1c::redc can take summed unreduced: K p < 2 R. From
// p's top word alone, p < (top + 1) 2^(32 NW - 32), so K = floor((2^33 -
// 1) / (top + 1)) keeps K p < 2^(32 NW + 1) (10 for BN254 Fr, 4 for
// BLS12-381 Fr).
OZL_HD int mac_group(uint32_t p_top) { return (int)(0x1FFFFFFFFull / ((uint64_t)p_top + 1)); }

// K5's MDS row: sum_k M(o, k) x_k for the row at `row`. On registers
// (and the split lanes' exchanged state) all W products are summed
// unreduced (F1c::mac_sum, whose carries stop early) and reduced once,
// which needs W p < 2 R: W <= 4 for both fields. On a slot the row is
// summed in groups of at most `group` products (mac_group), each
// unreduced (mac_acc) and reduced once, and the reduced parts added.
template <int W, int NW>
OZL_HD Fp<NW> mds_row(const F1c<NW>& F, const Fp<NW> (&x)[W], const uint32_t* row) {
  static_assert(W <= 4, "W p < 2 R");
  Fp<NW> m[W];
#pragma unroll
  for (int k = 0; k < W; ++k) m[k] = word_fp<NW>(row + k * NW);
  uint32_t acc[2 * NW + 1];
  F1c<NW>::template mac_sum<W>(acc, x, m);
  return F.redc(acc);
}

template <int W, int NW>
OZL_HD Fp<NW> mds_row(const F1c<NW>& F, const Regs<W, NW>& x, const uint32_t* row, int) {
  return mds_row<W, NW>(F, x.v, row);
}

template <int NW>
OZL_HD Fp<NW> mds_row(const F1c<NW>& F, const Slot<NW>& x, const uint32_t* row, int group) {
  const int W = x.width();
  Fp<NW> out = F1<NW>::zero();
#pragma unroll 1
  for (int k0 = 0; k0 < W; k0 += group) {
    uint32_t acc[2 * NW + 1];
#pragma unroll
    for (int j = 0; j <= 2 * NW; ++j) acc[j] = 0;
    const int k1 = k0 + group < W ? k0 + group : W;
#pragma unroll 1
    for (int k = k0; k < k1; ++k) mac_acc<NW>(acc, x.get(k), word_fp<NW>(row + k * NW));
    out = F.add(out, F.redc(acc));
  }
  return out;
}

// K5 rounds on state x (S = Regs or Slot), with y for the MDS product,
// over the constant buffer [round keys (rounds, W, NW); MDS (W, W, NW)]:
// add keys, S-box (every element in full rounds, element 0 in partial
// rounds), M x. Returns the state that holds the result.
template <class S, int NW>
OZL_HD S poseidon_rounds(const F1c<NW>& F, S x, S y, int group, const uint32_t* c, int full_rounds,
                         int partial_rounds) {
  const int W = x.width();
  const int rounds = full_rounds + partial_rounds;
  const int half = full_rounds / 2;
  const uint32_t* mds = c + (size_t)rounds * W * NW;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const uint32_t* kr = c + (size_t)r * W * NW;
    const bool full = r < half || r >= half + partial_rounds;
#pragma unroll (S::kUnroll)
    for (int j = 0; j < W; ++j) {
      Fp<NW> v = F.add(x.get(j), word_fp<NW>(kr + j * NW));
      if (j == 0 || full) v = pow5(F, v);
      x.set(j, v);
    }
#pragma unroll (S::kUnroll)
    for (int o = 0; o < W; ++o) y.set(o, mds_row(F, x, mds + (size_t)o * W * NW, group));
    const S t = x;
    x = y;
    y = t;
  }
  return x;
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

OZL_HD int poseidon_words(int W, int full_rounds, int partial_rounds, int NW) {
  return ((full_rounds + partial_rounds) * W + W * W) * NW;
}

// x + a b as one Montgomery reduction: redc(a b + x R) = a b R^-1 + x, x R
// being x's words shifted up by NW. The sum stays below p^2 + p R < 2 p R
// < R^2 (p < R / 2), which F1c::redc takes: its low half reduces to at most
// p, the high half is below 2 p, and it subtracts p at most twice (K6's
// v_rest updates)
template <int NW>
OZL_HD Fp<NW> mul_add(const F1c<NW>& F, const Fp<NW>& a, const Fp<NW>& b, const Fp<NW>& x) {
  uint32_t acc[2 * NW + 1];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    acc[j] = 0;
    acc[NW + j] = x.w[j];
  }
  acc[2 * NW] = 0;
  mac_acc<NW>(acc, a, b);
  return F.redc(acc);
}

// K6 rounds on state x (S = Regs or Slot), with y for the dense products,
// over [initial (W, NW); full keys (R_F - 1, W, NW); partial keys (R_P,
// NW); pre_sparse transposed (W, W, NW); MDS (W, W, NW); w_hat (R_P, W,
// NW); v_rest (R_P, W - 1, NW)], on F1c. Full round r: S-box, post-S-box
// keys (none in the last round), then every output as a row (mds_row:
// products summed unreduced in groups of `group`, one reduction a group);
// the boundary round half - 1 takes its rows from pre_sparse, which it
// applies as a row vector at left (x M: output j is column j, which the
// host lays out as row j) and is followed by every partial round: x_0 =
// x_0^5 + key, then out_0 = sum_i x_i w_hat_i as one row and out_j = x_j +
// x_0 v_rest_j as one reduction each (mul_add). Returns the state that
// holds the result.
template <class S, int NW>
OZL_HD S poseidon_opt_rounds(const F1c<NW>& F, S x, S y, int group, const uint32_t* c, int full_rounds,
                             int partial_rounds) {
  const int W = x.width();
  const int half = full_rounds / 2;
  const uint32_t* init = c;
  const uint32_t* fkeys = init + W * NW;
  const uint32_t* pkeys = fkeys + (size_t)(full_rounds - 1) * W * NW;
  const uint32_t* pre = pkeys + (size_t)partial_rounds * NW;
  const uint32_t* mds = pre + W * W * NW;
  const uint32_t* w_hat = mds + W * W * NW;
  const uint32_t* v_rest = w_hat + (size_t)partial_rounds * W * NW;
#pragma unroll (S::kUnroll)
  for (int j = 0; j < W; ++j) x.set(j, F.add(x.get(j), word_fp<NW>(init + j * NW)));
#pragma unroll 1
  for (int r = 0; r < full_rounds; ++r) {
#pragma unroll (S::kUnroll)
    for (int j = 0; j < W; ++j) {
      Fp<NW> v = pow5(F, x.get(j));
      if (r < full_rounds - 1) v = F.add(v, word_fp<NW>(fkeys + ((size_t)r * W + j) * NW));
      x.set(j, v);
    }
    const bool boundary = r == half - 1;
    const uint32_t* m = boundary ? pre : mds;
#pragma unroll (S::kUnroll)
    for (int o = 0; o < W; ++o) y.set(o, mds_row(F, x, m + (size_t)o * W * NW, group));
    const S t = x;
    x = y;
    y = t;
    if (!boundary) continue;
#pragma unroll 1
    for (int q = 0; q < partial_rounds; ++q) {
      const uint32_t* vr = v_rest + (size_t)q * (W - 1) * NW;
      const Fp<NW> x0 = F.add(pow5(F, x.get(0)), word_fp<NW>(pkeys + (size_t)q * NW));
      x.set(0, x0);
      const Fp<NW> out0 = mds_row(F, x, w_hat + (size_t)q * W * NW, group);
#pragma unroll (S::kUnroll)
      for (int j = 1; j < W; ++j) x.set(j, mul_add(F, x0, word_fp<NW>(vr + (j - 1) * NW), x.get(j)));
      x.set(0, out0);
    }
  }
  return x;
}

OZL_HD int poseidon_opt_words(int W, int full_rounds, int partial_rounds, int NW) {
  return (W + (full_rounds - 1) * W + partial_rounds + 2 * W * W + partial_rounds * W +
          partial_rounds * (W - 1)) * NW;
}

// ---------------------------------------------------------------------------
// K7, Poseidon2: lazily reduced linear layers
// ---------------------------------------------------------------------------

// A linear-layer value in NW + 1 words: sums of field elements and their
// small-integer multiples, carried in one extra word and reduced once
template <int NW>
struct Wide {
  uint32_t w[NW + 1];
};

template <int NW>
OZL_HD Wide<NW> widen(const Fp<NW>& a) {
  Wide<NW> r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = a.w[j];
  r.w[NW] = 0;
  return r;
}

// a + b, b a field element
template <int NW>
OZL_HD Wide<NW> wide_add(const Wide<NW>& a, const Fp<NW>& b) {
  Wide<NW> r;
  Carry cc;
  r.w[0] = add_cc(a.w[0], b.w[0], cc);
#pragma unroll
  for (int j = 1; j < NW; ++j) r.w[j] = addc_cc(a.w[j], b.w[j], cc);
  r.w[NW] = addc(a.w[NW], 0, cc);
  return r;
}

template <int NW>
OZL_HD Wide<NW> wide_add(const Wide<NW>& a, const Wide<NW>& b) {
  Wide<NW> r;
  Carry cc;
  r.w[0] = add_cc(a.w[0], b.w[0], cc);
#pragma unroll
  for (int j = 1; j < NW; ++j) r.w[j] = addc_cc(a.w[j], b.w[j], cc);
  r.w[NW] = addc(a.w[NW], b.w[NW], cc);
  return r;
}

// a 2^s for s < 32 (funnel shifts; the value stays below 2^(32 NW + 32))
template <int NW>
OZL_HD Wide<NW> wide_shl(const Wide<NW>& a, int s) {
  Wide<NW> r;
#pragma unroll
  for (int j = NW; j > 0; --j) r.w[j] = (a.w[j] << s) | (a.w[j - 1] >> (32 - s));
  r.w[0] = a.w[0] << s;
  return r;
}


// a + c x for a word c: one row of word products (mac_row, 2 NW multiply
// issues), the sum known to fit in NW + 1 words
template <int NW>
OZL_HD Wide<NW> wide_mac(const Wide<NW>& a, const Fp<NW>& x, uint32_t c) {
  Wide<NW> r = a;
  Carry cc;
  mac_row<NW>(r.w, x.w, c, cc);
  return r;
}

OZL_HD uint64_t umulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// floor((2^64 - 1) / (p_top + 1)): the reciprocal reduce_wide estimates a
// quotient with (computed on the host, once a launch)
inline uint64_t quotient_mu(uint32_t p_top) { return ~0ull / ((uint64_t)p_top + 1); }

// v mod p, canonical, for v < K p with K < 2^15, by one small-quotient
// subtraction. With T = floor(v / 2^(32 NW - 32)) (v's top two words),
// q' = floor(T mu / 2^64) underestimates v / p by less than K / p_top +
// 2^-24 < 1 (p_top >= 2^16 for a 16-limb field, 2^29 for the built
// ones), so q' is q = floor(v / p) or q - 1: v - q' p < 2p, and one
// conditional subtraction of p finishes. Cost: one 64-bit high product, one
// row of NW word products (q' p), an (NW + 1)-word subtraction and a
// conditional one, against a reduced addition per term before
template <int NW>
OZL_HD Fp<NW> reduce_wide(const FieldParams<NW>& f, uint64_t mu, const Wide<NW>& v) {
  const uint64_t top = ((uint64_t)v.w[NW] << 32) | v.w[NW - 1];
  const uint32_t q = (uint32_t)umulhi64(top, mu);
  uint32_t m[NW + 1];
#pragma unroll
  for (int j = 0; j <= NW; ++j) m[j] = 0;
  Carry cc;
  mac_row<NW>(m, f.p, q, cc);
  uint32_t r[NW + 1];
  r[0] = sub_cc(v.w[0], m[0], cc);
#pragma unroll
  for (int j = 1; j <= NW; ++j) r[j] = subc_cc(v.w[j], m[j], cc);
  Fp<NW> d;
  d.w[0] = sub_cc(r[0], f.p[0], cc);
#pragma unroll
  for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(r[j], f.p[j], cc);
  subc_cc(r[NW], 0, cc);
  const uint32_t borrow = subc(0, 0, cc);
#pragma unroll
  for (int j = 0; j < NW; ++j) d.w[j] = borrow ? r[j] : d.w[j];
  return d;
}

// The S-box input x + k (x, k < p). On F1c (p < R / 2) the sum is left
// unreduced: x + k < 2p < R, and F1c's square takes x < 2p (x^2 < 4 p^2,
// 4 p < 2 R, the bound of F1c::redc) and its product x^4 x one operand
// below 2p (the CIOS sum stays below x^4 (2p) / R + p < 2p). F1 takes
// reduced operands only.
template <int NW>
OZL_HD Fp<NW> sbox_in(const F1c<NW>&, const Fp<NW>& x, const Fp<NW>& k) {
  Fp<NW> r;
  Carry cc;
  r.w[0] = add_cc(x.w[0], k.w[0], cc);
#pragma unroll
  for (int j = 1; j < NW; ++j) r.w[j] = addc_cc(x.w[j], k.w[j], cc);
  return r;
}

template <int NW>
OZL_HD Fp<NW> sbox_in(const F1<NW>& F, const Fp<NW>& x, const Fp<NW>& k) {
  return F.add(x, k);
}

// M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]] on x[0 .. 3]
// (each < p), by the Poseidon2 paper's chain (appendix B) of eight
// additions and four doublings, all unreduced: t0, t1 < 2p, t2, t3 < 4p,
// t4, t5 < 12p, y0, y2 < 16p, y1, y3 < 12p
template <int NW>
OZL_HD void m4_lazy(const Fp<NW>* x, Wide<NW>* y) {
  const Wide<NW> t0 = wide_add(widen(x[0]), x[1]), t1 = wide_add(widen(x[2]), x[3]);
  const Wide<NW> t2 = wide_add(t1, wide_shl(widen(x[1]), 1));
  const Wide<NW> t3 = wide_add(t0, wide_shl(widen(x[3]), 1));
  const Wide<NW> t4 = wide_add(t3, wide_shl(t1, 2)), t5 = wide_add(t2, wide_shl(t0, 2));
  y[0] = wide_add(t3, t5);
  y[1] = t5;
  y[2] = wide_add(t2, t4);
  y[3] = t4;
}

// Poseidon2 external layer M_E on x (each < p), every output reduced once:
// at width 2 or 3 circ(2, 1[, 1]), x_i + sum x (< (W + 1) p); at width 4k
// 2 M4 blocks on the diagonal and M4 off it, which is M4 on each block of
// four plus, at each of the four positions, the sum of the blocks'
// results there (< 16 p (k + 1), 64 p at width 12)
template <int W, int NW>
OZL_HD void ext_layer(const FieldParams<NW>& f, uint64_t mu, Fp<NW> (&x)[W]) {
  static_assert(W == 2 || W == 3 || W % 4 == 0, "Poseidon2 takes width 2, 3 or 4k");
  if constexpr (W % 4 == 0) {
    Wide<NW> y[W];
#pragma unroll
    for (int b = 0; b < W; b += 4) m4_lazy<NW>(x + b, y + b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Wide<NW> s = y[i];
#pragma unroll
      for (int b = 4; b < W; b += 4) s = wide_add(s, y[b + i]);
#pragma unroll
      for (int b = 0; b < W; b += 4) x[b + i] = reduce_wide<NW>(f, mu, wide_add(y[b + i], s));
    }
  } else {
    Wide<NW> s = wide_add(widen(x[0]), x[1]);
#pragma unroll
    for (int i = 2; i < W; ++i) s = wide_add(s, x[i]);
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = reduce_wide<NW>(f, mu, wide_add(s, x[i]));
  }
}

// Poseidon2 internal layer sum x + diag_i x_i (each x_j < p), each output
// one row of word products on the shared sum and one reduction: below
// (W + diag_i) p, at most 34 p (BLS12-381 Fr width 8: 8 + 26)
template <int W, int NW>
OZL_HD void int_layer(const FieldParams<NW>& f, uint64_t mu, Fp<NW> (&x)[W], const uint32_t* diag) {
  Wide<NW> s = wide_add(widen(x[0]), x[1]);
#pragma unroll
  for (int i = 2; i < W; ++i) s = wide_add(s, x[i]);
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = reduce_wide<NW>(f, mu, wide_mac(s, x[i], diag[i]));
}

// K7 rounds over [ext keys (R_F, W, NW); int keys (R_P, NW); diag (W,)]
// on Fd = F1c or F1 (`carry_chains`): one external layer, R_F / 2
// external rounds (add keys, S-box all, external layer), R_P internal
// rounds (add a key to x_0, S-box x_0, sum x + diag_i x_i), R_F / 2
// external rounds. Every layer output is canonical; mu = quotient_mu(p's
// top word)
template <class Fd, int W, int NW>
OZL_HD void poseidon2_rounds(const Fd& F, uint64_t mu, Fp<NW> (&x)[W], const uint32_t* c, int full_rounds,
                             int partial_rounds) {
  const int half = full_rounds / 2;
  const uint32_t* ext_keys = c;
  const uint32_t* int_keys = c + (size_t)full_rounds * W * NW;
  const uint32_t* diag = int_keys + (size_t)partial_rounds * NW;
  ext_layer<W, NW>(F.f, mu, x);
#pragma unroll 1
  for (int r = 0; r < full_rounds + partial_rounds; ++r) {
    const bool external = r < half || r >= half + partial_rounds;
    const uint32_t* k = external ? ext_keys + (size_t)(r < half ? r : r - partial_rounds) * W * NW
                                 : int_keys + (size_t)(r - half) * NW;
    x[0] = pow5(F, sbox_in(F, x[0], word_fp<NW>(k)));
    if (external) {
#pragma unroll
      for (int j = 1; j < W; ++j) x[j] = pow5(F, sbox_in(F, x[j], word_fp<NW>(k + j * NW)));
      ext_layer<W, NW>(F.f, mu, x);
    } else {
      int_layer<W, NW>(F.f, mu, x, diag);
    }
  }
}

OZL_HD int poseidon2_words(int W, int full_rounds, int partial_rounds, int NW) {
  return (full_rounds * W + partial_rounds) * NW + W;
}

// K5 and K6 kernels: their own register kernels at width 3
// (poseidon_kernel.cu), slot_kernel at the other widths
enum PermKind { kPoseidon = 0, kPoseidonOpt = 1 };

#ifdef __CUDACC__
// K7, one thread per state: stage the constants in shared memory (every
// thread of the block reaches the barrier), load the state, run the
// rounds on Fd, store.
template <class Fd, int W, int NW>
__global__ void poseidon2_kernel(int32_t* out, const int32_t* in, const int32_t* consts, int64_t B,
                                 int full_rounds, int partial_rounds, int n_words, FieldParams<NW> f,
                                 uint64_t mu) {
  extern __shared__ uint32_t sm[];
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = (uint32_t)consts[e];
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Fd F;
  F.f = f;
  Fp<NW> x[W];
  load_state<W, NW>(x, in, B, b);
  poseidon2_rounds<Fd, W, NW>(F, mu, x, sm, full_rounds, partial_rounds);
  store_state<W, NW>(out, B, b, x);
}

// Launch K7 on `st` with 128 threads a block and the constants in shared
// memory; returns cudaGetLastError().
template <class Fd, int W, int NW>
int launch_poseidon2(void* out, const void* in, const void* consts, int64_t B, int full_rounds,
                     int partial_rounds, int n_words, const uint32_t* p, uint32_t n0, cudaStream_t st) {
  constexpr int threads = 128;
  const size_t smem = sizeof(uint32_t) * (size_t)n_words;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(poseidon2_kernel<Fd, W, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    poseidon2_kernel<Fd, W, NW><<<(unsigned)blocks, threads, smem, st>>>(
        (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, full_rounds, partial_rounds,
        n_words, make_params<NW>(p, n0), quotient_mu(p[NW - 1]));
  return (int)cudaGetLastError();
}

// K5 (kPoseidon) or K6 (kPoseidonOpt), both over F1c with their dense
// rows in groups of `group` products, at a run-time width W, one thread
// per state: dynamic shared memory holds the constants, then the threads'
// x slots, then their y slots (W NW words each)
template <int KIND, int NW>
__global__ void __launch_bounds__(128)
    slot_kernel(int32_t* out, const int32_t* in, const int32_t* consts, int64_t B, int W, int group,
                int full_rounds, int partial_rounds, int n_words, FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = (uint32_t)consts[e];
  __syncthreads();
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int T = blockDim.x;
  Slot<NW> x{sm + n_words + threadIdx.x, T, W};
  const Slot<NW> y{sm + n_words + W * NW * T + threadIdx.x, T, W};
#pragma unroll 1
  for (int j = 0; j < W; ++j) x.set(j, load_fp<NW>(in + (int64_t)j * B, (int64_t)W * B, b));
  F1c<NW> F;
  F.f = f;
  if constexpr (KIND == kPoseidon)
    x = poseidon_rounds<Slot<NW>, NW>(F, x, y, group, sm, full_rounds, partial_rounds);
  else
    x = poseidon_opt_rounds<Slot<NW>, NW>(F, x, y, group, sm, full_rounds, partial_rounds);
#pragma unroll 1
  for (int j = 0; j < W; ++j) store_fp<NW>(out + (int64_t)j * B, (int64_t)W * B, b, x.get(j));
}

// The shared memory a block can have on Hopper (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

// Launch slot_kernel on `st` with the largest block of 128, 64 or 32
// threads whose constants and state slots fit kMaxBlockSmem; returns
// cudaGetLastError(), or cudaErrorInvalidValue if 32 threads do not fit.
template <int KIND, int NW>
int launch_slot(void* out, const void* in, const void* consts, int64_t B, int W, int group,
                int full_rounds, int partial_rounds, int n_words, const uint32_t* p, uint32_t n0,
                cudaStream_t st) {
  int threads = 128;
  auto smem = [&](int t) { return sizeof(uint32_t) * ((size_t)n_words + (size_t)2 * W * NW * t); };
  while (threads > 32 && smem(threads) > kMaxBlockSmem) threads /= 2;
  const size_t bytes = smem(threads);
  if (bytes > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(slot_kernel<KIND, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + threads - 1) / threads;
  if (blocks > 0)
    slot_kernel<KIND, NW><<<(unsigned)blocks, threads, bytes, st>>>(
        (int32_t*)out, (const int32_t*)in, (const int32_t*)consts, B, W, group, full_rounds,
        partial_rounds, n_words, make_params<NW>(p, n0));
  return (int)cudaGetLastError();
}
#endif
