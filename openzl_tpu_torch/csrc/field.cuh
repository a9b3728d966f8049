// Shared prime-field arithmetic for the hand-written kernels.
//
// Counterpart of the TPU kernels' in-core limb helpers
// (openzl_tpu/ops/poseidon_kernel.py `_k_add` :70, `_sub_raw` :55,
// `_cond_sub_p` :65, `_k_mont_mul` :81, `_mont_reduce` :100, and
// openzl_tpu/ops/ec_kernel.py `_k_sub` :46, `_OpsF1`, `_OpsF2`).
//
// Tensors at the kernel boundary hold 16-bit limbs in int32, limb axis
// first (limb-planar). Inside a thread an element is repacked into NW
// 32-bit words (NW = n_limbs / 2), so the Montgomery radix R = 2^(32 NW) =
// 2^(16 n_limbs) is the same as the reference's. The TPU has no 32x32->64
// multiplier and works on 16-bit limbs; here each word product is one
// 64-bit multiply-add, and the Montgomery product is plain CIOS with
// n0 = -p^-1 mod 2^32. Every result is fully reduced to [0, p), so any
// correct algorithm is bit-equal to the reference.
//
// The header also compiles as host C++ (OZL_HD expands to `inline`), so
// the arithmetic can be exercised without a GPU.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define OZL_HD __host__ __device__ __forceinline__
#else
#define OZL_HD inline
#endif

template <int NW>
struct FieldParams {
  uint32_t p[NW];
  uint32_t n0;  // -p^-1 mod 2^32
};

template <int NW>
struct Fp {
  uint32_t w[NW];
};

template <int NW>
struct Fp2 {
  Fp<NW> c0, c1;
};

// ---------------------------------------------------------------------------
// limb-planar loads and stores: limb k of element i at base[k * ls + i]
// ---------------------------------------------------------------------------

template <int NW>
OZL_HD Fp<NW> load_fp(const int32_t* base, int64_t ls, int64_t i) {
  Fp<NW> r;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t lo = (uint32_t)base[(2 * w) * ls + i];
    uint32_t hi = (uint32_t)base[(2 * w + 1) * ls + i];
    r.w[w] = lo | (hi << 16);
  }
  return r;
}

template <int NW>
OZL_HD void store_fp(int32_t* base, int64_t ls, int64_t i, const Fp<NW>& v) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    base[(2 * w) * ls + i] = (int32_t)(v.w[w] & 0xFFFFu);
    base[(2 * w + 1) * ls + i] = (int32_t)(v.w[w] >> 16);
  }
}

// ---------------------------------------------------------------------------
// base field
// ---------------------------------------------------------------------------

template <int NW>
struct F1 {
  using T = Fp<NW>;
  FieldParams<NW> f;

  // raw a - b over NW words; returns the borrow (0 or 1)
  OZL_HD static uint32_t sub_raw(T& r, const T& a, const T& b) {
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t t = (uint64_t)a.w[i] - b.w[i] - br;
      r.w[i] = (uint32_t)t;
      br = (uint32_t)(t >> 63);
    }
    return br;
  }

  OZL_HD T p_as_fp() const {
    T r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = f.p[i];
    return r;
  }

  // x (with an extra top word `hi`) in [0, 2p) -> [0, p)
  OZL_HD T reduce_once(const T& x, uint32_t hi) const {
    T d;
    uint32_t br = sub_raw(d, x, p_as_fp());
    return (hi || !br) ? d : x;
  }

  OZL_HD T add(const T& a, const T& b) const {
    T s;
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t t = (uint64_t)a.w[i] + b.w[i] + c;
      s.w[i] = (uint32_t)t;
      c = (uint32_t)(t >> 32);
    }
    return reduce_once(s, c);
  }

  OZL_HD T dbl(const T& a) const { return add(a, a); }

  OZL_HD T sub(const T& a, const T& b) const {
    T d;
    uint32_t br = sub_raw(d, a, b);
    if (br) {
      uint32_t c = 0;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        uint64_t t = (uint64_t)d.w[i] + f.p[i] + c;
        d.w[i] = (uint32_t)t;
        c = (uint32_t)(t >> 32);
      }
    }
    return d;
  }

  // CIOS Montgomery product a b R^-1 mod p
  OZL_HD T mul(const T& a, const T& b) const {
    uint32_t t[NW + 2];
#pragma unroll
    for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t c = 0;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
        t[j] = (uint32_t)s;
        c = s >> 32;
      }
      uint64_t s = (uint64_t)t[NW] + c;
      t[NW] = (uint32_t)s;
      t[NW + 1] = (uint32_t)(s >> 32);
      uint32_t m = t[0] * f.n0;
      s = (uint64_t)m * f.p[0] + t[0];
      c = s >> 32;
#pragma unroll
      for (int j = 1; j < NW; ++j) {
        s = (uint64_t)m * f.p[j] + t[j] + c;
        t[j - 1] = (uint32_t)s;
        c = s >> 32;
      }
      s = (uint64_t)t[NW] + c;
      t[NW - 1] = (uint32_t)s;
      t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
    }
    T r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = t[i];
    return reduce_once(r, t[NW]);
  }

  OZL_HD T sqr(const T& a) const { return mul(a, a); }

  OZL_HD static bool is_zero(const T& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) acc |= a.w[i];
    return acc == 0;
  }

  OZL_HD static T select(bool m, const T& a, const T& b) { return m ? a : b; }

  // the plain integer 1 (not Montgomery one): the Z = 0 identity of the
  // reference kernels carries X = Y = 1 (ec_kernel.py `one_like`)
  OZL_HD static T raw_one() {
    T r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = 0;
    r.w[0] = 1;
    return r;
  }

  OZL_HD static T zero() {
    T r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = 0;
    return r;
  }
};

// ---------------------------------------------------------------------------
// carry-chain primitives (F1c: K3-K5 and K9): PTX add.cc / addc / mad.lo.cc /
// madc.hi on the card, where the carry flag CC.CF lives between the
// instructions. On the host the same functions emulate the flag in `cc`, so
// the products below also run (and are tested) as host C++. Every asm
// statement is volatile: nvcc must not reorder the links of one chain.
// ---------------------------------------------------------------------------

struct Carry {
  uint32_t cf = 0;  // the host's carry (or borrow) flag; unused on the card
};

#ifdef __CUDA_ARCH__
#define OZL_CC1(op, a, b)                                                 \
  uint32_t r;                                                             \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));             \
  (void)cc;                                                               \
  return r
#define OZL_CC2(op, a, b, c)                                              \
  uint32_t r;                                                             \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
  (void)cc;                                                               \
  return r
// r = lo/hi(a b) + c [+ cf], setting cf where the name says .cc
OZL_HD uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("mad.lo.cc.u32", a, b, c); }
OZL_HD uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("madc.lo.cc.u32", a, b, c); }
OZL_HD uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("mad.hi.cc.u32", a, b, c); }
OZL_HD uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("madc.hi.cc.u32", a, b, c); }
OZL_HD uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("madc.hi.u32", a, b, c); }
OZL_HD uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { OZL_CC2("mad.hi.u32", a, b, c); }
OZL_HD uint32_t add_cc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("add.cc.u32", a, b); }
OZL_HD uint32_t addc_cc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("addc.cc.u32", a, b); }
OZL_HD uint32_t addc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("addc.u32", a, b); }
OZL_HD uint32_t sub_cc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("sub.cc.u32", a, b); }
OZL_HD uint32_t subc_cc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("subc.cc.u32", a, b); }
OZL_HD uint32_t subc(uint32_t a, uint32_t b, Carry& cc) { OZL_CC1("subc.u32", a, b); }
#undef OZL_CC1
#undef OZL_CC2
#else
OZL_HD uint32_t cc_out(uint64_t s, Carry& cc) {
  cc.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
OZL_HD uint64_t lo64(uint32_t a, uint32_t b) { return (uint32_t)((uint64_t)a * b); }
OZL_HD uint64_t hi64(uint32_t a, uint32_t b) { return ((uint64_t)a * b) >> 32; }
OZL_HD uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { return cc_out(lo64(a, b) + c, cc); }
OZL_HD uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { return cc_out(lo64(a, b) + c + cc.cf, cc); }
OZL_HD uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { return cc_out(hi64(a, b) + c, cc); }
OZL_HD uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { return cc_out(hi64(a, b) + c + cc.cf, cc); }
OZL_HD uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c, Carry& cc) { return (uint32_t)(hi64(a, b) + c + cc.cf); }
OZL_HD uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c, Carry&) { return (uint32_t)(hi64(a, b) + c); }
OZL_HD uint32_t add_cc(uint32_t a, uint32_t b, Carry& cc) { return cc_out((uint64_t)a + b, cc); }
OZL_HD uint32_t addc_cc(uint32_t a, uint32_t b, Carry& cc) { return cc_out((uint64_t)a + b + cc.cf, cc); }
OZL_HD uint32_t addc(uint32_t a, uint32_t b, Carry& cc) { return a + b + cc.cf; }
OZL_HD uint32_t sub_cc(uint32_t a, uint32_t b, Carry& cc) {
  cc.cf = a < b;
  return a - b;
}
OZL_HD uint32_t subc_cc(uint32_t a, uint32_t b, Carry& cc) {
  const uint64_t d = (uint64_t)a - b - cc.cf;
  cc.cf = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
OZL_HD uint32_t subc(uint32_t a, uint32_t b, Carry& cc) { return a - b - cc.cf; }
#endif

// t[0 .. NW] += a[0 .. NW-1] * b, the sum known to fit in NW + 1 words: one
// chain of low halves, one of high halves (2 NW multiply issues)
template <int NW>
OZL_HD void mac_row(uint32_t* t, const uint32_t* a, uint32_t b, Carry& cc) {
  static_assert(NW >= 2, "a row needs two words");
  t[0] = mad_lo_cc(a[0], b, t[0], cc);
#pragma unroll
  for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(a[j], b, t[j], cc);
  t[NW] = addc(t[NW], 0, cc);
  t[1] = mad_hi_cc(a[0], b, t[1], cc);
#pragma unroll
  for (int j = 1; j < NW - 1; ++j) t[j + 1] = madc_hi_cc(a[j], b, t[j + 1], cc);
  t[NW] = madc_hi(a[NW - 1], b, t[NW], cc);
}

// F1 with the Montgomery product and square on carry chains, the square
// and the product-sum reduced once (K1's exponentiation, K2, K3-K7, K8's
// transform and K9; K1's product and K8's stage keep F1).
// Needs p < 2^(32 NW - 1) - 2^(32 NW - 33) (top word below 0x7FFFFFFF:
// BN254 Fr and Fq, BLS12-381 Fr), so that a CIOS step fits NW + 1 words.
template <int NW>
struct F1c : F1<NW> {
  using T = Fp<NW>;

  // a + b, one conditional subtraction (a + b < 2p < 2^(32 NW): no carry out)
  OZL_HD T add(const T& a, const T& b) const {
    uint32_t s[NW];
    Carry cc;
    s[0] = add_cc(a.w[0], b.w[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) s[j] = addc_cc(a.w[j], b.w[j], cc);
    return csub(s);
  }

  OZL_HD T dbl(const T& a) const { return add(a, a); }

  // a - b, plus p where it borrowed
  OZL_HD T sub(const T& a, const T& b) const {
    T d, e;
    Carry cc;
    d.w[0] = sub_cc(a.w[0], b.w[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(a.w[j], b.w[j], cc);
    const uint32_t borrow = subc(0, 0, cc);
    e.w[0] = add_cc(d.w[0], this->f.p[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) e.w[j] = addc_cc(d.w[j], this->f.p[j], cc);
#pragma unroll
    for (int j = 0; j < NW; ++j) d.w[j] = borrow ? e.w[j] : d.w[j];
    return d;
  }

  // t (NW words, t < 2p) -> [0, p)
  OZL_HD T csub(const uint32_t* t) const {
    T d;
    Carry cc;
    d.w[0] = sub_cc(t[0], this->f.p[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(t[j], this->f.p[j], cc);
    const uint32_t borrow = subc(0, 0, cc);
    T r;
#pragma unroll
    for (int j = 0; j < NW; ++j) r.w[j] = borrow ? t[j] : d.w[j];
    return r;
  }

  // CIOS a b R^-1 mod p: per word of b, t += a b_i, then t += m p with
  // m = t_0 n0, which clears t_0, and a shift; t < 2p throughout
  OZL_HD T mul(const T& a, const T& b) const {
    uint32_t t[NW + 1];
#pragma unroll
    for (int j = 0; j <= NW; ++j) t[j] = 0;
    Carry cc;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      mac_row<NW>(t, a.w, b.w[i], cc);
      mac_row<NW>(t, this->f.p, t[0] * this->f.n0, cc);
#pragma unroll
      for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
      t[NW] = 0;
    }
    return csub(t);
  }

  // x (2 NW words, x < W p^2 with W p < 2^(32 NW)) -> x R^-1 mod p, fully
  // reduced: Montgomery-reduce the low half (t <= p), add the high half
  // (t + hi < p + W p^2 / R + 1, which may carry out of NW words), then
  // subtract p at most twice
  OZL_HD T redc(const uint32_t* x) const {
    uint32_t t[NW + 1];
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = x[j];
    t[NW] = 0;
    Carry cc;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      mac_row<NW>(t, this->f.p, t[0] * this->f.n0, cc);
#pragma unroll
      for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
      t[NW] = 0;
    }
    t[0] = add_cc(t[0], x[NW], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) t[j] = addc_cc(t[j], x[NW + j], cc);
    const uint32_t top = addc(0, 0, cc);
    // first subtraction: taken when the sum carried or is >= p
    T d;
    d.w[0] = sub_cc(t[0], this->f.p[0], cc);
#pragma unroll
    for (int j = 1; j < NW; ++j) d.w[j] = subc_cc(t[j], this->f.p[j], cc);
    const bool take = top | !subc(0, 0, cc);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = take ? d.w[j] : t[j];
    return csub(t);
  }

  // a^2: the cross products a_i a_j (i < j) once, doubled, plus the
  // squares a_i^2 on the diagonal (NW (NW + 1) / 2 word products), then redc
  OZL_HD T sqr(const T& a) const {
    uint32_t x[2 * NW];
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) x[j] = 0;
    Carry cc;
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) {
      // row i: a_i a_j at words i + j (j > i); word i + NW is still 0
      x[2 * i + 1] = mad_lo_cc(a.w[i], a.w[i + 1], x[2 * i + 1], cc);
#pragma unroll
      for (int j = i + 2; j < NW; ++j) x[i + j] = madc_lo_cc(a.w[i], a.w[j], x[i + j], cc);
      x[i + NW] = addc(x[i + NW], 0, cc);
      if (i + 1 == NW - 1) {
        x[i + NW] = mad_hi(a.w[i], a.w[i + 1], x[i + NW], cc);
      } else {
        x[2 * i + 2] = mad_hi_cc(a.w[i], a.w[i + 1], x[2 * i + 2], cc);
#pragma unroll
        for (int j = i + 2; j < NW - 1; ++j) x[i + j + 1] = madc_hi_cc(a.w[i], a.w[j], x[i + j + 1], cc);
        x[i + NW] = madc_hi(a.w[i], a.w[NW - 1], x[i + NW], cc);
      }
    }
    x[0] = add_cc(x[0], x[0], cc);
#pragma unroll
    for (int j = 1; j < 2 * NW; ++j) x[j] = addc_cc(x[j], x[j], cc);
    x[0] = mad_lo_cc(a.w[0], a.w[0], x[0], cc);
    x[1] = madc_hi_cc(a.w[0], a.w[0], x[1], cc);
#pragma unroll
    for (int i = 1; i < NW - 1; ++i) {
      x[2 * i] = madc_lo_cc(a.w[i], a.w[i], x[2 * i], cc);
      x[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], x[2 * i + 1], cc);
    }
    x[2 * NW - 2] = madc_lo_cc(a.w[NW - 1], a.w[NW - 1], x[2 * NW - 2], cc);
    x[2 * NW - 1] = madc_hi(a.w[NW - 1], a.w[NW - 1], x[2 * NW - 1], cc);
    return redc(x);
  }

  // sum_k a_k b_k, unreduced, into acc (2 NW + 1 words, zeroed here): word
  // i of every a_k before word i + 1 of any, so a row's carry stops at
  // word i + NW + 1 (the partial sum stays below K p 2^(32 (i + 1)))
  template <int K>
  OZL_HD static void mac_sum(uint32_t* acc, const T* a, const T* b) {
#pragma unroll
    for (int j = 0; j <= 2 * NW; ++j) acc[j] = 0;
    Carry cc;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t* t = acc + i;
        const uint32_t ai = a[k].w[i];
        t[0] = mad_lo_cc(ai, b[k].w[0], t[0], cc);
#pragma unroll
        for (int j = 1; j < NW; ++j) t[j] = madc_lo_cc(ai, b[k].w[j], t[j], cc);
        t[NW] = addc_cc(t[NW], 0, cc);
        t[NW + 1] = addc(t[NW + 1], 0, cc);
        t[1] = mad_hi_cc(ai, b[k].w[0], t[1], cc);
#pragma unroll
        for (int j = 1; j < NW; ++j) t[j + 1] = madc_hi_cc(ai, b[k].w[j], t[j + 1], cc);
        t[NW + 1] = addc(t[NW + 1], 0, cc);
      }
    }
  }
};

// F1c's bound on p's top word (below it, the carry chains hold), and the
// choice every kernel that has both fields makes: F1c where p's top word
// is below the bound, F1 otherwise (and for one-word fields, which F1c
// does not take)
constexpr uint32_t kF1cTop = 0x7FFFFFFFu;

template <int NW>
inline bool carry_chains(const uint32_t* p) {
  return NW >= 2 && p[NW - 1] < kF1cTop;
}

// a^e (Montgomery form, over F1 or F1c) for e given as little-endian 32-bit
// words of bit length `bits` (0 for e = 0), MSB first: one x a for the top
// bit (as the plain chain's first square and product of one give), then a
// square per bit and a product by a where the bit is set; the Montgomery
// one for e = 0. K1's exponentiation (ntt_kernel.cu).
template <class F, int NW>
OZL_HD Fp<NW> pow_bits(const F& Fd, const Fp<NW>& a, const uint32_t* e, int bits, const Fp<NW>& one) {
  Fp<NW> acc = bits > 0 ? Fd.mul(one, a) : one;
#pragma unroll 1
  for (int k = bits - 2; k >= 0; --k) {
    acc = Fd.sqr(acc);
    if ((e[k >> 5] >> (k & 31)) & 1u) acc = Fd.mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// quadratic extension c0 + c1 u, u^2 = beta = -k (k = 1 for BN254 and
// BLS12-381, 5 for BLS12-377), over the base field Base (F1 or F1c)
// ---------------------------------------------------------------------------

template <int NW, class Base = F1<NW>>
struct F2 {
  using T = Fp2<NW>;
  using B = Fp<NW>;
  Base b;
  int k;

  OZL_HD B nr(const B& x) const {  // k * x
    B r = x;
    for (int i = 1; i < k; ++i) r = b.add(r, x);
    return r;
  }

  OZL_HD T add(const T& x, const T& y) const { return {b.add(x.c0, y.c0), b.add(x.c1, y.c1)}; }
  OZL_HD T sub(const T& x, const T& y) const { return {b.sub(x.c0, y.c0), b.sub(x.c1, y.c1)}; }
  OZL_HD T dbl(const T& x) const { return {b.dbl(x.c0), b.dbl(x.c1)}; }

  // Karatsuba: (x0 + x1 u)(y0 + y1 u) = (m0 - k m1) + (m2 - m0 - m1) u
  OZL_HD T mul(const T& x, const T& y) const {
    B m0 = b.mul(x.c0, y.c0);
    B m1 = b.mul(x.c1, y.c1);
    B m2 = b.mul(b.add(x.c0, x.c1), b.add(y.c0, y.c1));
    return {b.sub(m0, nr(m1)), b.sub(m2, b.add(m0, m1))};
  }

  // (x0 + x1 u)^2 = ((x0 + x1)(x0 - k x1) + (k - 1) x0 x1) + 2 x0 x1 u
  OZL_HD T sqr(const T& x) const {
    B t = b.mul(b.add(x.c0, x.c1), b.sub(x.c0, nr(x.c1)));
    B m = b.mul(x.c0, x.c1);
    B c0 = t;
    for (int i = 1; i < k; ++i) c0 = b.add(c0, m);
    return {c0, b.dbl(m)};
  }

  OZL_HD static bool is_zero(const T& x) { return F1<NW>::is_zero(x.c0) && F1<NW>::is_zero(x.c1); }
  OZL_HD static T select(bool m, const T& x, const T& y) { return m ? x : y; }
  OZL_HD static T raw_one() { return {F1<NW>::raw_one(), F1<NW>::zero()}; }
  OZL_HD static T zero() { return {F1<NW>::zero(), F1<NW>::zero()}; }
};

// coordinate access: ext 1 values are (n, N); ext 2 values are (n, 2, N),
// component c of element i at limb stride 2N, offset c N
template <int NW>
OZL_HD Fp<NW> load_coord(const int32_t* base, int64_t N, int64_t i, Fp<NW>*) {
  return load_fp<NW>(base, N, i);
}
template <int NW>
OZL_HD Fp2<NW> load_coord(const int32_t* base, int64_t N, int64_t i, Fp2<NW>*) {
  return {load_fp<NW>(base, 2 * N, i), load_fp<NW>(base + N, 2 * N, i)};
}
template <int NW>
OZL_HD void store_coord(int32_t* base, int64_t N, int64_t i, const Fp<NW>& v) {
  store_fp<NW>(base, N, i, v);
}
template <int NW>
OZL_HD void store_coord(int32_t* base, int64_t N, int64_t i, const Fp2<NW>& v) {
  store_fp<NW>(base, 2 * N, i, v.c0);
  store_fp<NW>(base + N, 2 * N, i, v.c1);
}

// host constants -> FieldParams (p given as NW little-endian words)
template <int NW>
inline FieldParams<NW> make_params(const uint32_t* p, uint32_t n0) {
  FieldParams<NW> f;
  for (int i = 0; i < NW; ++i) f.p[i] = p[i];
  f.n0 = n0;
  return f;
}
