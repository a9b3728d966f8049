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
// quadratic extension c0 + c1 u, u^2 = beta = -k (k = 1 for BN254 and
// BLS12-381, 5 for BLS12-377)
// ---------------------------------------------------------------------------

template <int NW>
struct F2 {
  using T = Fp2<NW>;
  using B = Fp<NW>;
  F1<NW> b;
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
