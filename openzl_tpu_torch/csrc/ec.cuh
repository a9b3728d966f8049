// Jacobian group law shared by the EC kernels (ec_kernel.cu, fold_kernel.cu):
// the formulas and special-case masks of openzl_tpu/ops/ec_kernel.py
// `_k_ec_double` and `_add_core` (:193-272), generic over the coordinate
// field (F1 or F2 from field.cuh), and the MSM's sorted-chunk fold.
// Compiles as host C++ too.
#pragma once
#include "field.cuh"

template <class F>
struct EcParams {
  F field;
  bool has_a;
  typename F::T a;  // Montgomery-form curve coefficient
};

template <class F>
OZL_HD void ec_dbl(const EcParams<F>& E, const typename F::T& X, const typename F::T& Y,
                   const typename F::T& Z, typename F::T& X3, typename F::T& Y3,
                   typename F::T& Z3) {
  using T = typename F::T;
  const F& Fd = E.field;
  T A = Fd.sqr(X);
  T B = Fd.sqr(Y);
  T C = Fd.sqr(B);
  T t = Fd.sub(Fd.sqr(Fd.add(X, B)), Fd.add(A, C));
  T D = Fd.dbl(t);
  T Em = Fd.add(Fd.dbl(A), A);
  if (E.has_a) Em = Fd.add(Em, Fd.mul(E.a, Fd.sqr(Fd.sqr(Z))));
  X3 = Fd.sub(Fd.sqr(Em), Fd.dbl(D));
  T C8 = Fd.dbl(Fd.dbl(Fd.dbl(C)));
  Y3 = Fd.sub(Fd.mul(Em, Fd.sub(D, X3)), C8);
  Z3 = Fd.dbl(Fd.mul(Y, Z));
}

template <class F, bool MIXED>
OZL_HD void ec_add(const EcParams<F>& E, const typename F::T& X1, const typename F::T& Y1,
                   const typename F::T& Z1, const typename F::T& X2, const typename F::T& Y2,
                   const typename F::T& Z2, typename F::T& X3, typename F::T& Y3,
                   typename F::T& Z3) {
  using T = typename F::T;
  const F& Fd = E.field;
  T Z1Z1 = Fd.sqr(Z1);
  T U1, U2, S1, S2, Z2Z2;
  if (MIXED) {
    U1 = X1;
    S1 = Y1;
    U2 = Fd.mul(X2, Z1Z1);
    S2 = Fd.mul(Y2, Fd.mul(Z1, Z1Z1));
  } else {
    Z2Z2 = Fd.sqr(Z2);
    U1 = Fd.mul(X1, Z2Z2);
    U2 = Fd.mul(X2, Z1Z1);
    S1 = Fd.mul(Y1, Fd.mul(Z2, Z2Z2));
    S2 = Fd.mul(Y2, Fd.mul(Z1, Z1Z1));
  }
  T H = Fd.sub(U2, U1);
  T HH, I;
  if (MIXED) {
    HH = Fd.sqr(H);
    I = Fd.dbl(Fd.dbl(HH));
  } else {
    I = Fd.sqr(Fd.dbl(H));
  }
  T J = Fd.mul(H, I);
  T r = Fd.dbl(Fd.sub(S2, S1));
  T V = Fd.mul(U1, I);
  T x3 = Fd.sub(Fd.sqr(r), Fd.add(J, Fd.dbl(V)));
  T y3 = Fd.sub(Fd.mul(r, Fd.sub(V, x3)), Fd.dbl(Fd.mul(S1, J)));
  T z3;
  if (MIXED) {
    z3 = Fd.sub(Fd.sub(Fd.sqr(Fd.add(Z1, H)), Z1Z1), HH);
  } else {
    z3 = Fd.mul(Fd.sub(Fd.sqr(Fd.add(Z1, Z2)), Fd.add(Z1Z1, Z2Z2)), H);
  }
  const bool p_inf = F::is_zero(Z1);
  const bool q_inf = F::is_zero(Z2);
  const bool h_zero = F::is_zero(H);
  const bool r_zero = F::is_zero(r);
  const bool both = !p_inf && !q_inf;
  const bool same = both && h_zero && r_zero;
  const bool opposite = both && h_zero && !r_zero;
  if (same) ec_dbl<F>(E, X1, Y1, Z1, x3, y3, z3);
  if (opposite) {
    x3 = F::raw_one();
    y3 = F::raw_one();
    z3 = F::zero();
  }
  if (p_inf) {
    x3 = X2;
    y3 = Y2;
    z3 = Z2;
  }
  if (q_inf) {
    x3 = X1;
    y3 = Y1;
    z3 = Z1;
  }
  X3 = x3;
  Y3 = y3;
  Z3 = z3;
}


// One chunk of the MSM bucket fold (K9, fold_kernel.cu): entries e0 ..
// e0 + r - 1 of the sorted keys (n entries in all) with point indices pidx
// into the normalized points. acc starts at the identity; at each entry acc
// = start ? q : madd(acc, q); at a segment tail the prefix goes to bucket
// slot `key` with its bflag (the segment started in this chunk) and the
// chunk index c. Returns whether the chunk holds a start; the chunk total is
// left in (ax, ay, az).
//
// The points come through `src`, which stages them ahead: src.fetch(j, i)
// starts loading point i for entry j, src.commit() closes the entries
// fetched so far, src.wait() waits for all but the newest closed batch,
// and src.x(j) / src.y(j) read entry j's staged X and Y. Entry j + 1's
// point, and its index and the next key, are in flight while entry j's
// madd runs.
template <class F, class Src>
OZL_HD bool fold_chunk(const EcParams<F>& E, const int64_t* keys, const int64_t* pidx, int64_t n,
                       int64_t c, int r, Src& src, const typename F::T& one, int32_t* bx,
                       int32_t* by, int32_t* bz, uint8_t* bflag, int64_t* bchunk, int64_t width,
                       typename F::T& ax, typename F::T& ay, typename F::T& az) {
  using T = typename F::T;
  ax = F::raw_one();
  ay = F::raw_one();
  az = F::zero();
  bool started = false;  // a segment started in this chunk, at or before j
  const int64_t e0 = c * r;
  int64_t prev = e0 > 0 ? keys[e0 - 1] : -1;
  int64_t key = keys[e0];
  src.fetch(0, pidx[e0]);
  src.commit();
  int64_t inext = r > 1 ? pidx[e0 + 1] : 0;
  for (int j = 0; j < r; ++j) {
    const int64_t e = e0 + j;
    if (j + 1 < r) src.fetch(j + 1, inext);
    src.commit();
    const int64_t next = e + 1 < n ? keys[e + 1] : -1;
    inext = j + 2 < r ? pidx[e + 2] : 0;
    src.wait();
    const T& qx = src.x(j);
    const T& qy = src.y(j);
    if (key != prev) {
      ax = qx;
      ay = qy;
      az = one;
      started = true;
    } else {
      T sx, sy, sz;
      ec_add<F, true>(E, ax, ay, az, qx, qy, one, sx, sy, sz);
      ax = sx;
      ay = sy;
      az = sz;
    }
    if (key != next) {  // segment tail: its prefix is the bucket's chunk-local sum
      store_coord(bx, width, key, ax);
      store_coord(by, width, key, ay);
      store_coord(bz, width, key, az);
      bflag[key] = started;
      bchunk[key] = c;
    }
    prev = key;
    key = next;
  }
  return started;
}

// The fold's point source on the host: point i is X then Y as 32-bit words
// at pts[i * PW] (point-major, PW = 2 * sizeof(T) / 4), read in place.
template <class T>
struct DirectPoints {
  static constexpr int PW = 2 * (int)(sizeof(T) / sizeof(uint32_t));
  const uint32_t* pts;
  const uint32_t* at[2] = {nullptr, nullptr};
  OZL_HD void fetch(int j, int64_t i) { at[j & 1] = pts + i * PW; }
  OZL_HD void commit() {}
  OZL_HD void wait() {}
  OZL_HD const T& x(int j) const { return *reinterpret_cast<const T*>(at[j & 1]); }
  OZL_HD const T& y(int j) const { return *reinterpret_cast<const T*>(at[j & 1] + PW / 2); }
};

// host constants -> EcParams over Fq (1) or Fq2 (2, u^2 = beta), on the
// base field F1 (K3, K4) or F1c (K9)
template <int NW, class Base = F1<NW>>
inline EcParams<Base> params1(const uint32_t* p, uint32_t n0, int has_a, const uint32_t* a) {
  EcParams<Base> E;
  E.field.f = make_params<NW>(p, n0);
  E.has_a = has_a != 0;
  for (int i = 0; i < NW; ++i) E.a.w[i] = has_a ? a[i] : 0;
  return E;
}

template <int NW, class Base = F1<NW>>
inline EcParams<F2<NW, Base>> params2(const uint32_t* p, uint32_t n0, int beta, int has_a,
                                      const uint32_t* a) {
  EcParams<F2<NW, Base>> E;
  E.field.b.f = make_params<NW>(p, n0);
  E.field.k = -beta;
  E.has_a = has_a != 0;
  for (int i = 0; i < NW; ++i) {
    E.a.c0.w[i] = has_a ? a[i] : 0;
    E.a.c1.w[i] = has_a ? a[NW + i] : 0;
  }
  return E;
}
