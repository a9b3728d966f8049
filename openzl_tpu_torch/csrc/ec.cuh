// Jacobian group law shared by the EC kernels (ec_kernel.cu): the formulas
// and special-case masks of openzl_tpu/ops/ec_kernel.py `_k_ec_double` and
// `_add_core` (:193-272), generic over the coordinate field (F1 or F2 from
// field.cuh). Compiles as host C++ too.
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

