// Jacobian group law shared by the EC kernels (ec_kernel.cu, fold_kernel.cu):
// the formulas and special-case masks of openzl_tpu/ops/ec_kernel.py
// `_k_ec_double` and `_add_core` (:193-272), generic over the coordinate
// field (F1, F1c or F2 from field.cuh), the lifted monoid of the MSM's
// chunk scan, and the MSM's sorted-chunk fold. Compiles as host C++ too.
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

// The lifted monoid of the MSM's segmented scan of chunk totals (the
// reference's `lifted`, openzl_tpu/ops/msm.py:352-360): (a, af) . (b, bf) =
// (bf ? b : a + b, af | bf), with K3's full add. In place on (a, af).
template <class F>
OZL_HD void lifted_add(const EcParams<F>& E, typename F::T& ax, typename F::T& ay,
                       typename F::T& az, bool& af, const typename F::T& bx,
                       const typename F::T& by, const typename F::T& bz, bool bf) {
  if (bf) {
    ax = bx;
    ay = by;
    az = bz;
  } else {
    typename F::T sx, sy, sz;
    ec_add<F, false>(E, ax, ay, az, bx, by, bz, sx, sy, sz);
    ax = sx;
    ay = sy;
    az = sz;
  }
  af = af || bf;
}

// A point's X, Y and Z as 32-bit words (3 CW of them) in a thread's slot of
// shared memory, copied from element i of limb-planar coordinates (N
// elements). The group law then reads that operand where it uses it
// instead of holding it in registers (K3 over Fq2 holds the other operand
// and every temporary in its 255 registers that way, without a spill).
template <class T>
OZL_HD const T* stage_point(uint32_t* slot, const int32_t* x, const int32_t* y, const int32_t* z,
                            int64_t N, int64_t i) {
  T* v = reinterpret_cast<T*>(slot);
  T* tag = nullptr;
  v[0] = load_coord(x, N, i, tag);
  v[1] = load_coord(y, N, i, tag);
  v[2] = load_coord(z, N, i, tag);
  return v;
}

// ---------------------------------------------------------------------------
// K3's lifted scan variant (ec_kernel.cu), written for one block of THREADS
// threads (thread t of block `block`), so that it also runs as host C++,
// where `sync` is a barrier of the block's threads
// ---------------------------------------------------------------------------

// a read of memory that no thread writes while the kernel runs (__ldg on
// the card: the compiler may move it ahead of stores to shared memory)
template <class V>
OZL_HD V load_ro(const V* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// A coordinate's 32-bit word wi sits in two limb rows of the limb-planar
// (n_limbs, n) or (n_limbs, 2, n) tensor: component wi / NW (c0, c1), limbs
// 2 (wi % NW) and 2 (wi % NW) + 1; the high limb's row is ext rows on.
template <int NW>
OZL_HD int word_row(int wi, int ext) {
  return 2 * (wi % NW) * ext + wi / NW;
}

// Phase 1's tile in shared memory: slot s (thread s / K, element s % K of
// its chunk) holds one element's X, Y and Z words (SW words); a thread's
// slots span TW words, an odd count, so the threads' slots at one column
// fall in distinct banks; then one flag byte a slot.
template <class T, int THREADS, int K>
struct ScanTile {
  static constexpr int SW = 3 * (int)(sizeof(T) / sizeof(uint32_t)) + 1;
  static constexpr int TW = (K * SW) | 1;
  static constexpr size_t bytes = (size_t)THREADS * (TW * sizeof(uint32_t) + K);
};

// Phase 1 over elements (x, y, z, f) (n), in chunks of K: thread c of the
// scan folds elements c K .. c K + K - 1 into (ax, ay, az, af), from the
// identity with a false flag, and writes the exclusive prefix of each
// element within its chunk to (px, py, pz, pf) and the chunk total to (tx,
// ty, tz, tf) (m = ceil(n / K)). The block's tile is one run of
// consecutive elements (slot s holds element e0 + s), which it loads and
// stores through shared memory, consecutive threads on consecutive
// elements.
template <class F, int NW, int THREADS, int K, class Sync>
OZL_HD void scan_fold_block(const EcParams<F>& E, int t, int64_t block, Sync& sync,
                            uint32_t* smem, const int32_t* x, const int32_t* y, const int32_t* z,
                            const uint8_t* f, int32_t* px, int32_t* py, int32_t* pz, uint8_t* pf,
                            int32_t* tx, int32_t* ty, int32_t* tz, uint8_t* tf, int64_t n,
                            const typename F::T& one) {
  using T = typename F::T;
  using Tile = ScanTile<T, THREADS, K>;
  constexpr int CW = (int)(sizeof(T) / sizeof(uint32_t));
  constexpr int EXT = CW / NW;
  constexpr int slots = THREADS * K;
  uint8_t* sflag = reinterpret_cast<uint8_t*>(smem + THREADS * Tile::TW);
  auto slot = [&](int s) { return smem + (s / K) * Tile::TW + (s % K) * Tile::SW; };
  const int64_t m = (n + K - 1) / K;
  const int64_t e0 = block * slots;
  const int32_t* src[3] = {x, y, z};
  int32_t* dst[3] = {px, py, pz};
  const uint32_t* onew = reinterpret_cast<const uint32_t*>(&one);
  // read-only loads, several in flight at once: few warps share an SM here,
  // so nothing else hides their latency
#pragma unroll 4
  for (int idx = t; idx < 3 * CW * slots; idx += THREADS) {
    const int s = idx % slots, w = idx / slots;
    const int64_t e = e0 + s;
    if (e < n) {
      const int64_t lo = word_row<NW>(w % CW, EXT) * n + e;
      const int32_t* b = src[w / CW];
      slot(s)[w] = (uint32_t)load_ro(b + lo) | ((uint32_t)load_ro(b + lo + EXT * n) << 16);
    }
  }
  for (int s = t; s < slots; s += THREADS)
    if (e0 + s < n) sflag[s] = load_ro(f + e0 + s);
  sync();
  // fold; the inclusive prefix of each element replaces it in its slot
  T ax = one, ay = one, az = F::zero();
  bool af = false;
  for (int k = 0; k < K; ++k) {
    const int s = t * K + k;
    if (e0 + s >= n) break;
    T* v = reinterpret_cast<T*>(slot(s));
    lifted_add<F>(E, ax, ay, az, af, v[0], v[1], v[2], sflag[s] != 0);
    v[0] = ax;
    v[1] = ay;
    v[2] = az;
    sflag[s] = af;
  }
  sync();
  // the inclusive prefix of element e is the exclusive prefix of e + 1 in
  // the same chunk; the chunk's first element gets the identity
  for (int idx = t; idx < 3 * CW * slots; idx += THREADS) {
    const int s = idx % slots, w = idx / slots;
    const int64_t e = e0 + s;
    const int64_t lo = word_row<NW>(w % CW, EXT) * n + e;
    int32_t* b = dst[w / CW];
    if (s % K + 1 < K && e + 1 < n) {
      const uint32_t v = slot(s)[w];
      b[lo + 1] = (int32_t)(v & 0xFFFFu);
      b[lo + 1 + EXT * n] = (int32_t)(v >> 16);
    }
    if (s % K == 0 && e < n) {
      const uint32_t v = w < 2 * CW ? onew[w % CW] : 0u;
      b[lo] = (int32_t)(v & 0xFFFFu);
      b[lo + EXT * n] = (int32_t)(v >> 16);
    }
  }
  for (int s = t; s < slots; s += THREADS) {
    const int64_t e = e0 + s;
    if (s % K + 1 < K && e + 1 < n) pf[e + 1] = sflag[s];
    if (s % K == 0 && e < n) pf[e] = 0;
  }
  const int64_t c = block * THREADS + t;
  if (c < m) {
    store_coord(tx, m, c, ax);
    store_coord(ty, m, c, ay);
    store_coord(tz, m, c, az);
    tf[c] = af;
  }
}

// Phase 3 at element i, in chunks of K: its exclusive prefix within its
// chunk (px, py, pz, pf) becomes lifted_add(its chunk's offset (ox, oy, oz), prefix), in place;
// `slot` is the thread's scratch in shared memory (stage_point)
template <class F, int K>
OZL_HD void scan_offset_element(const EcParams<F>& E, int64_t i, uint32_t* slot,
                                const int32_t* ox, const int32_t* oy, const int32_t* oz,
                                int32_t* px, int32_t* py, int32_t* pz, const uint8_t* pf,
                                int64_t n) {
  using T = typename F::T;
  const int64_t m = (n + K - 1) / K, c = i / K;
  T* tag = nullptr;
  T X = load_coord(ox, m, c, tag), Y = load_coord(oy, m, c, tag), Z = load_coord(oz, m, c, tag);
  if (i % K) {  // the first element's prefix is the identity: offset + identity = offset
    const T* q = stage_point<T>(slot, px, py, pz, n, i);
    bool unused = false;
    lifted_add<F>(E, X, Y, Z, unused, q[0], q[1], q[2], pf[i] != 0);
  }
  store_coord(px, n, i, X);
  store_coord(py, n, i, Y);
  store_coord(pz, n, i, Z);
}

// A narrow level's Hillis-Steele step at element i, from (x, y, z, f) into
// (ox, oy, oz, of) (n, distinct buffers): element i becomes
// lifted_add(element i - d, element i) where i >= d, else stays. The last
// step (2 d >= n) writes each inclusive prefix one element on, as the
// exclusive prefix of the next, and the identity at element 0. `slot` is
// the thread's scratch in shared memory (stage_point).
template <class F>
OZL_HD void scan_step_element(const EcParams<F>& E, int64_t i, uint32_t* slot, const int32_t* x,
                              const int32_t* y, const int32_t* z, const uint8_t* f, int32_t* ox,
                              int32_t* oy, int32_t* oz, uint8_t* of, int64_t n, int64_t d,
                              const typename F::T& one) {
  using T = typename F::T;
  T* tag = nullptr;
  T X, Y, Z;
  bool fl = f[i] != 0;
  if (i >= d) {
    X = load_coord(x, n, i - d, tag);
    Y = load_coord(y, n, i - d, tag);
    Z = load_coord(z, n, i - d, tag);
    bool ef = f[i - d] != 0;
    const T* q = stage_point<T>(slot, x, y, z, n, i);
    lifted_add<F>(E, X, Y, Z, ef, q[0], q[1], q[2], fl);
    fl = ef;
  } else {
    X = load_coord(x, n, i, tag);
    Y = load_coord(y, n, i, tag);
    Z = load_coord(z, n, i, tag);
  }
  int64_t o = i;
  if (2 * d >= n) {
    if (i == 0) {
      store_coord(ox, n, 0, one);
      store_coord(oy, n, 0, one);
      store_coord(oz, n, 0, F::zero());
      of[0] = 0;
    }
    if (i + 1 == n) return;
    o = i + 1;
  }
  store_coord(ox, n, o, X);
  store_coord(oy, n, o, Y);
  store_coord(oz, n, o, Z);
  of[o] = fl;
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
// base field Base (F1c for K3, K4 and K9)
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
