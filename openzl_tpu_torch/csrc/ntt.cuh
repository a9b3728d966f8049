// K8's whole-transform block code (ntt_kernel.cu `ntt_transform_kernel`),
// written for one block of a cluster of C blocks with a context object, so
// that it also compiles and runs as host C++ (field.cuh's OZL_HD): the host
// runs every block's threads as threads that meet at one barrier.
//
// The context gives: t and T (the thread and the block's thread count), r
// and C (the block's rank in its cluster and the cluster's size), slots(k)
// (block k's data slots: its own shared memory for k = r, distributed
// shared memory otherwise), sync_block() and sync_cluster().
#pragma once

#include "field.cuh"

// the low `bits` bits of v in reverse order
OZL_HD uint32_t bit_reverse(uint32_t v, int bits) {
#ifdef __CUDA_ARCH__
  return bits ? __brev(v) >> (32 - bits) : 0;
#else
  uint32_t r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1u) << (bits - 1 - i);
  return r;
#endif
}

OZL_HD int log2_int(uint32_t v) {
  int k = 0;
  while ((1u << (k + 1)) <= v) ++k;
  return k;
}

// Shared-memory position of entry i of a table of 2^bits entries: its low
// five bits XORed with five higher bits (bits - 5 up, or 5 up in a table
// of fewer than 2^10), so that a warp's accesses to 32 consecutive entries
// (a stage), to 32 entries bit-reversed (the store and the twiddle table's
// fill) and to one entry (a broadcast) each fall in distinct banks
OZL_HD int swizzle_shift(int bits) { return bits >= 10 ? bits - 5 : 5; }
OZL_HD int swizzle(int i, int sh) { return i ^ ((i >> sh) & 31); }

// The N-point transform (N = 2^L) of column b of x (n_limbs, N, B), out of
// place into out, natural order in and out, times n_inv (16-bit limbs, or
// null) for the inverse, on a cluster of C = 2^c blocks (C = 1: one
// block). Block r holds slots [r S, (r + 1) S) (S = N / C) as 32-bit
// words, word w of slot i at data[w S + swizzle(i)], and every block
// stages the whole root table in bit-reversed order, twiddle g at tw[w N/2
// + swizzle(g)] = W[brv_(L-1)(g)], read from the (n_limbs, N/2) table
// with neighbouring threads on neighbouring entries. Stage s (len = N /
// 2^(s+1)) is a Cooley-Tukey butterfly on each pair (u, u + len), u = g 2
// len + j for butterfly q = g len + j: u + w t, u - w t, where group g's
// twiddle w^(brv_s(g) len) is the table's entry g (1 at stage 0: no
// product). Block r takes butterflies [r S / 2, (r + 1) S / 2): in the
// first c stages (len >= S) their slots lie in other blocks of the
// cluster, later every slot is its own. After the last stage slot m = r S
// + i holds the evaluation at w^(brv_L(m)), brv_L(m) = brv_(L-c)(i) C +
// brv_c(r): the store takes k = brv_(L-c)(i) in order, so a warp writes
// neighbouring outputs (C apart).
template <class F, int NW, class Ctx>
OZL_HD void ntt_transform_block(const F& Fd, Ctx& ctx, uint32_t* data, uint32_t* tw, const int32_t* x,
                                const int32_t* table, const int32_t* n_inv, int32_t* out, int L, int64_t B,
                                int64_t b) {
  const int N = 1 << L, C = ctx.C, S = N / C, r = ctx.r, t = ctx.t, T = ctx.T;
  const int c = log2_int((uint32_t)C);
  const int half = N / 2, sd = swizzle_shift(L - c), st = swizzle_shift(L - 1);
  const int64_t ls = (int64_t)N * B;  // limb stride of x and out
#pragma unroll 4
  for (int j = t; j < half; j += T) {
    const Fp<NW> w = load_fp<NW>(table, half, j);
    const int e = swizzle((int)bit_reverse((uint32_t)j, L - 1), st);
#pragma unroll
    for (int k = 0; k < NW; ++k) tw[k * half + e] = w.w[k];
  }
#pragma unroll 4
  for (int i = t; i < S; i += T) {
    const Fp<NW> v = load_fp<NW>(x, ls, (int64_t)(r * S + i) * B + b);
    const int e = swizzle(i, sd);
#pragma unroll
    for (int k = 0; k < NW; ++k) data[k * S + e] = v.w[k];
  }
  if (C > 1)
    ctx.sync_cluster();
  else
    ctx.sync_block();
#pragma unroll 1
  for (int s = 0; s < L; ++s) {
    const int len = N >> (s + 1);
    const bool cross = len >= S;
#pragma unroll 1
    for (int q = r * (S / 2) + t; q < (r + 1) * (S / 2); q += T) {
      const uint32_t g = (uint32_t)q >> (L - s - 1);
      const int u = (int)g * 2 * len + (q & (len - 1)), v = u + len;
      uint32_t* du = cross ? ctx.slots(u >> (L - c)) : data;
      uint32_t* dv = cross ? ctx.slots(v >> (L - c)) : data;
      const int iu = swizzle(u & (S - 1), sd), iv = swizzle(v & (S - 1), sd);
      Fp<NW> a, y;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        a.w[k] = du[k * S + iu];
        y.w[k] = dv[k * S + iv];
      }
      if (s > 0) {
        Fp<NW> w;
        const int e = swizzle((int)g, st);
#pragma unroll
        for (int k = 0; k < NW; ++k) w.w[k] = tw[k * half + e];
        y = Fd.mul(y, w);
      }
      const Fp<NW> lo = Fd.add(a, y), hi = Fd.sub(a, y);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        du[k * S + iu] = lo.w[k];
        dv[k * S + iv] = hi.w[k];
      }
    }
    if (cross)
      ctx.sync_cluster();
    else
      ctx.sync_block();
  }
  Fp<NW> scale = F1<NW>::zero();
  if (n_inv) scale = load_fp<NW>(n_inv, 1, 0);
  const int64_t n0 = bit_reverse((uint32_t)r, c);
  for (int k = t; k < S; k += T) {
    const int e = swizzle((int)bit_reverse((uint32_t)k, L - c), sd);
    Fp<NW> v;
#pragma unroll
    for (int w = 0; w < NW; ++w) v.w[w] = data[w * S + e];
    if (n_inv) v = Fd.mul(v, scale);
    store_fp<NW>(out, ls, ((int64_t)k * C + n0) * B + b, v);
  }
}
