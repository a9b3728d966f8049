// K8's whole-transform block code (ntt_kernel.cu `ntt_transform_kernel`),
// written for one block of a cluster of C blocks with a context object, and
// K2's four-step level (`fourstep_level_block`, for one block), so that
// both also compile and run as host C++ (field.cuh's OZL_HD): the host runs
// every block's threads as threads that meet at one barrier.
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

// ---------------------------------------------------------------------------
// K2: one level of the four-step transform (ntt_kernel.cu
// `fourstep_level_kernel`), written for one block with a context (t, T,
// sync_block()) so that it also runs as host C++
// ---------------------------------------------------------------------------

// element i of a word-packed table (NW consecutive 32-bit words an
// element): two or three 16-byte loads through the read-only cache on the
// card where NW is a multiple of 4
template <int NW>
OZL_HD Fp<NW> load_words(const uint32_t* table, int64_t i) {
  Fp<NW> r;
#ifdef __CUDA_ARCH__
  if constexpr (NW % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(table + i * NW);
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 v = __ldg(q + k);
      r.w[4 * k] = v.x;
      r.w[4 * k + 1] = v.y;
      r.w[4 * k + 2] = v.z;
      r.w[4 * k + 3] = v.w;
    }
    return r;
  }
#endif
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = table[i * NW + k];
  return r;
}

// One radix-2^a pass of an M-point DIF (stages s0 .. s0 + a - 1) on the
// 2^a rows base + t hmin (hmin = M >> (s0 + a)) of tile lane u, held in
// registers: group g = blk hmin + i0 has base = blk 2^a hmin + i0. Stage s
// pairs rows (r, r + h), h = M >> (s + 1), r mod 2h < h: r + h, and (r -
// (r + h)) w_M^((r mod h) 2^s), the twiddle read from stw (word-major, M/2
// entries); the butterflies whose twiddle is 1 (r mod h = 0) take no
// product. Word w of row r of lane u is at tile[(w M + r) TLP + u].
template <class F, int NW, int a>
OZL_HD void level_pass(const F& Fd, uint32_t* tile, const uint32_t* stw, int M, int TLP, int s0, int g, int u) {
  constexpr int R = 1 << a;
  const int hmin = M >> (s0 + a), half = M / 2;
  const int i0 = g & (hmin - 1);
  const int base = (g - i0) * R + i0;
  Fp<NW> v[R];
#pragma unroll
  for (int t = 0; t < R; ++t)
#pragma unroll
    for (int w = 0; w < NW; ++w) v[t].w[w] = tile[(w * M + base + t * hmin) * TLP + u];
#pragma unroll
  for (int k = 0; k < a; ++k) {
    const int hs = R >> (k + 1), s = s0 + k;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (t & hs) continue;
      const int i = i0 + (t & (hs - 1)) * hmin;
      const Fp<NW> lo = Fd.add(v[t], v[t + hs]);
      Fp<NW> d = Fd.sub(v[t], v[t + hs]);
      if (i != 0) {
        Fp<NW> w;
        const int e = i << s;
#pragma unroll
        for (int j = 0; j < NW; ++j) w.w[j] = stw[j * half + e];
        d = Fd.mul(d, w);
      }
      v[t] = lo;
      v[t + hs] = d;
    }
  }
#pragma unroll
  for (int t = 0; t < R; ++t)
#pragma unroll
    for (int w = 0; w < NW; ++w) tile[(w * M + base + t * hmin) * TLP + u] = v[t].w[w];
}

// Lanes of the level's tile `tile` of TL lanes: its first lane, its lane
// count, and its run, the lanes of it that share one column j2 (the store
// walks a column's M rows of `run` lanes, contiguous in the output). A
// column of c >= TL lanes is cut into ceil(c / TL) tiles; narrower columns
// go TL / c whole to a tile. Indices within a level are 32-bit: the
// wrapper keeps N B below 2^31.
struct LevelTile {
  int lane0, lanes, run;
};

OZL_HD LevelTile level_tile(int tile, int S, int c, int TL) {
  LevelTile r;
  if (c >= TL) {
    const int per = (c + TL - 1) / TL, j2 = tile / per, b0 = (tile - j2 * per) * TL;
    r.lane0 = j2 * c + b0;
    r.lanes = c - b0 < TL ? c - b0 : TL;
    r.run = r.lanes;
  } else {
    const int G = TL / c, j20 = tile * G;
    r.lane0 = j20 * c;
    r.lanes = (S - j20 < G ? S - j20 : G) * c;
    r.run = c;
  }
  return r;
}

OZL_HD int level_tiles(int S, int c, int TL) {
  return c >= TL ? S * ((c + TL - 1) / TL) : (S + TL / c - 1) / (TL / c);
}

// elements a thread of K2 loads or stores together (their global reads
// in flight at once): two
constexpr int kLevelBatch = 2;

// radix-2 stages a pass of K2's DIF runs in registers: two (radix 4). At
// 2^17 and 8 words, radix 2 ran within 10% of it either way, and radix 8
// needed 160 registers and ran 1.6-1.8x slower (PERF.md)
constexpr int kLevelPass = 2;

// One level of the four-step transform of N = 2^LN points (batch B, limb
// stride N B) for one tile: x, read as (M, S, c) (M = 2^LM rows, S = nt /
// M columns of the level's nt-point transforms, c = N B / nt lanes a
// column), gives out as (S, M, c): out[j2, k1, b] = w_nt^(k1 j2) X[k1],
// X the M-point DFT of x[:, j2, b] (the level twiddle w_nt = w_N^(N / nt)
// read by index from the word-packed root table `roots`, W[j] = w_N^j; no
// product where k1 j2 = 0). The tile's M rows of its lanes are loaded
// coalesced into shared memory as words, times pre[i] (i = the element's
// natural index, flat / B) where given (the forward coset's g^i); the DIF
// runs in passes of up to kLevelPass stages, each point in registers
// between two barriers; the store takes the rows bit-reversed (k1 in
// order), walking contiguous runs of the output, and multiplies by
// post[o / B] (or post[0] where post_one) where given (the inverse's 1/N,
// or 1/N g^-i).
// The last level (S = 1) writes the transform in natural order. Shared
// memory: the tile (NW M (TL + 1) words), then the M/2 stage twiddles
// w_M^j = W[j N / M], word-major.
template <class F, int NW, class Ctx>
OZL_HD void fourstep_level_block(const F& Fd, Ctx& ctx, uint32_t* sm, int32_t* out, const int32_t* x,
                                 const uint32_t* roots, const uint32_t* pre, const uint32_t* post, bool post_one,
                                 int LN, int LM, int S, int c, int B, int TL, int tile_idx) {
  constexpr int K = kLevelBatch;
  const int M = 1 << LM, half = M / 2, TLP = TL + 1, t = ctx.t, T = ctx.T;
  uint32_t* tile = sm;
  uint32_t* stw = sm + NW * M * TLP;
  const int lanes = S * c;
  const int64_t ls = ((int64_t)1 << LN) * B;
  const LevelTile lt = level_tile(tile_idx, S, c, TL);
  const int items = M * lt.lanes;
  for (int first = t; first < items; first += K * T) {
    Fp<NW> v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int it = first + k * T;
      if (it >= items) break;
      const int row = it / lt.lanes, u = it - row * lt.lanes;
      const int idx = row * lanes + lt.lane0 + u;
      v[k] = load_fp<NW>(x, ls, idx);
      if (pre) v[k] = Fd.mul(v[k], load_words<NW>(pre, idx / B));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int it = first + k * T;
      if (it >= items) break;
      const int row = it / lt.lanes, u = it - row * lt.lanes;
#pragma unroll
      for (int w = 0; w < NW; ++w) tile[(w * M + row) * TLP + u] = v[k].w[w];
    }
  }
  for (int e = t; e < half; e += T) {
    const Fp<NW> w = load_words<NW>(roots, (int64_t)e << (LN - LM));
#pragma unroll
    for (int k = 0; k < NW; ++k) stw[k * half + e] = w.w[k];
  }
  ctx.sync_block();
  const int passes = (LM + kLevelPass - 1) / kLevelPass, lt_log = log2_int((uint32_t)TL);
  int s0 = 0;
  for (int p = 0; p < passes; ++p) {
    const int a = LM / passes + (p < LM % passes ? 1 : 0);
    for (int it = t; it < (M >> a) * TL; it += T) {
      const int u = it & (TL - 1), g = it >> lt_log;
      if (u >= lt.lanes) continue;
      if (a == 1) level_pass<F, NW, 1>(Fd, tile, stw, M, TLP, s0, g, u);
      if (a == 2) level_pass<F, NW, 2>(Fd, tile, stw, M, TLP, s0, g, u);
    }
    s0 += a;
    ctx.sync_block();
  }
  const int stride = (int)((((int64_t)1 << LN) >> LM) / S);  // N / nt
  for (int first = t; first < items; first += K * T) {
    Fp<NW> v[K], tw[K];
    int o[K];
    bool twiddled[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = first + k * T;
      twiddled[k] = false;
      if (q >= items) break;
      const int bl = q % lt.run, k1 = (q / lt.run) & (M - 1), u = q / (lt.run * M) * lt.run + bl;
      const int lane = lt.lane0 + u, j2 = lane / c, b = lane - j2 * c;
      const int row = (int)bit_reverse((uint32_t)k1, LM);
#pragma unroll
      for (int w = 0; w < NW; ++w) v[k].w[w] = tile[(w * M + row) * TLP + u];
      const int e = stride * k1 * j2;
      twiddled[k] = e != 0;
      if (e) tw[k] = load_words<NW>(roots, e);
      o[k] = (j2 * M + k1) * c + b;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (first + k * T >= items) break;
      if (twiddled[k]) v[k] = Fd.mul(v[k], tw[k]);
      if (post) v[k] = Fd.mul(v[k], load_words<NW>(post, post_one ? 0 : o[k] / B));
      store_fp<NW>(out, ls, o[k], v[k]);
    }
  }
}
