// K1: elementwise Montgomery product and, through the same field code, the
// Montgomery exponentiation; K2: one level of the four-step transform (from
// 2^13) in one launch; K8: a whole transform below 2^13 in one launch, and
// one radix-2 butterfly stage.
//
// K1 replaces openzl_tpu/ops/ntt_kernel.py `_make_mul_kernel` (:56, through
// `mont_mul()` :259 and `mont_scale()` :268). One thread per element; the
// sixteen-bit limbs of a column are read by neighbouring threads from
// neighbouring addresses (limb-planar layout), so every load and store is
// coalesced. Bound on the card: bytes (3 x 4 n_limbs bytes per element
// against one product's NW^2 + NW^2 + NW/2 word products; at 2^17 BN254
// elements the bytes take longer); the design keeps the whole product in
// registers and touches device memory once per operand. Scale mode reads
// one broadcast element (b strides 0 over elements). The product runs on
// F1, whose 2^17-element launch took 0.0070 ms of device time on the H100
// against 0.0080 for the same kernel on F1c (field.cuh, carry chains;
// PERF.md).
//
// K1's exponentiation (`ozl_mont_pow`) replaces the chain of K1 launches
// that `limb.mont_pow` ran, one launch per square or product, whose JAX
// counterpart is one lax.scan (openzl_tpu/fields/limb.py `mont_pow` :308):
// out = a^e for an exponent given as 32-bit words and its bit length (any
// Python int: p - 2 for a Fermat inverse, 0, 1, ...), by the same MSB-first
// square and multiply, the Montgomery one for e = 0. One thread per
// element holds the whole chain in registers; the exponent's bits are the
// same for every thread, so the branch on a bit is uniform. Its callers
// invert one to a few elements (a batch inversion's total, an Fq2 norm),
// so a launch lasts one thread's chain of NW-word products: latency, not
// throughput, bounds it, and the design takes a launch of some 380 (BN254)
// to 570 (BLS12-381 Fq) products down to one. F1c's product and dedicated
// square where p's top word allows, F1 otherwise: by p - 2, one element
// took 0.1917 ms of device time on F1c against F1's 0.2297 over BN254 Fq,
// 0.6852 against 0.7986 over BLS12-381 Fq (PERF.md).
//
// K2 replaces `_make_small_ntt_kernel` (:160, through `small_ntt()` :200),
// and with it the route around it (openzl_tpu/ops/ntt.py
// `fourstep_transform`: the level twiddle, the bit-reversal gather and the
// transpose): ONE launch runs one level of the four-step transform
// (`ozl_fourstep_level`, block code ntt.cuh `fourstep_level_block`). A
// level reads x as (M, S, c), M <= 2^9 rows of S columns of c lanes, and
// writes (S, M, c): the M-point DFT of each (column, lane), times the
// level twiddle w_nt^(k1 j2), in natural order, which is the next level's
// input layout; the last level (S = 1) writes the transform. A 2^17
// transform is 3 launches ([6, 6, 5]), where the route before took 3 K2
// launches, 3 gathers, 2 transposes, a full-size level-twiddle table read
// per level, and a K1 scale for the inverse. Bound: the products (the
// DIF's M/2 log2 M per lane less the butterflies whose twiddle is 1, the
// level twiddles that are not 1, the scales) against the issue rate at M =
// 64, with the data read and written once close behind (at 2^17, batch 1,
// 0.0062 and 0.0061 ms of products against 0.0055 and 0.0050 of bytes);
// the M = 32 level is bound by its bytes (0.0050 ms against 0.0032 of
// products). The design: a block loads a tile of lanes x M rows coalesced
// into shared memory as 32-bit words (row stride lanes + 1 words: a pass's
// and the store's warps spread over the banks), runs the DIF in passes of
// two radix-2 stages with each thread's four points in registers (radix 4;
// at M = 64 three passes, where the kernel before took one barrier and one
// shared-memory round trip a stage; radix 8 needs 160 registers at 8 words
// and ran 1.6-1.8x slower), leaves out every product by a twiddle of 1, reads
// the stage twiddles from M/2 words in shared memory and the level twiddle
// by index from the word-packed root table (N x NW words, cached in L2; it
// does not grow with the batch), and stores the rows bit-reversed by
// index, walking contiguous runs of the output. The forward coset's g^i
// multiplies the first level's load and the inverse's 1/N (1/N g^-i for
// the coset inverse) the last level's store, so the coset transforms take
// no K1 launch. It runs at about a quarter of its bound on the H100
// (PERF.md), at the same time an element at batch 1 and 3, whatever the
// warps in flight. The cause is not profiled; the hypothesis is the
// integer pipe: each carry op of F1c is an IMAD and an IADD3 (the SASS of
// K1's product), and the butterflies' additions and selects share that
// pipe. F1c where p's top word allows (F1 ran 5-10% slower at the same
// shapes), F1 otherwise; 2-, 16- and 24-limb fields.
//
// K8 replaces `_make_butterfly_kernel` (:44, through `butterfly()` :244):
// lo = u + t, hi = (u - t) w, as the reference's per-stage route
// (openzl_tpu/ops/ntt.py `_ntt_core` :109) runs it, one butterfly stage a
// scan step. Two entry points:
//   - `ozl_ntt_transform`, the per-stage route's one launch: a whole N-point
//     transform, 2 <= N <= 2^12, of every column of x (n_limbs, N, B) in
//     ONE launch (ntt.cuh `ntt_transform_block`): the column is loaded
//     into shared memory as 32-bit words, every radix-2 stage runs there
//     with a barrier between stages (Cooley-Tukey butterflies u + w t,
//     u - w t in place, natural order in, the root table staged once in
//     bit-reversed order so that group g of any stage reads entry g), and
//     the store writes the bit-reversed slots to natural order, times 1/N
//     for the inverse. Results are canonical, so they equal the plain
//     version's Pease stages, gather and scale bit for bit. Not the
//     Pease (constant-geometry) stages themselves: they write out of
//     place, and two 2^12 columns of 8-word elements (256 KB) do not fit
//     a block, where the in-place stages need one barrier a stage and
//     read every twiddle without a bank conflict. What bounds it
//     at batch 1: latency, not the card's issue or bytes: a 2^12 transform
//     is 12 dependent stages of one product each, and a block holds one
//     SM. The design splits a transform over a thread-block cluster of up
//     to 8 blocks (`cluster`; `ops/ntt_kernel.py` CLUSTER): the first
//     log2 C stages pair slots across blocks through distributed shared
//     memory, with a cluster barrier, and the rest stay in each block's
//     own slots; and it replaces the stage-a-launch route's log2 N + 2
//     launches, whose time was the host's (PERF.md). At 2^12 one block's slots
//     and the table fill 192 KB of the 227 KB a block can have. F1c where
//     p's top word allows, F1 otherwise; 16-limb fields only.
//   - `ozl_butterfly`, one whole constant-geometry (Pease) DIF stage a
//     launch (`ntt_kernel.stage`), and with strides the elementwise
//     butterfly: thread (k, b) reads x[k] and x[k + N/2] of batch column
//     b, takes the twiddle W[k & ~(2^s - 1)] from the (n_limbs, N/2) root
//     table by index, and writes lo to slot 2k and hi to slot 2k + 1. One
//     thread per butterfly, words in registers, the CIOS product of
//     field.cuh; bound by bytes (u and t read, lo and hi written).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"
#include "ntt.cuh"

namespace {

template <class F, int NW>
OZL_HD F make_field(const FieldParams<NW>& f) {
  F Fd;
  Fd.f = f;
  return Fd;
}

template <int NW>
__global__ void mont_mul_kernel(int32_t* out, const int32_t* a, const int32_t* b, int64_t N,
                                int64_t b_ls, int64_t b_es, FieldParams<NW> f) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  F1<NW> F{f};
  Fp<NW> x = load_fp<NW>(a, N, i);
  Fp<NW> y = load_fp<NW>(b, b_ls, i * b_es);
  store_fp<NW>(out, N, i, F.mul(x, y));
}

template <class F, int NW>
__global__ void mont_pow_kernel(int32_t* out, const int32_t* a, int64_t N, const uint32_t* e,
                                int bits, FieldParams<NW> f, Fp<NW> one) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const F Fd = make_field<F, NW>(f);
  store_fp<NW>(out, N, i, pow_bits(Fd, load_fp<NW>(a, N, i), e, bits, one));
}

template <int NW>
int launch_mont_mul(void* out, const void* a, const void* b, int64_t N, int64_t b_ls,
                    int64_t b_es, const uint32_t* p, uint32_t n0, cudaStream_t st) {
  const int threads = 256;
  int64_t blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    mont_mul_kernel<NW><<<(unsigned)blocks, threads, 0, st>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, N, b_ls, b_es,
        make_params<NW>(p, n0));
  return (int)cudaGetLastError();
}

template <class F, int NW>
void start_pow(unsigned blocks, int threads, cudaStream_t st, void* out, const void* a, int64_t N,
               const void* e, int bits, const FieldParams<NW>& f, const Fp<NW>& one) {
  mont_pow_kernel<F, NW><<<blocks, threads, 0, st>>>((int32_t*)out, (const int32_t*)a, N,
                                                     (const uint32_t*)e, bits, f, one);
}

// one thread per element in blocks of 128: a launch of a few elements is
// one block whatever its size, and 2^10 elements spread over 8 SMs
template <int NW>
int launch_mont_pow(void* out, const void* a, int64_t N, const void* e, int bits,
                    const uint32_t* p, uint32_t n0, const uint32_t* one_words, cudaStream_t st) {
  const int threads = 128;
  int64_t blocks = (N + threads - 1) / threads;
  if (blocks <= 0) return (int)cudaGetLastError();
  const FieldParams<NW> f = make_params<NW>(p, n0);
  Fp<NW> one;
  for (int w = 0; w < NW; ++w) one.w[w] = one_words[w];
  if constexpr (NW >= 2) {
    if (carry_chains<NW>(p)) {
      start_pow<F1c<NW>, NW>((unsigned)blocks, threads, st, out, a, N, e, bits, f, one);
      return (int)cudaGetLastError();
    }
  }
  start_pow<F1<NW>, NW>((unsigned)blocks, threads, st, out, a, N, e, bits, f, one);
  return (int)cudaGetLastError();
}

// element (k, b) of u / t at k * B + b (limb stride in_ls); twiddle
// k & mask of tw (limb stride tw_ls); lo / hi at k * out_ks + b
template <int NW>
__global__ void butterfly_kernel(const int32_t* u, const int32_t* t, int64_t in_ls,
                                 const int32_t* tw, int64_t tw_ls, int64_t mask, int32_t* lo,
                                 int32_t* hi, int64_t out_ls, int64_t out_ks, int64_t H,
                                 int64_t B, FieldParams<NW> f) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * B) return;
  const int64_t k = i / B, b = i - k * B;
  F1<NW> F{f};
  Fp<NW> x = load_fp<NW>(u, in_ls, i);
  Fp<NW> y = load_fp<NW>(t, in_ls, i);
  Fp<NW> w = load_fp<NW>(tw, tw_ls, k & mask);
  const int64_t o = k * out_ks + b;
  store_fp<NW>(lo, out_ls, o, F.add(x, y));
  store_fp<NW>(hi, out_ls, o, F.mul(F.sub(x, y), w));
}

template <int NW>
int launch_butterfly(const void* u, const void* t, int64_t in_ls, const void* tw, int64_t tw_ls,
                     int64_t mask, void* lo, void* hi, int64_t out_ls, int64_t out_ks, int64_t H,
                     int64_t B, const uint32_t* p, uint32_t n0, cudaStream_t st) {
  const int threads = 256;
  int64_t blocks = (H * B + threads - 1) / threads;
  if (blocks > 0)
    butterfly_kernel<NW><<<(unsigned)blocks, threads, 0, st>>>(
        (const int32_t*)u, (const int32_t*)t, in_ls, (const int32_t*)tw, tw_ls, mask,
        (int32_t*)lo, (int32_t*)hi, out_ls, out_ks, H, B, make_params<NW>(p, n0));
  return (int)cudaGetLastError();
}

// K8's transform: the contexts of ntt_transform_block (ntt.cuh) for one
// block and for a block of a cluster (distributed shared memory)
struct BlockCtx {
  int t, T, r, C;
  uint32_t* data;
  __device__ uint32_t* slots(int) const { return data; }
  __device__ void sync_block() const { __syncthreads(); }
  __device__ void sync_cluster() const { __syncthreads(); }
};

struct ClusterCtx {
  int t, T, r, C;
  uint32_t* data;
  __device__ uint32_t* slots(int k) const { return cooperative_groups::this_cluster().map_shared_rank(data, k); }
  __device__ void sync_block() const { __syncthreads(); }
  __device__ void sync_cluster() const { cooperative_groups::this_cluster().sync(); }
};

// One N-point transform per cluster of C blocks (C = 1: one block), column
// b = blockIdx.x / C; shared memory holds the block's slots, then the
// twiddles (ntt.cuh). At most 512 threads a block: a 1024-thread bound caps
// a thread at 64 registers, and the butterfly then spills
template <class F, int NW>
__global__ void __launch_bounds__(512)
    ntt_transform_kernel(int32_t* out, const int32_t* x, const int32_t* table, const int32_t* n_inv, int L,
                         int64_t B, int C, FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  const int S = (1 << L) / C;
  const F Fd = make_field<F, NW>(f);
  const int r = (int)(blockIdx.x % C);
  const int64_t b = blockIdx.x / C;
  if (C == 1) {
    BlockCtx ctx{(int)threadIdx.x, (int)blockDim.x, 0, 1, sm};
    ntt_transform_block<F, NW>(Fd, ctx, sm, sm + NW * S, x, table, n_inv, out, L, B, b);
  } else {
    ClusterCtx ctx{(int)threadIdx.x, (int)blockDim.x, r, C, sm};
    ntt_transform_block<F, NW>(Fd, ctx, sm, sm + NW * S, x, table, n_inv, out, L, B, b);
  }
}

// blocks of min(S / 2, 512) threads; clusters through cudaLaunchKernelEx
template <class F, int NW>
int start_transform(void* out, const void* x, const void* table, const void* n_inv, int L, int64_t B, int C,
                    const FieldParams<NW>& f, cudaStream_t st) {
  const int S = (1 << L) / C;
  const size_t smem = sizeof(uint32_t) * NW * ((size_t)S + (1 << L) / 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ntt_transform_kernel<F, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3((unsigned)(S / 2 < 512 ? S / 2 : 512));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ntt_transform_kernel<F, NW>, (int32_t*)out, (const int32_t*)x,
                                     (const int32_t*)table, (const int32_t*)n_inv, L, B, C, f);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// 2 <= N = 2^L <= kTransformMax, C a power of two with 2 <= N / C, at most 8
constexpr int kTransformMax = 1 << 12;

template <int NW>
int launch_transform(void* out, const void* x, const void* table, const void* n_inv, int L, int64_t B, int C,
                     const uint32_t* p, uint32_t n0, cudaStream_t st) {
  if (L < 1 || (1 << L) > kTransformMax || C < 1 || C > 8 || (C & (C - 1)) || (1 << L) / C < 2)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const FieldParams<NW> f = make_params<NW>(p, n0);
  if (carry_chains<NW>(p)) return start_transform<F1c<NW>, NW>(out, x, table, n_inv, L, B, C, f, st);
  return start_transform<F1<NW>, NW>(out, x, table, n_inv, L, B, C, f, st);
}

// K2: one four-step level per launch, a block a tile (ntt.cuh
// `fourstep_level_block`); the block's T threads take the items of its
// largest pass, at most 256: a 256-thread bound leaves a thread up to 255
// registers, which eight points of twelve words in registers need
template <class F, int NW>
__global__ void __launch_bounds__(256)
    fourstep_level_kernel(int32_t* out, const int32_t* x, const uint32_t* roots, const uint32_t* pre,
                          const uint32_t* post, int post_one, int LN, int LM, int S, int c, int B, int TL,
                          FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  const F Fd = make_field<F, NW>(f);
  BlockCtx ctx{(int)threadIdx.x, (int)blockDim.x, 0, 1, sm};
  fourstep_level_block<F, NW>(Fd, ctx, sm, out, x, roots, pre, post, post_one != 0, LN, LM, S, c, B, TL,
                                 (int)blockIdx.x);
}

// largest level (M = 2^kLevelMaxLog points) and tile (lanes a block)
constexpr int kLevelMaxLog = 9;
constexpr int kLevelMaxTile = 256;

template <class F, int NW>
int start_level(void* out, const void* x, const void* roots, const void* pre, const void* post, int post_one,
                int LN, int LM, int64_t S, int64_t c, int64_t B, int TL, const FieldParams<NW>& f,
                cudaStream_t st) {
  const int M = 1 << LM;
  const size_t smem = sizeof(uint32_t) * NW * ((size_t)M * (TL + 1) + M / 2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fourstep_level_kernel<F, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int passes = (LM + kLevelPass - 1) / kLevelPass, a_max = (LM + passes - 1) / passes;
  int threads = (M >> a_max) * TL;
  threads = threads < 32 ? 32 : threads > 256 ? 256 : threads;
  const int tiles = level_tiles((int)S, (int)c, TL);
  fourstep_level_kernel<F, NW><<<(unsigned)tiles, threads, smem, st>>>(
      (int32_t*)out, (const int32_t*)x, (const uint32_t*)roots, (const uint32_t*)pre, (const uint32_t*)post,
      post_one, LN, LM, (int)S, (int)c, (int)B, TL, f);
  return (int)cudaGetLastError();
}

// 1 <= LM <= min(LN, kLevelMaxLog), S a power of two with M S <= N, c B
// given with M S c = N B < 2^31 (32-bit indices within a level), TL a
// power of two up to kLevelMaxTile
template <int NW>
int launch_level(void* out, const void* x, const void* roots, const void* pre, const void* post, int post_one,
                 int LN, int LM, int64_t S, int64_t c, int64_t B, int TL, const uint32_t* p, uint32_t n0,
                 cudaStream_t st) {
  if (LM < 1 || LM > kLevelMaxLog || LM > LN || LN > 40 || S < 1 || (S & (S - 1)) || c < 1 || B < 1 ||
      TL < 1 || TL > kLevelMaxTile || (TL & (TL - 1)) || ((int64_t)1 << LM) * S * c != ((int64_t)1 << LN) * B ||
      ((int64_t)1 << LN) * B >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const FieldParams<NW> f = make_params<NW>(p, n0);
  if constexpr (NW >= 2) {
    if (carry_chains<NW>(p))
      return start_level<F1c<NW>, NW>(out, x, roots, pre, post, post_one, LN, LM, S, c, B, TL, f, st);
  }
  return start_level<F1<NW>, NW>(out, x, roots, pre, post, post_one, LN, LM, S, c, B, TL, f, st);
}

}  // namespace

extern "C" int ozl_butterfly(const void* u, const void* t, int64_t in_ls, const void* tw,
                             int64_t tw_ls, int64_t mask, void* lo, void* hi, int64_t out_ls,
                             int64_t out_ks, int64_t H, int64_t B, int n_limbs, const void* p,
                             uint32_t n0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pw = (const uint32_t*)p;
  switch (n_limbs) {
    case 2:
      return launch_butterfly<1>(u, t, in_ls, tw, tw_ls, mask, lo, hi, out_ls, out_ks, H, B, pw,
                                 n0, st);
    case 16:
      return launch_butterfly<8>(u, t, in_ls, tw, tw_ls, mask, lo, hi, out_ls, out_ks, H, B, pw,
                                 n0, st);
    case 24:
      return launch_butterfly<12>(u, t, in_ls, tw, tw_ls, mask, lo, hi, out_ls, out_ks, H, B, pw,
                                  n0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ozl_mont_mul(void* out, const void* a, const void* b, int64_t N, int64_t b_ls,
                            int64_t b_es, int n_limbs, const void* p, uint32_t n0,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pw = (const uint32_t*)p;
  switch (n_limbs) {
    case 2: return launch_mont_mul<1>(out, a, b, N, b_ls, b_es, pw, n0, st);
    case 16: return launch_mont_mul<8>(out, a, b, N, b_ls, b_es, pw, n0, st);
    case 24: return launch_mont_mul<12>(out, a, b, N, b_ls, b_es, pw, n0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = a^e over N elements of n_limbs limbs; e: device words of the
// exponent, little-endian, `bits` its bit length (0 for e = 0); one: the
// Montgomery one R mod p as host words
extern "C" int ozl_mont_pow(void* out, const void* a, int64_t N, const void* e, int bits,
                            int n_limbs, const void* p, uint32_t n0, const void* one,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* ow = (const uint32_t*)one;
  if (bits < 0) return (int)cudaErrorInvalidValue;
  switch (n_limbs) {
    case 2: return launch_mont_pow<1>(out, a, N, e, bits, pw, n0, ow, st);
    case 16: return launch_mont_pow<8>(out, a, N, e, bits, pw, n0, ow, st);
    case 24: return launch_mont_pow<12>(out, a, N, e, bits, pw, n0, ow, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The N = 2^log_n point transform of every column of x (n_limbs, N, B)
// into out, natural order in and out, with the root table (n_limbs, N/2)
// of W[j] = w^j and, for the inverse, the 1/N scale n_inv (n_limbs, or
// null); `cluster` blocks a transform. 16-limb fields only.
extern "C" int ozl_ntt_transform(void* out, const void* x, const void* table, const void* n_inv, int log_n,
                                 int64_t B, int cluster, int n_limbs, const void* p, uint32_t n0,
                                 void* stream) {
  if (n_limbs != 16) return (int)cudaErrorInvalidValue;
  return launch_transform<8>(out, x, table, n_inv, log_n, B, cluster, (const uint32_t*)p, n0,
                             (cudaStream_t)stream);
}

// One level of the four-step transform of N = 2^log_n points of a batch
// of B (x and out (n_limbs, N, B)): x as (M, S, c) with M = 2^log_m, out
// as (S, M, c) (ntt.cuh `fourstep_level_block`); roots (N, NW) words of
// w_N^j; pre (N, NW) words or null; post (N, NW) words, or one element
// where post_one, or null; `tile` lanes a block
extern "C" int ozl_fourstep_level(void* out, const void* x, const void* roots, const void* pre, const void* post,
                                  int post_one, int log_n, int log_m, int64_t S, int64_t c, int64_t B, int tile,
                                  int n_limbs, const void* p, uint32_t n0, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pw = (const uint32_t*)p;
  switch (n_limbs) {
    case 2: return launch_level<1>(out, x, roots, pre, post, post_one, log_n, log_m, S, c, B, tile, pw, n0, st);
    case 16: return launch_level<8>(out, x, roots, pre, post, post_one, log_n, log_m, S, c, B, tile, pw, n0, st);
    case 24: return launch_level<12>(out, x, roots, pre, post, post_one, log_n, log_m, S, c, B, tile, pw, n0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
