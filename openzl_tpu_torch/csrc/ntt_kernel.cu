// K1: elementwise Montgomery product and, through the same field code, the
// Montgomery exponentiation; K2: batched M-point DIF NTT; K8: one radix-2
// butterfly stage.
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
// K2 replaces `_make_small_ntt_kernel` (:160, through `small_ntt()` :200):
// all log2(M) decimation-in-frequency stages of an M-point transform along
// axis 1 of x (n_limbs, M, lanes), output in bit-reversed order along M,
// with an optional fused elementwise post-twiddle (the four-step level
// twiddle). A block owns COLS lanes; its M x COLS elements and the stage
// twiddles are staged in shared memory once, every stage runs on them with
// one thread per butterfly, and the result is written once. Bound: the
// M/2 log2(M) Montgomery products per lane (compute), so the design reads
// and writes each element once per launch instead of once per stage. The
// TPU's M <= 64 and rolled-stage layout were VMEM artefacts; here M is any
// power of two up to 64 chosen by the caller, and the twiddle table is
// (n_limbs, log2 M, M/2) with entry j of stage s = w_M^(2^s j).
//
// K8 replaces `_make_butterfly_kernel` (:44, through `butterfly()` :244):
// lo = u + t, hi = (u - t) w. The reference feeds it operands that XLA has
// already split, gathered (the stage twiddles) and later interleaves; here
// one launch is one whole constant-geometry (Pease) DIF stage of
// ops/ntt.py `_ntt_core`: thread (k, b) reads x[k] and x[k + N/2] of batch
// column b, takes the twiddle W[k & ~(2^s - 1)] from the (n_limbs, N/2)
// root table by index, and writes lo to slot 2k and hi to slot 2k + 1, so
// no gather, stack or reshape runs around a stage. One thread per
// butterfly, words in registers, the CIOS product of field.cuh. Bound on
// the card: bytes (u and t read, lo and hi written, 16 bytes per 32-bit
// word each; the table is small and L2-resident) against one Montgomery
// product per butterfly, so a stage is a streaming pass; the design
// touches each element once per stage. Strides make the same kernel the
// elementwise butterfly (separate lo and hi arrays, a full twiddle array,
// mask -1, batch 1).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// p's top word below this: F1c's carry chains hold (field.cuh)
constexpr uint32_t kF1cTop = 0x7FFFFFFFu;

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

// F1c where p's top word is below its bound, F1 otherwise (and for
// one-word fields, which F1c does not take)
template <int NW>
bool carry_chains(const uint32_t* p) {
  return NW >= 2 && p[NW - 1] < kF1cTop;
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

// shared layout: data[w][row][col] then tw[s][j][w]
template <int NW>
__global__ void small_ntt_kernel(int32_t* out, const int32_t* x, const int32_t* stage_tw,
                                 const int32_t* post_tw, int M, int log_m, int64_t lanes,
                                 int cols, FieldParams<NW> f) {
  extern __shared__ uint32_t sm[];
  uint32_t* data = sm;
  uint32_t* tw = sm + (size_t)NW * M * cols;
  const int half = M / 2;
  const int tx = threadIdx.x;  // lane within the block
  const int ty = threadIdx.y;  // butterfly index
  const int64_t lane = (int64_t)blockIdx.x * cols + tx;
  const bool live = lane < lanes;
  F1<NW> F{f};

  // stage twiddles, (n_limbs, log_m, half) limbs -> words
  const int n_tw = log_m * half;
  for (int e = ty * cols + tx; e < n_tw; e += cols * half) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t lo = (uint32_t)stage_tw[(int64_t)(2 * w) * n_tw + e];
      uint32_t hi = (uint32_t)stage_tw[(int64_t)(2 * w + 1) * n_tw + e];
      tw[(size_t)e * NW + w] = lo | (hi << 16);
    }
  }
  const int64_t ls = (int64_t)M * lanes;  // limb stride of x / out / post
  const int rows[2] = {ty, ty + half};
  if (live) {
    for (int r = 0; r < 2; ++r) {
      Fp<NW> v = load_fp<NW>(x, ls, (int64_t)rows[r] * lanes + lane);
#pragma unroll
      for (int w = 0; w < NW; ++w) data[((size_t)w * M + rows[r]) * cols + tx] = v.w[w];
    }
  }
  __syncthreads();

  for (int s = 0; s < log_m; ++s) {
    const int h = M >> (s + 1);
    const int blk = ty / h, i = ty % h;
    const int ur = blk * 2 * h + i, tr = ur + h;
    if (live) {
      Fp<NW> u, t, wv;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        u.w[w] = data[((size_t)w * M + ur) * cols + tx];
        t.w[w] = data[((size_t)w * M + tr) * cols + tx];
        wv.w[w] = tw[((size_t)s * half + i) * NW + w];
      }
      Fp<NW> lo = F.add(u, t);
      Fp<NW> hi = F.mul(F.sub(u, t), wv);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        data[((size_t)w * M + ur) * cols + tx] = lo.w[w];
        data[((size_t)w * M + tr) * cols + tx] = hi.w[w];
      }
    }
    __syncthreads();
  }

  if (!live) return;
  for (int r = 0; r < 2; ++r) {
    Fp<NW> v;
#pragma unroll
    for (int w = 0; w < NW; ++w) v.w[w] = data[((size_t)w * M + rows[r]) * cols + tx];
    const int64_t idx = (int64_t)rows[r] * lanes + lane;
    if (post_tw) v = F.mul(v, load_fp<NW>(post_tw, ls, idx));
    store_fp<NW>(out, ls, idx, v);
  }
}

template <int NW>
int launch_small_ntt(void* out, const void* x, const void* stage_tw, const void* post_tw, int M,
                     int64_t lanes, const uint32_t* p, uint32_t n0, cudaStream_t st) {
  if (M < 2 || M > 64 || (M & (M - 1))) return (int)cudaErrorInvalidValue;
  int log_m = 0;
  while ((1 << log_m) < M) ++log_m;
  const int half = M / 2;
  const int cols = 256 / half > 0 ? 256 / half : 1;
  size_t smem = sizeof(uint32_t) * NW * ((size_t)M * cols + (size_t)log_m * half);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(small_ntt_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t blocks = (lanes + cols - 1) / cols;
  dim3 block(cols, half);
  if (blocks > 0)
    small_ntt_kernel<NW><<<(unsigned)blocks, block, smem, st>>>(
        (int32_t*)out, (const int32_t*)x, (const int32_t*)stage_tw, (const int32_t*)post_tw, M,
        log_m, lanes, cols, make_params<NW>(p, n0));
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

extern "C" int ozl_small_ntt(void* out, const void* x, const void* stage_tw, const void* post_tw,
                             int M, int64_t lanes, int n_limbs, const void* p, uint32_t n0,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* pw = (const uint32_t*)p;
  switch (n_limbs) {
    case 2: return launch_small_ntt<1>(out, x, stage_tw, post_tw, M, lanes, pw, n0, st);
    case 16: return launch_small_ntt<8>(out, x, stage_tw, post_tw, M, lanes, pw, n0, st);
    case 24: return launch_small_ntt<12>(out, x, stage_tw, post_tw, M, lanes, pw, n0, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
