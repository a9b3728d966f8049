// Microbenchmark of the kernels' field arithmetic on the card: a chain of
// one operation (F1, the 64-bit C arithmetic of K2, K7 and K8, against
// F1c, the carry-chain arithmetic of K1's exponentiation, K3-K6 and K9) on
// one warp (latency) and on 132 x 16 blocks of 128 threads (throughput),
// one G1 mixed add (K9's step) the same way, and K5's split rounds at 32,
// 64 and 128 threads a block. BN254 Fq, random data in [0, 2^252). Built
// and run by kernel_probe.py.
//
//   field_microbench                         everything above
//   field_microbench latency NW n0 p_0 ...   the latency of F1's and F1c's
//       product and square on one warp over the NW-word (8 or 12) field
//       of modulus words p_0 (lowest) ... p_{NW-1} and n0 = -p^-1 mod 2^32
//       (hexadecimal), one line each: "[latency] NW=<NW> <field> <op>:
//       <ns> ns" (the bound of K1's exponentiation chain)
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

#include "ec.cuh"
#include "poseidon.cuh"

namespace {

constexpr uint32_t kP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                            0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
constexpr uint32_t kN0 = 0xe4866389u;

template <int NW = 8>
__device__ Fp<NW> seed(uint32_t s) {
  Fp<NW> x;
  for (int i = 0; i < NW; ++i) x.w[i] = (s * 2654435761u + i * 40503u) & 0x0fffffffu;
  return x;
}

template <class F, int OP, int NW = 8>
__global__ void op_chain(uint32_t* out, FieldParams<NW> f, int iters) {
  F Fd;
  Fd.f = f;
  Fp<NW> x = seed<NW>(threadIdx.x), y = seed<NW>(blockIdx.x + 7);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    if (OP == 0) x = Fd.mul(x, y);
    if (OP == 1) x = Fd.sqr(x);
    if (OP == 2) x = Fd.add(x, y);
    if (OP == 3) x = Fd.sub(x, y);
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x.w[0] ^ x.w[NW - 1];
}

template <class F>
__global__ void madd_chain(uint32_t* out, FieldParams<8> f, int iters) {
  EcParams<F> E;
  E.field.f = f;
  E.has_a = false;
  Fp<8> ax = seed(threadIdx.x), ay = seed(threadIdx.x + 3), az = seed(threadIdx.x + 5);
  const Fp<8> qx = seed(blockIdx.x), qy = seed(blockIdx.x + 1), one = seed(1);
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    Fp<8> sx, sy, sz;
    ec_add<F, true>(E, ax, ay, az, qx, qy, one, sx, sy, sz);
    ax = sx;
    ay = sy;
    az = sz;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = ax.w[0] ^ ay.w[1] ^ az.w[2];
}

struct WarpGroup {
  __device__ uint32_t shfl(uint32_t v, int src) { return __shfl_sync(0xffffffffu, v, src, kSplit); }
};

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    split_rounds(uint32_t* out, const uint32_t* consts, int n_words, FieldParams<8> f) {
  extern __shared__ uint32_t sm[];
  for (int e = threadIdx.x; e < n_words; e += blockDim.x) sm[e] = consts[e];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  F1c<8> F;
  F.f = f;
  WarpGroup g;
  Fp<8> x[3] = {seed(t), seed(t + 1), seed(t + 2)};
  poseidon_split_lane<8>(F, g, t % kSplit, x, sm, 8, 55);
  out[t] = x[0].w[0] ^ x[2].w[3];
}

// mean ms of 3 launches after a warm-up one
template <class K>
float run(K kernel, int blocks, int threads, size_t smem, void** args) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernel((const void*)kernel, blocks, threads, args, smem, 0);
  cudaEventRecord(a);
  for (int r = 0; r < 3; ++r) cudaLaunchKernel((const void*)kernel, blocks, threads, args, smem, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  if (cudaGetLastError() != cudaSuccess) {
    printf("launch failed\n");
    return -1;
  }
  return ms / 3;
}

template <class F, int OP>
void op_row(const char* field, const char* op, uint32_t* out, FieldParams<8> f) {
  int iters = 2000;
  void* args[] = {&out, &f, &iters};
  const float lat = run(op_chain<F, OP>, 1, 32, 0, args) * 1e6f / iters;
  const float thr = run(op_chain<F, OP>, 132 * 16, 128, 0, args) * 1e6f / iters / (132.0f * 16 * 128);
  printf("[micro] %s %s: %.1f ns latency (one warp), %.4f ns per op over the card\n", field, op, lat, thr);
}

template <class F>
void madd_row(const char* field, uint32_t* out, FieldParams<8> f) {
  int iters = 200;
  void* args[] = {&out, &f, &iters};
  const float lat = run(madd_chain<F>, 1, 32, 0, args) * 1e6f / iters;
  const float w12 = run(madd_chain<F>, 132 * 3, 128, 0, args) * 1e6f / iters;
  const float w16 = run(madd_chain<F>, 132 * 4, 128, 0, args) * 1e6f / iters;
  printf("[micro] %s G1 madd: %.1f ns latency (one warp); %.1f ns per step at 12 warps/SM, %.1f at 16 "
         "(%.4f ns per madd over the card)\n", field, lat, w12, w16, w16 / (132.0f * 512));
}

// ns per operation of a chain of 2000 on one warp
template <class F, int OP, int NW>
void latency_row(int nw, const char* field, const char* op, uint32_t* out, FieldParams<NW> f) {
  int iters = 2000;
  void* args[] = {&out, &f, &iters};
  const float lat = run(op_chain<F, OP, NW>, 1, 32, 0, args) * 1e6f / iters;
  printf("[latency] NW=%d %s %s: %.2f ns\n", nw, field, op, lat);
}

template <int NW>
int latency(uint32_t* out, char** words) {
  uint32_t p[NW];
  const uint32_t n0 = (uint32_t)strtoul(words[0], nullptr, 16);
  for (int i = 0; i < NW; ++i) p[i] = (uint32_t)strtoul(words[1 + i], nullptr, 16);
  const FieldParams<NW> f = make_params<NW>(p, n0);
  latency_row<F1<NW>, 0, NW>(NW, "F1", "mul", out, f);
  latency_row<F1<NW>, 1, NW>(NW, "F1", "sqr", out, f);
  latency_row<F1c<NW>, 0, NW>(NW, "F1c", "mul", out, f);
  latency_row<F1c<NW>, 1, NW>(NW, "F1c", "sqr", out, f);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  uint32_t* out;
  cudaMalloc(&out, 1 << 24);
  if (argc > 1 && !strcmp(argv[1], "latency")) {
    const int nw = argc > 2 ? atoi(argv[2]) : 0;
    if (nw == 8 && argc == 4 + 8) return latency<8>(out, argv + 3);
    if (nw == 12 && argc == 4 + 12) return latency<12>(out, argv + 3);
    fprintf(stderr, "usage: field_microbench latency 8|12 n0 p_0 ... p_{NW-1}\n");
    return 2;
  }
  const FieldParams<8> f = make_params<8>(kP, kN0);
  op_row<F1<8>, 0>("F1 ", "mul", out, f);
  op_row<F1c<8>, 0>("F1c", "mul", out, f);
  op_row<F1<8>, 1>("F1 ", "sqr", out, f);
  op_row<F1c<8>, 1>("F1c", "sqr", out, f);
  op_row<F1<8>, 2>("F1 ", "add", out, f);
  op_row<F1c<8>, 2>("F1c", "add", out, f);
  op_row<F1<8>, 3>("F1 ", "sub", out, f);
  op_row<F1c<8>, 3>("F1c", "sub", out, f);
  madd_row<F1<8>>("F1 ", out, f);
  madd_row<F1c<8>>("F1c", out, f);
  int n_words = poseidon_words(3, 8, 55, 8);
  std::vector<uint32_t> c(n_words);
  for (int i = 0; i < n_words; ++i) c[i] = (i * 2654435761u) & 0x0fffffffu;
  uint32_t* dc;
  cudaMalloc(&dc, n_words * 4);
  cudaMemcpy(dc, c.data(), n_words * 4, cudaMemcpyHostToDevice);
  void* args[] = {&out, &dc, &n_words, (void*)&f};
  for (int B : {32, 128, 512, 2048, 4096, 8192}) {
    const float m32 = run(split_rounds<32>, B * kSplit / 32, 32, n_words * 4, args);
    const float m64 = run(split_rounds<64>, B * kSplit / 64, 64, n_words * 4, args);
    const float m128 = run(split_rounds<128>, B * kSplit / 128, 128, n_words * 4, args);
    printf("[micro] K5 split rounds, %d states: %.4f / %.4f / %.4f ms at 32 / 64 / 128 threads a block\n",
           B, m32, m64, m128);
  }
  return 0;
}
