// K9's kernel and launch (the design notes are fold_kernel.cu's), generic
// over the word count NW of the base field, the coordinate field and the
// block size. Each translation unit instantiates `fold_launch` for its word
// count: fold_kernel.cu for NW = 8 (BN254), fold_kernel_w12.cu for NW = 12
// (BLS12-381), so nvcc compiles them in parallel.
#pragma once
#include <cuda_runtime.h>

#include "ec.cuh"

// What ozl_fold_madd passes to an instantiation: p, n0, the curve's a
// (has_a), u^2 = beta and Montgomery one of the coordinate field (NW words
// each, 2 NW for a and one over Fq2).
struct FoldArgs {
  const uint32_t* p;
  uint32_t n0;
  int beta;
  int has_a;
  const uint32_t* a;
  const uint32_t* one;
  cudaStream_t st;
};

// the 12-word instantiation (fold_kernel_w12.cu)
int fold_launch_w12(int ext, void** c, int64_t l, int r, int64_t width, const FoldArgs& A);

namespace {

// The fold's point source on the card: each thread's two slots of a ring in
// shared memory, filled by cp.async. A slot is PW + 4 words: 16-byte aligned
// for cp.async, and eight threads' 16-byte reads fall in distinct banks.
template <class T, int THREADS>
struct RingPoints {
  static constexpr int PW = 2 * (int)(sizeof(T) / sizeof(uint32_t));
  static constexpr int STRIDE = PW + 4;
  const uint32_t* pts;
  uint32_t* base;  // this thread's slot 0; slot 1 is THREADS * STRIDE words on
  __device__ const uint32_t* slot(int j) const { return base + (j & 1) * (THREADS * STRIDE); }
  __device__ void fetch(int j, int64_t i) {
    const uint32_t* g = pts + i * PW;
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(slot(j));
#pragma unroll
    for (int v = 0; v < PW / 4; ++v)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s + 16 * v), "l"(g + 4 * v)
                   : "memory");
  }
  __device__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
  __device__ void wait() { asm volatile("cp.async.wait_group 1;" ::: "memory"); }
  __device__ const T& x(int j) const { return *reinterpret_cast<const T*>(slot(j)); }
  __device__ const T& y(int j) const { return *reinterpret_cast<const T*>(slot(j) + PW / 2); }
};

template <class F, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fold_kernel(const int64_t* keys, const int64_t* pidx, int64_t l, int r, const uint32_t* pts,
                int32_t* tx, int32_t* ty, int32_t* tz, uint8_t* tflag, int32_t* bx, int32_t* by,
                int32_t* bz, uint8_t* bflag, int64_t* bchunk, int64_t width, typename F::T one,
                EcParams<F> E) {
  using T = typename F::T;
  using Src = RingPoints<T, THREADS>;
  __shared__ __align__(16) uint32_t ring[2 * THREADS * Src::STRIDE];
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= l) return;
  Src src{pts, ring + threadIdx.x * Src::STRIDE};
  T ax, ay, az;
  const bool started = fold_chunk<F>(E, keys, pidx, l * r, c, r, src, one, bx, by, bz, bflag,
                                     bchunk, width, ax, ay, az);
  store_coord(tx, l, c, ax);
  store_coord(ty, l, c, ay);
  store_coord(tz, l, c, az);
  tflag[c] = started;
}

template <int NW>
Fp<NW> words1(const uint32_t* v) {
  Fp<NW> r;
  for (int i = 0; i < NW; ++i) r.w[i] = v[i];
  return r;
}

template <int NW>
Fp2<NW> words2(const uint32_t* v) {
  return {words1<NW>(v), words1<NW>(v + NW)};
}

template <class F, int THREADS, int MIN_BLOCKS>
int launch_fold(void** c, int64_t l, int r, int64_t width, const typename F::T& one,
                const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (l + THREADS - 1) / THREADS;
  if (blocks > 0)
    fold_kernel<F, THREADS, MIN_BLOCKS><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const int64_t*)c[0], (const int64_t*)c[1], l, r, (const uint32_t*)c[2], (int32_t*)c[3],
        (int32_t*)c[4], (int32_t*)c[5], (uint8_t*)c[6], (int32_t*)c[7], (int32_t*)c[8],
        (int32_t*)c[9], (uint8_t*)c[10], (int64_t*)c[11], width, one, E);
  return (int)cudaGetLastError();
}


// One fold over Fq (EXT 1) or Fq2 (EXT 2) at NW words, in blocks of
// THREADS1 / THREADS2 threads with at least MIN1 / MIN2 resident per SM
template <int NW, int THREADS1, int MIN1, int THREADS2, int MIN2>
int fold_launch(int ext, void** c, int64_t l, int r, int64_t width, const FoldArgs& A) {
  using B = F1c<NW>;
  if (ext == 1)
    return launch_fold<B, THREADS1, MIN1>(c, l, r, width, words1<NW>(A.one),
                                          params1<NW, B>(A.p, A.n0, A.has_a, A.a), A.st);
  return launch_fold<F2<NW, B>, THREADS2, MIN2>(c, l, r, width, words2<NW>(A.one),
                                                params2<NW, B>(A.p, A.n0, A.beta, A.has_a, A.a), A.st);
}

}  // namespace
