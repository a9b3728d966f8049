// K3: batched Jacobian point addition (add-2007-bl, or madd-2007-bl with an
// affine second operand), and K4: batched doubling (dbl-2009-l, or the
// generic-a double M = 3X^2 + a Z^4), over Fq (G1) or Fq2 (G2).
//
// Replace openzl_tpu/ops/ec_kernel.py `_make_add_kernel` (:288, mixed =
// False/True, through `ec_op("add"|"madd")` :622) and `_make_dbl_kernel`
// (:314, through `ec_op("dbl")`). The formulas and the special-case masks
// are those of `_k_ec_double` / `_add_core` (:193-272): doubling when
// P = Q, the identity (X = Y = 1, Z = 0) when P = -Q, pass-through when
// either input is the identity (Z = 0). Jacobian outputs are therefore
// bit-equal to the reference kernels.
//
// One thread per point: the group law is a long dependent chain of field
// operations on a few hundred bits of state, so the whole formula runs in
// registers and each coordinate is read and written once, coalesced across
// threads (limb-planar layout). Bound on the card: integer multiplies
// (~16 Montgomery products per G1 add, three times that over Fq2) and
// register pressure, which for G2 may spill to local memory; 128-thread
// blocks keep enough warps resident per SM to hide that latency.
//
// Instantiated for 16-limb base fields (BN254, and the other 256-bit
// curves); a 24-limb instantiation (BLS12-381) builds too but more than
// doubles the build time, so it waits until a path needs it.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

template <class F, bool MIXED>
__global__ void __launch_bounds__(128)
    ec_add_kernel(const int32_t* x1, const int32_t* y1, const int32_t* z1, const int32_t* x2,
                  const int32_t* y2, const int32_t* z2, int32_t* x3, int32_t* y3, int32_t* z3,
                  int64_t N, EcParams<F> E) {
  using T = typename F::T;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  T* tag = nullptr;
  T X1 = load_coord(x1, N, i, tag), Y1 = load_coord(y1, N, i, tag), Z1 = load_coord(z1, N, i, tag);
  T X2 = load_coord(x2, N, i, tag), Y2 = load_coord(y2, N, i, tag), Z2 = load_coord(z2, N, i, tag);
  T X3, Y3, Z3;
  ec_add<F, MIXED>(E, X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3);
  store_coord(x3, N, i, X3);
  store_coord(y3, N, i, Y3);
  store_coord(z3, N, i, Z3);
}

template <class F>
__global__ void __launch_bounds__(128)
    ec_dbl_kernel(const int32_t* x1, const int32_t* y1, const int32_t* z1, int32_t* x3,
                  int32_t* y3, int32_t* z3, int64_t N, EcParams<F> E) {
  using T = typename F::T;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  T* tag = nullptr;
  T X1 = load_coord(x1, N, i, tag), Y1 = load_coord(y1, N, i, tag), Z1 = load_coord(z1, N, i, tag);
  T X3, Y3, Z3;
  ec_dbl<F>(E, X1, Y1, Z1, X3, Y3, Z3);
  store_coord(x3, N, i, X3);
  store_coord(y3, N, i, Y3);
  store_coord(z3, N, i, Z3);
}

const int kThreads = 128;

template <class F>
int launch_add(int mixed, void** c, int64_t N, const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto in = (const int32_t**)c;
    auto out = (int32_t**)c;
    if (mixed)
      ec_add_kernel<F, true><<<(unsigned)blocks, kThreads, 0, st>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], out[6], out[7], out[8], N, E);
    else
      ec_add_kernel<F, false><<<(unsigned)blocks, kThreads, 0, st>>>(
          in[0], in[1], in[2], in[3], in[4], in[5], out[6], out[7], out[8], N, E);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_dbl(void** c, int64_t N, const EcParams<F>& E, cudaStream_t st) {
  int64_t blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0) {
    auto in = (const int32_t**)c;
    auto out = (int32_t**)c;
    ec_dbl_kernel<F><<<(unsigned)blocks, kThreads, 0, st>>>(in[0], in[1], in[2], out[3], out[4],
                                                           out[5], N, E);
  }
  return (int)cudaGetLastError();
}

template <int NW>
int dispatch_add(int mixed, int ext, void** c, int64_t N, const uint32_t* p, uint32_t n0,
                 int beta, int has_a, const uint32_t* a, cudaStream_t st) {
  if (ext == 1) return launch_add(mixed, c, N, params1<NW>(p, n0, has_a, a), st);
  return launch_add(mixed, c, N, params2<NW>(p, n0, beta, has_a, a), st);
}

template <int NW>
int dispatch_dbl(int ext, void** c, int64_t N, const uint32_t* p, uint32_t n0, int beta,
                 int has_a, const uint32_t* a, cudaStream_t st) {
  if (ext == 1) return launch_dbl(c, N, params1<NW>(p, n0, has_a, a), st);
  return launch_dbl(c, N, params2<NW>(p, n0, beta, has_a, a), st);
}

}  // namespace

extern "C" int ozl_ec_add(int mixed, int ext, void* x1, void* y1, void* z1, void* x2, void* y2,
                          void* z2, void* x3, void* y3, void* z3, int64_t N, int n_limbs,
                          const void* p, uint32_t n0, int beta, int has_a, const void* a,
                          void* stream) {
  void* c[9] = {x1, y1, z1, x2, y2, z2, x3, y3, z3};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  cudaStream_t st = (cudaStream_t)stream;
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;
  if (n_limbs != 16) return (int)cudaErrorInvalidValue;
  return dispatch_add<8>(mixed, ext, c, N, pw, n0, beta, has_a, aw, st);
}

extern "C" int ozl_ec_dbl(int ext, void* x1, void* y1, void* z1, void* x3, void* y3, void* z3,
                          int64_t N, int n_limbs, const void* p, uint32_t n0, int beta, int has_a,
                          const void* a, void* stream) {
  void* c[6] = {x1, y1, z1, x3, y3, z3};
  const uint32_t* pw = (const uint32_t*)p;
  const uint32_t* aw = (const uint32_t*)a;
  cudaStream_t st = (cudaStream_t)stream;
  if (ext != 1 && ext != 2) return (int)cudaErrorInvalidValue;
  if (n_limbs != 16) return (int)cudaErrorInvalidValue;
  return dispatch_dbl<8>(ext, c, N, pw, n0, beta, has_a, aw, st);
}
