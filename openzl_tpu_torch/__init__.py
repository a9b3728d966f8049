"""openzl_tpu_torch: the Groth16 prover of `openzl_tpu` on PyTorch and CUDA.

A port of the JAX package `openzl_tpu` (which stays the reference) to
PyTorch, with the prover's TPU kernels rewritten by hand in CUDA for the
NVIDIA H100 (`sm_90a`). Module names follow the JAX package:

  fields/        limb arithmetic (`limb`), Fq / Fq2 ops (`ext`)
  ops/           K1/K2 (`ntt_kernel`), NTT, scans, sparse QAP matvec,
                 K3/K4 (`ec_kernel`), MSM
  curves/        batched Jacobian points (`jacobian`)
  eclair/        R1CS constraint system, R1CS compiler, witness calculator
  proof_systems/ Groth16 compile / prove / verify
  utils/build.py nvcc build and ctypes loading of `csrc/*.cu`

Nothing here imports JAX. Host-only modules of the reference that import no
JAX (field and curve specs, `ref/` oracles, `native`, `utils.codec`, the
Poseidon gadget) are imported from `openzl_tpu` directly.
"""

__version__ = "0.1.0"
