"""openzl_tpu_torch: `openzl_tpu` on PyTorch and CUDA (Groth16 prover, Poseidon
hashing and the Merkle tree).

A port of the JAX package `openzl_tpu` (which stays the reference) to
PyTorch, with the TPU kernels rewritten by hand in CUDA for the NVIDIA
H100 (`sm_90a`). Entry points run on `cuda` unless the caller passes
`device="cpu"`, where every kernel runs its plain torch version. Module
names follow the JAX package:

  fields/        limb arithmetic (`limb`), Fq / Fq2 ops (`ext`), specs
  ops/           K1/K2 (`ntt_kernel`), NTT, scans, sparse QAP matvec,
                 K3/K4 (`ec_kernel`), MSM, K5/K6 (`poseidon_kernel`),
                 K7 (`poseidon2_kernel`)
  curves/        batched Jacobian points (`jacobian`), curve specs
  crypto/        Poseidon and Poseidon2 permutations and hashes, the
                 Merkle tree and batched path verification
  eclair/        R1CS constraint system, R1CS compiler, witness calculator
  proof_systems/ Groth16 compile / prove / verify
  ref/           pure-Python oracles (fields, curves, pairing, Poseidon)
  native.py      ctypes loader of the repository's `native/` C++ library
  utils/         nvcc build and ctypes loading of `csrc/*.cu`, codec,
                 profiler

Nothing here imports JAX or the JAX package: the host-only modules the port
needs (specs, oracles, codec, native loader, Poseidon parameter generation)
are the port's own copies, under the same relative names.
"""

__version__ = "0.1.0"
