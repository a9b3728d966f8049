"""Poseidon parameter generation: round constants and Cauchy MDS matrices.

The port's own copy of `openzl_tpu/crypto/poseidon/param_gen.py` (host Python, no JAX).

Host-side cold path over Python ints. Bit-exact with the reference's
sage-verified generation:
  - round constants: Grain LFSR + big-endian rejection sampling
    (reference: openzl-crypto/src/poseidon/round_constants.rs:10-59)
  - MDS: symmetric Cauchy matrix m[x][j] = 1/(x + y_j), x in [0,t), y_j = t+j
    (reference: openzl-crypto/src/poseidon/mds.rs:84-102)

Conformance anchors: tests/vectors/poseidon_lfsr_bls381.json,
tests/vectors/poseidon_mds_bls381.json.
"""

from __future__ import annotations

from typing import Iterator, List

from ...fields.spec import FieldSpec
from .lfsr import GrainLFSR


def generate_lfsr(
    modulus_bits: int, width: int, full_rounds: int, partial_rounds: int
) -> GrainLFSR:
    """Seed layout per the Poseidon paper: field tag, sbox tag, sizes, padding."""
    return GrainLFSR(
        [
            (2, 1),
            (4, 0),
            (12, modulus_bits),
            (12, width),
            (10, full_rounds),
            (10, partial_rounds),
            (30, (1 << 30) - 1),
        ]
    )


def sample_field_element(bits: Iterator[bool], spec: FieldSpec) -> int:
    """Rejection-sample: take MODULUS_BITS bits big-endian until < modulus."""
    n_bits = spec.bits
    while True:
        value = 0
        for _ in range(n_bits):
            value = (value << 1) | int(next(bits))
        if value < spec.modulus:
            return value


def generate_round_constants(
    spec: FieldSpec, width: int, full_rounds: int, partial_rounds: int
) -> List[int]:
    """width * (full_rounds + partial_rounds) constants, row-major by round."""
    lfsr = generate_lfsr(spec.bits, width, full_rounds, partial_rounds)
    return [
        sample_field_element(lfsr, spec)
        for _ in range(width * (full_rounds + partial_rounds))
    ]


def generate_mds(spec: FieldSpec, width: int) -> List[List[int]]:
    """Symmetric Cauchy MDS: rows x in [0, t), columns y in [t, 2t)."""
    p = spec.modulus
    return [
        [pow((x + y) % p, -1, p) for y in range(width, 2 * width)]
        for x in range(width)
    ]
