"""Field specifications for the TPU-native ZK framework.

The port's own copy of `openzl_tpu/fields/spec.py` (host Python, no JAX).

A :class:`FieldSpec` carries everything the limb-decomposed kernels need to do
arithmetic in a prime field on TPU: the modulus, the limb decomposition
(16-bit limbs packed in ``uint32`` lanes), and the Montgomery-domain constants.

Design notes (TPU-first, no counterpart in the reference):
  * TPUs have no 64-bit integer multiplier. We use 16-bit limbs stored in
    ``uint32`` so a limb product is exact in 32 bits and column accumulations
    of up to ~2^6 partial products stay well below 2^32 (see
    ``openzl_tpu.fields.limb``).
  * Montgomery radix R = 2^(16 * n_limbs); elements in hot loops live in
    Montgomery form, canonical form only at serialization boundaries, matching
    arkworks' convention (reference: plugins/arkworks wraps ark-ff Montgomery
    bigints, SURVEY.md section 2.8).

Reference parity: field moduli match the arkworks curve configs used by the
reference (plugins/arkworks/Cargo.toml bn254 / bls12-381 features).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """A prime field with its limb decomposition and Montgomery constants."""

    name: str
    modulus: int

    @property
    def bits(self) -> int:
        """Number of bits of the modulus (arkworks `MODULUS_BITS`)."""
        return self.modulus.bit_length()

    @property
    def n_limbs(self) -> int:
        return -(-self.bits // LIMB_BITS)

    @property
    def n_bytes(self) -> int:
        """Serialized size: arkworks serializes in 64-bit limb granularity."""
        return -(-self.bits // 64) * 8

    @property
    def R(self) -> int:  # noqa: N802 - standard Montgomery notation
        return (1 << (LIMB_BITS * self.n_limbs)) % self.modulus

    @property
    def R2(self) -> int:  # noqa: N802
        return self.R * self.R % self.modulus

    @property
    def n0inv(self) -> int:
        """-modulus^{-1} mod 2^16 (per-limb Montgomery factor)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    # ------------------------------------------------------------------
    # numpy limb-constant views used by the jnp kernels
    # ------------------------------------------------------------------

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.n_limbs)

    @functools.cached_property
    def r_limbs(self) -> np.ndarray:
        """Montgomery form of one."""
        return int_to_limbs(self.R, self.n_limbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2, self.n_limbs)

    def to_mont(self, x: int) -> int:
        return x * self.R % self.modulus

    def from_mont(self, x: int) -> int:
        return x * pow(self.R, -1, self.modulus) % self.modulus


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian 16-bit limb decomposition as a uint32 vector of shape (n,)."""
    assert 0 <= x < 1 << (LIMB_BITS * n_limbs)
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)], dtype=np.uint32
    )


def limbs_to_int(limbs) -> int:
    """Inverse of :func:`int_to_limbs` (limb axis first)."""
    out = 0
    for i, limb in enumerate(np.asarray(limbs, dtype=np.uint64)):
        out += int(limb) << (LIMB_BITS * i)
    return out


# ---------------------------------------------------------------------------
# Field registry
# ---------------------------------------------------------------------------

#: BN254 (alt_bn128) scalar field; reference: arkworks `bn254::Fr`.
BN254_FR = FieldSpec(
    "bn254_fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
)

#: BN254 base field; reference: arkworks `bn254::Fq`.
BN254_FQ = FieldSpec(
    "bn254_fq",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
)

#: BLS12-381 scalar field; reference: arkworks `bls12_381::Fr`.
BLS12_381_FR = FieldSpec(
    "bls12_381_fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
)

#: BLS12-381 base field; reference: arkworks `bls12_381::Fq`.
BLS12_381_FQ = FieldSpec(
    "bls12_381_fq",
    0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
)
