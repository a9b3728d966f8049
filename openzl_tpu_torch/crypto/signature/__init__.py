"""Signature schemes (reference openzl-crypto/src/signature/mod.rs).

The port's own copy of `openzl_tpu/crypto/signature/__init__.py` (host
Python, no JAX).

`Schnorr` follows the reference construction exactly
(signature/mod.rs:196-430): generic over a group and a hash function
H(vk, nonce_point, message) -> scalar,

  derive(sk)            = sk * G
  sign(sk, r, msg)      = (scalar = r + sk * H(vk, R, msg), nonce_point R = r*G)
  verify(vk, msg, sig)  = sig.scalar * G == R + H(vk, R, msg) * vk

The default hash is Poseidon over the curve's base field with the digest
reduced into the scalar field (the reference leaves H pluggable).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ...ref import poseidon as refposeidon
from ..algebra import CurveGroup


@dataclasses.dataclass(frozen=True)
class PoseidonSchnorrHash:
    """H(vk, R, msg): Poseidon-sponge over base-field elements -> scalar."""

    group: CurveGroup

    def _params(self):
        return refposeidon.PoseidonParams.generate(
            self.group.curve.base, width=3, full_rounds=8, partial_rounds=55
        )

    def hash(self, verifying_key, nonce_point, message: Sequence[int]) -> int:
        params = self._params()
        inputs = [
            verifying_key[0] if verifying_key else 0,
            verifying_key[1] if verifying_key else 0,
            nonce_point[0] if nonce_point else 0,
            nonce_point[1] if nonce_point else 0,
            *message,
        ]
        # absorb pairwise through arity-2 Poseidon (simple Merkle-Damgard)
        acc = 0
        for i in range(0, len(inputs), 2):
            chunk = inputs[i : i + 2]
            if len(chunk) == 1:
                chunk = chunk + [0]
            acc = refposeidon.hash(params, [acc ^ 0, chunk[0]])
            acc = refposeidon.hash(params, [acc, chunk[1]])
        return acc % self.group.curve.scalar.modulus


@dataclasses.dataclass(frozen=True)
class SchnorrSignature:
    scalar: int
    nonce_point: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Schnorr:
    group: CurveGroup
    hash_function: Optional[PoseidonSchnorrHash] = None

    def _h(self) -> PoseidonSchnorrHash:
        return self.hash_function or PoseidonSchnorrHash(self.group)

    def generate_key(self, rng) -> int:
        return self.group.sample_scalar(rng)

    def derive(self, signing_key: int):
        return self.group.scalar_mul(signing_key, self.group.generator())

    def sign(self, signing_key: int, randomness: int, message: Sequence[int]) -> SchnorrSignature:
        r_mod = self.group.curve.scalar.modulus
        nonce_point = self.group.scalar_mul(randomness, self.group.generator())
        vk = self.derive(signing_key)
        h = self._h().hash(vk, nonce_point, message)
        return SchnorrSignature(
            scalar=(randomness + signing_key * h) % r_mod,
            nonce_point=nonce_point,
        )

    def verify(self, verifying_key, message: Sequence[int], sig: SchnorrSignature) -> bool:
        h = self._h().hash(verifying_key, sig.nonce_point, message)
        lhs = self.group.scalar_mul(sig.scalar, self.group.generator())
        rhs = self.group.add(
            sig.nonce_point, self.group.scalar_mul(h, verifying_key)
        )
        return lhs == rhs
