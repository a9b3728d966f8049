"""COM-generic Schnorr over an embedded Edwards curve.

The port's own copy of `openzl_tpu/crypto/signature/schnorr.py` (host
Python, no JAX).

The reference's Schnorr (openzl-crypto/src/signature/mod.rs:196-330) is
generic over the computational context, so the SAME verification code runs
natively and inside a circuit. This module reproduces that: `verify_gadget`
takes any compiler (`NativeCompiler` / `TorchCompiler` / `R1CSCompiler`) and
the native `verify` simply runs it under the native compiler — one source of
truth, no native/circuit disparity by construction
(docs/src/native_nonnative.md design rule).

Construction (signature/mod.rs:228-330):
  derive(sk)       = sk * G
  sign(sk, r, m)   = (s = r + c * sk  mod order,  R = r * G)
  verify(vk, m, s) = s * G == R + c * vk
with challenge c = Poseidon_arity5(vk.x, vk.y, R.x, R.y, m) over the curve's
base field (a single width-6 permutation — replaces round 1's ad-hoc
two-at-a-time hash; the reference leaves H pluggable).

Scalar-bit caveat: c is a base-field element used as a scalar through its
full-width bit decomposition; k * P for k up to 2^field_bits is well-defined
and equals (k mod order) * P, which is exactly how the native side reduces.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

from ...curves import edwards as ed
from ...curves.edwards import EdwardsSpec
from ...eclair.compilers import NativeCompiler
from ...ref import poseidon as refposeidon
from .. import ec_gadget as ecg
from ..ec_gadget import FixedBaseTable, PointVar
from ..poseidon import gadget as poseidon_gadget


@dataclasses.dataclass(frozen=True)
class EdSchnorrSignature:
    scalar: int
    nonce_point: ed.Point


@functools.lru_cache(maxsize=None)
def _challenge_params(spec: EdwardsSpec):
    """Width-6 (arity-5) Poseidon over the curve base field."""
    return refposeidon.PoseidonParams.generate(
        spec.base, width=6, full_rounds=8, partial_rounds=56
    )


@functools.lru_cache(maxsize=None)
def _gen_table(spec: EdwardsSpec, window_bits: int = 3) -> FixedBaseTable:
    return FixedBaseTable.build(spec, spec.gen, window_bits)


def challenge_gadget(com, spec: EdwardsSpec, vk: PointVar, R: PointVar, msg) -> object:
    """c = Poseidon5(vk.x, vk.y, R.x, R.y, m) — COM-generic."""
    params = _challenge_params(spec)
    return poseidon_gadget.hash(com, params, [vk.x, vk.y, R.x, R.y, msg])


def verify_gadget(
    com,
    spec: EdwardsSpec,
    vk: PointVar,
    msg,
    s_bits: Sequence,
    R: PointVar,
) -> None:
    """Assert s*G == R + c*vk in any compiler.

    s_bits: little-endian bits of the signature scalar (spec.scalar_bits of
    them — allocate via ec_gadget.scalar_bits or com.to_bits_le).
    """
    c = challenge_gadget(com, spec, vk, R, msg)
    c_bits = com.to_bits_le(c, spec.base.bits)
    lhs = ecg.fixed_base_scalar_mul(com, _gen_table(spec), s_bits)
    rhs = ecg.add_points(com, spec, R, ecg.scalar_mul(com, spec, c_bits, vk))
    com.assert_eq(lhs.x, rhs.x)
    com.assert_eq(lhs.y, rhs.y)


@dataclasses.dataclass(frozen=True)
class EdSchnorr:
    """Native key lifecycle + sign, with verify running the COM gadget."""

    spec: EdwardsSpec

    def generate_key(self, rng) -> int:
        return rng.randrange(1, self.spec.order)

    def derive(self, signing_key: int) -> ed.Point:
        return ed.scalar_mul(self.spec, signing_key, self.spec.gen)

    def _challenge(self, vk: ed.Point, R: ed.Point, msg: int) -> int:
        com = NativeCompiler(self.spec.base)
        return challenge_gadget(
            com, self.spec, PointVar(*vk), PointVar(*R), com.constant(msg)
        )

    def sign(self, signing_key: int, randomness: int, msg: int) -> EdSchnorrSignature:
        spec = self.spec
        r = randomness % spec.order
        R = ed.scalar_mul(spec, r, spec.gen)
        vk = self.derive(signing_key)
        c = self._challenge(vk, R, msg)
        return EdSchnorrSignature(
            scalar=(r + c * signing_key) % spec.order, nonce_point=R
        )

    def verify(self, vk: ed.Point, msg: int, sig: EdSchnorrSignature) -> bool:
        """Runs verify_gadget under the native compiler (assert-based)."""
        com = NativeCompiler(self.spec.base)
        s_bits = com.to_bits_le(sig.scalar, self.spec.scalar_bits)
        try:
            verify_gadget(
                com,
                self.spec,
                PointVar(*vk),
                com.constant(msg),
                s_bits,
                PointVar(*sig.nonce_point),
            )
            return True
        except AssertionError:
            return False


def verification_circuit(
    com,
    spec: EdwardsSpec,
    vk: Optional[ed.Point] = None,
    msg: Optional[int] = None,
    sig: Optional[EdSchnorrSignature] = None,
):
    """Build the standard "I know a valid signature" circuit: public vk and
    message, secret signature. Usable for setup (all None) and proving."""
    vk_var = ecg.alloc_point(com, spec, vk, public=True)
    msg_var = com.public_input(msg)
    s_bits = ecg.scalar_bits(
        com, spec, None if sig is None else sig.scalar
    )
    R = ecg.alloc_point(
        com, spec, None if sig is None else sig.nonce_point
    )
    verify_gadget(com, spec, vk_var, msg_var, s_bits, R)
    return com
