"""Pairing-based ratio proofs of knowledge, the setup ceremony's primitive.

Port of `openzl_tpu/proof_systems/ratio.py`, on the port's own host
oracles (`ref/curve.py`, `ref/pairing.py`) over BN254 and BLS12-381.
Prove knowledge of a scalar r via

  ratio          = (g, r g)          for a random G1 point g
  matching_point = r H(challenge, ratio)   in G2

verified by the same-ratio pairing check e(g, r h) == e(r g, h).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

from ..ref import curve as refc
from ..ref import pairing as refpair
from ..ref.pairing import PairingSpec


@dataclasses.dataclass(frozen=True)
class HashToG2:
    """SHA-512(challenge, ratio bytes) -> scalar -> scalar G2. Any
    deterministic map serves the same-ratio check; this is the
    reference's, so both packages hash to the same point."""

    pairing: PairingSpec

    def hash(self, challenge: bytes, ratio) -> Tuple:
        h = hashlib.sha512()
        h.update(challenge)
        nb = self.pairing.g1.base.n_bytes
        for pt in ratio:
            if pt is None:
                h.update(b"\x00" * 32)
            else:
                h.update(int(pt[0]).to_bytes(nb, "little"))
                h.update(int(pt[1]).to_bytes(nb, "little"))
        k = int.from_bytes(h.digest(), "little") % self.pairing.r
        if k == 0:
            k = 1
        return refc.scalar_mul(self.pairing.g2, k, refc.generator(self.pairing.g2))


@dataclasses.dataclass(frozen=True)
class RatioProof:
    ratio: Tuple  # (g, r g) affine G1
    matching_point: Tuple  # r h affine G2

    @classmethod
    def prove(cls, pairing: PairingSpec, challenge: bytes, scalar: int, rng) -> Optional["RatioProof"]:
        """The proof for `scalar`, g drawn from `rng` (a `random.Random`);
        None where a point is the identity."""
        g1 = pairing.g1
        k = rng.randrange(1, pairing.r)
        g = refc.scalar_mul(g1, k, refc.generator(g1))
        rg = refc.scalar_mul(g1, scalar, g)
        if g is None or rg is None:
            return None
        h = HashToG2(pairing).hash(challenge, (g, rg))
        rh = refc.scalar_mul(pairing.g2, scalar, h)
        if h is None or rh is None:
            return None
        return cls(ratio=(g, rg), matching_point=rh)

    def verify(self, pairing: PairingSpec, challenge: bytes) -> bool:
        """Same ratio: e(g, r h) == e(r g, h)."""
        g, rg = self.ratio
        h = HashToG2(pairing).hash(challenge, (g, rg))
        return refpair.pairing_product_is_one(
            pairing, [(g, self.matching_point), (refc.neg(pairing.g1, rg), h)],
        )
