"""The port's ratio proofs (`proof_systems/ratio.py`) against the JAX
package's, over BN254 and BLS12-381: from the same challenge, scalar and
`random.Random` seed both give the same ratio (g, r g) and matching point
r H(challenge, ratio), exactly; the proof verifies by the same-ratio
pairing check, and fails under another challenge or another scalar."""

import random

import pytest

from openzl_tpu.proof_systems.ratio import HashToG2 as RefHashToG2
from openzl_tpu.proof_systems.ratio import RatioProof as RefRatioProof
from openzl_tpu.ref import pairing as refpair
from openzl_tpu_torch.proof_systems import BLS12_381, BN254, HashToG2, RatioProof
from openzl_tpu_torch.ref import curve as refc

PAIRINGS = {"bn254": (BN254, refpair.BN254), "bls12_381": (BLS12_381, refpair.BLS12_381)}


@pytest.mark.parametrize("name", sorted(PAIRINGS))
def test_ratio_proof_matches_reference_and_verifies(name):
    pairing, ref_pairing = PAIRINGS[name]
    challenge, seed = b"ceremony round 7", 11
    scalar = random.Random(5).randrange(1, pairing.r)
    proof = RatioProof.prove(pairing, challenge, scalar, random.Random(seed))
    ref = RefRatioProof.prove(ref_pairing, challenge, scalar, random.Random(seed))
    assert proof.ratio == ref.ratio and proof.matching_point == ref.matching_point
    assert HashToG2(pairing).hash(challenge, proof.ratio) == RefHashToG2(ref_pairing).hash(challenge, ref.ratio)
    g, rg = proof.ratio
    assert rg == refc.scalar_mul(pairing.g1, scalar, g)
    assert proof.verify(pairing, challenge)
    assert not proof.verify(pairing, challenge + b"!")
    forged = RatioProof(ratio=proof.ratio, matching_point=refc.scalar_mul(
        pairing.g2, scalar + 1, HashToG2(pairing).hash(challenge, proof.ratio)))
    assert not forged.verify(pairing, challenge)


@pytest.mark.parametrize("name", sorted(PAIRINGS))
def test_ratio_proof_of_zero_is_none_as_the_reference(name):
    pairing, ref_pairing = PAIRINGS[name]
    assert RatioProof.prove(pairing, b"c", 0, random.Random(1)) is None
    assert RefRatioProof.prove(ref_pairing, b"c", 0, random.Random(1)) is None
