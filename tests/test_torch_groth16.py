"""The whole slice against the JAX package: a 1-link Poseidon hash chain
(BN254, 235 constraints), the reference's host backend run once per module.

The port's R1CS rows and assignment equal the reference's; `compile` with
the same `random.Random` gives a byte-identical `ProvingKey.to_bytes`;
proofs from a `from_reference` key and a `from_bytes` key are
byte-identical to the reference's proof; verification accepts and rejects
as the reference does."""

import os
import random

import numpy as np
import pytest
import torch

from openzl_tpu.crypto.poseidon import gadget
from openzl_tpu.proof_systems import Groth16 as RefGroth16
from openzl_tpu.ref import pairing as refpair
from openzl_tpu.ref import poseidon as refposeidon
from openzl_tpu_torch.eclair import circuits
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.proof_systems import BN254, Groth16, PreparedCircuit, ProvingKey

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


SETUP_SEED, PROVE_SEED, WITNESS_SEED = 11, 12, 7


def _build(g16, params, chain, witness, digest):
    com = g16.proof_compiler()
    h_pub = com.public_input(digest)
    h = com.secret_witness(witness[0])
    for i in range(chain):
        h = gadget.hash(com, params, [h, com.secret_witness(witness[1 + i])])
    com.assert_eq(h, h_pub)
    return com.cs


@pytest.fixture(scope="module")
def run():
    ref = RefGroth16(refpair.BN254, backend="host")
    port = Groth16(BN254, "cpu")
    params = refposeidon.PoseidonParams.generate(port.fr, 3, 8, 55)
    rng = random.Random(WITNESS_SEED)
    witness = [rng.randrange(port.fr.modulus) for _ in range(2)]
    digest = refposeidon.hash(params, witness)
    cs_ref = _build(ref, params, 1, witness, digest)
    cs = _build(port, params, 1, witness, digest)
    ref_pk = ref.compile(cs_ref, random.Random(SETUP_SEED))
    ref_proof = ref.prove(ref_pk, cs_ref, random.Random(PROVE_SEED))
    return dict(ref=ref, port=port, cs_ref=cs_ref, cs=cs, digest=digest,
                params=params, witness=witness,
                ref_pk=ref_pk, ref_proof=ref_proof.to_bytes(refpair.BN254))


def test_chain_helper_builds_the_same_circuit(run):
    """`circuits` (the slice's circuit, used by chip_smoke.py) draws the
    same witness and digest and synthesizes the same R1CS as built here."""
    port, cs = run["port"], run["cs"]
    witness, digest = circuits.chain_inputs(run["params"], 1, random.Random(WITNESS_SEED))
    assert (witness, digest) == (run["witness"], run["digest"])
    built = circuits.poseidon_chain(port.proof_compiler(), run["params"], 1, witness, digest)
    assert [(a.terms, b.terms, c.terms) for a, b, c in built.constraints] == [
        (a.terms, b.terms, c.terms) for a, b, c in cs.constraints
    ]
    assert built.assignment() == cs.assignment()


def test_r1cs_rows_and_assignment_match_reference(run):
    cs, cs_ref = run["cs"], run["cs_ref"]
    assert cs.num_constraints == cs_ref.num_constraints == 235
    assert (cs.num_instance, cs.num_witness) == (cs_ref.num_instance, cs_ref.num_witness)
    for (a, b, c), (ra, rb, rc) in zip(cs.constraints, cs_ref.constraints):
        assert (a.terms, b.terms, c.terms) == (ra.terms, rb.terms, rc.terms)
    assert cs.assignment() == cs_ref.assignment()
    assert cs.is_satisfied()
    calc = run["port"].witness_calculator(cs)
    leaves = calc.leaf_values(cs)
    assert calc.evaluate([run["digest"]], leaves, backend="python") == cs.assignment()
    z = calc.evaluate_limbs([run["digest"]], leaves)
    assert np.array_equal(z, limb.pack(run["port"].fr, np.array(cs.assignment(), dtype=object)))


def test_compile_gives_byte_identical_key(run):
    pk = run["port"].compile(run["cs"], random.Random(SETUP_SEED))
    assert pk.to_bytes() == run["ref_pk"].to_bytes()


def test_prepared_matvec_matches_reference_matrices(run):
    port, cs = run["port"], run["cs"]
    ours = port.prepare(cs)
    theirs = PreparedCircuit.from_reference(run["ref"].prepare(run["cs_ref"]))
    z = limb.tensor(limb.pack_mont(port.fr, np.array(cs.assignment(), dtype=object)))
    for name in ("a", "b", "c"):
        got = getattr(ours, name).matvec(z)
        assert np.array_equal(got.numpy(), getattr(theirs, name).matvec(z).numpy())
    rows = [lc for lc, _, _ in cs.constraints]
    want = [cs.eval_lc(lc, cs.assignment()) for lc in rows]
    got = limb.unpack_mont(port.fr, ours.a.matvec(z))[: len(rows)]
    assert list(got) == want


def test_proof_from_reference_key_is_byte_identical(run):
    port = run["port"]
    pk = ProvingKey.from_reference(run["ref_pk"], device="cpu")
    proof = port.prove(pk, run["cs"], random.Random(PROVE_SEED))
    assert proof.to_bytes(port.pairing) == run["ref_proof"]
    assert port.verify(pk.vk, [run["digest"]], proof)
    assert not port.verify(pk.vk, [run["digest"] + 1], proof)
    assert run["ref"].verify(run["ref_pk"].vk, [run["digest"]], proof)


def test_proof_from_bytes_key_is_byte_identical(run):
    port, cs = run["port"], run["cs"]
    pk = ProvingKey.from_bytes(port.pairing, run["ref_pk"].to_bytes(), validate=False, device="cpu")
    calc = port.witness_calculator(cs)
    z = calc.evaluate_limbs([run["digest"]], calc.leaf_values(cs))
    proof = port.prove_assigned(pk, z, random.Random(PROVE_SEED), prepared=port.prepare(cs))
    assert proof.to_bytes(port.pairing) == run["ref_proof"]
    assert [name for name, _ in port.laps["prove"]] == [
        "pack_witness", "qap_matvec", "h_poly_ntts", "msm_kernels", "msm_readback", "finalize"
    ]
