"""The port's mesh and staged Groth16 provers against the JAX package's
proof bytes, on a small BN254 circuit (an S-box, products, an equality and
a bit decomposition: fewer than 512 variables, so the JAX `Groth16(BN254)`
compiles a host-form key with its oracle).

The mesh proof runs on gloo ranks on the CPU (`RankPool`, started once per
module, one torch thread a rank, each run under a deadline): every rank
lifts the reference key's bytes onto its device and proves with the same
seeded rng, and at 2 and 4 ranks every rank's proof must equal the
reference's bytes. The staged prover (`offload_queries`) must give the same
bytes, and a staged JAX key stays staged through `from_reference`. All
comparisons are exact (proof and key bytes)."""

import dataclasses
import os
import random

import pytest
import torch

from openzl_tpu.proof_systems import Groth16 as RefGroth16
from openzl_tpu.ref import pairing as refpair
from openzl_tpu_torch.parallel.launch import RankPool
from openzl_tpu_torch.proof_systems import BN254, Groth16, ProvingKey
from openzl_tpu_torch.proof_systems.groth16 import AUTO_HOST_VARS

import torch_mesh_tasks as tasks

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SETUP_SEED, PROVE_SEED, WITNESS_SEED = 41, 42, 43
WORLD = 4
DEADLINE = 240


@dataclasses.dataclass(frozen=True)
class _SizeOnly:
    """A mesh the prover never reaches: `_prove_z` reads its size and sets
    it aside (a host key, or a domain no larger than the mesh) or refuses
    it (a staged key) before any collective."""

    size: int


@pytest.fixture(scope="module")
def run():
    ref = RefGroth16(refpair.BN254)
    p = BN254.r
    rng = random.Random(WITNESS_SEED)
    x, w = rng.randrange(p), rng.randrange(p)
    digest = (pow(w, 5, p) * x + w) % p
    cs_ref = tasks.build_circuit(ref.proof_compiler(), x, w, digest)
    assert cs_ref.num_variables < AUTO_HOST_VARS
    ref_pk = ref.compile(cs_ref, random.Random(SETUP_SEED))
    assert ref_pk.host
    ref_proof = ref.prove(ref_pk, cs_ref, random.Random(PROVE_SEED)).to_bytes(refpair.BN254)
    g16 = Groth16(BN254, "cpu")
    cs = tasks.build_circuit(g16.proof_compiler(), x, w, digest)
    host = ProvingKey.from_reference(ref_pk, "cpu", backend="host")
    return dict(ref=ref, cs_ref=cs_ref, ref_pk=ref_pk, ref_proof=ref_proof, g16=g16, cs=cs, host=host,
                public=[x, digest], w=w)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, "gloo", tmp_path_factory.mktemp("store"), devices=["cpu"] * WORLD,
                  timeout=DEADLINE) as p:
        yield p


@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_proof_matches_reference_on_every_rank(run, pool, ranks):
    """The six H-polynomial transforms and the four MSM calls go through
    `parallel.ops` (counted on each rank), and every rank's proof equals
    the JAX package's bytes; it verifies and a fuzzed input fails."""
    key = run["ref_pk"].to_bytes()
    out = pool.run(tasks.groth16_prove, ranks, key, run["public"], run["w"], PROVE_SEED, "cpu")
    assert out[ranks:] == [None] * (WORLD - ranks)
    for o in out[:ranks]:
        assert o["proof"] == run["ref_proof"]
        assert o["calls"]["sharded_msm_multi"] == 1 and o["calls"]["sharded_msm"] == 2
        assert o["calls"]["sharded_coset_intt"] == 1 and o["calls"]["sharded_transform"] >= 6
    g16, pk = run["g16"], run["host"]
    from openzl_tpu_torch.proof_systems.groth16 import Proof

    proof = Proof.from_bytes(BN254, out[0]["proof"])
    x, digest = run["public"]
    assert g16.verify(pk.vk, [x, digest], proof)
    assert not g16.verify(pk.vk, [x, digest + 1], proof)


def test_mesh_is_set_aside_for_a_host_key_and_a_small_domain(run):
    """As the reference: a host-form key, or a domain of at most the mesh's
    size, proves on one device (the same bytes), whatever the mesh."""
    g16, cs = Groth16(BN254, "cpu", backend="host"), run["cs"]
    assert g16.prove(run["host"], cs, random.Random(PROVE_SEED), mesh=_SizeOnly(4)).to_bytes(BN254) \
        == run["ref_proof"]
    dk = run["g16"].device_key(run["host"], cs)
    big = _SizeOnly(1 << dk.domain_log2)
    assert run["g16"].prove(dk, cs, random.Random(PROVE_SEED), mesh=big).to_bytes(BN254) == run["ref_proof"]


def test_staged_proof_matches_and_a_second_verifies(run):
    """`offload_queries` moves the five query tables to host numpy; the
    staged prove (one query on the device per MSM, each QAP matrix's device
    copy freed after its matvec) gives the reference's bytes, a second
    staged prove verifies, and a staged key refuses a mesh."""
    g16, cs = run["g16"], run["cs"]
    dk = g16.device_key(run["host"], cs)
    staged = dk.offload_queries()
    assert staged.staged and not dk.staged and staged.device is None
    assert staged.offload_queries() is staged
    assert staged.to_bytes() == run["ref_pk"].to_bytes()
    rng = random.Random(PROVE_SEED)
    assert g16.prove(staged, cs, rng).to_bytes(BN254) == run["ref_proof"]
    assert not staged.prepared.a._dev  # each matrix's device copy dropped after its matvec
    again = g16.prove(staged, cs, rng)
    x, digest = run["public"]
    assert g16.verify(staged.vk, [x, digest], again)
    assert not g16.verify(staged.vk, [x, digest + 1], again)
    with pytest.raises(ValueError, match="exclusive"):
        g16.prove(staged, cs, random.Random(0), mesh=_SizeOnly(2))


def test_from_reference_keeps_a_staged_key_staged(run):
    """A JAX device key offloaded to numpy (`offload_queries`) comes across
    staged, its queries still on the host, and proves the same bytes."""
    ref_staged = run["ref"].device_key(run["ref_pk"], run["cs_ref"]).offload_queries()
    assert ref_staged.staged
    pk = ProvingKey.from_reference(ref_staged, "cpu")
    assert pk.staged and not pk.host and pk.prepared is not None
    assert pk.to_bytes() == run["ref_pk"].to_bytes()
    proof = run["g16"].prove(pk, run["cs"], random.Random(PROVE_SEED))
    assert proof.to_bytes(BN254) == run["ref_proof"]
