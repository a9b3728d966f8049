"""The port's Groth16 host backend against the JAX package's, on a small
BN254 circuit (an S-box, products, an equality and a bit decomposition:
19 variables, below the 512 at which "auto" turns to the device backend).
`Groth16(BN254, backend="host")` gives the reference's `ProvingKey`, `VerifyingKey` and `Proof` bytes from the same
seeded rng; `device_key` lifts the host key and proves the same bytes on
the device backend; `from_reference` keeps a host-form key in host form."""

import os
import random

import pytest
import torch

from openzl_tpu.proof_systems import Groth16 as RefGroth16
from openzl_tpu.ref import pairing as refpair
from openzl_tpu_torch.eclair import R1CS
from openzl_tpu_torch.proof_systems import BN254, Groth16, ProvingKey
from openzl_tpu_torch.proof_systems.groth16 import AUTO_HOST_VARS

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SETUP_SEED, PROVE_SEED, WITNESS_SEED = 21, 22, 23


def _build(g16, x, w, digest):
    """digest = w^5 x + w with x and digest public, and w's low byte
    decomposed; the same gadget calls on either package's compiler."""
    com = g16.proof_compiler()
    xv, h_pub = com.public_input(x), com.public_input(digest)
    wv = com.secret_witness(w)
    h = com.add(com.mul(com.pow5(wv), xv), wv)
    com.assert_eq(h, h_pub)
    low = com.secret_witness(w % 256)
    com.to_bits_le(low, 8)
    com.assert_eq(com.is_eq(low, com.constant(w % 256)), com.constant(1))
    return com.cs


@pytest.fixture(scope="module")
def run():
    ref = RefGroth16(refpair.BN254, backend="host")
    port = Groth16(BN254, "cpu", backend="host")
    p = port.fr.modulus
    rng = random.Random(WITNESS_SEED)
    x, w = rng.randrange(p), rng.randrange(p)
    digest = (pow(w, 5, p) * x + w) % p
    cs_ref, cs = _build(ref, x, w, digest), _build(port, x, w, digest)
    assert cs.assignment() == cs_ref.assignment() and cs.is_satisfied()
    ref_pk = ref.compile(cs_ref, random.Random(SETUP_SEED))
    ref_proof = ref.prove(ref_pk, cs_ref, random.Random(PROVE_SEED))
    pk = port.compile(cs, random.Random(SETUP_SEED))
    proof = port.prove(pk, cs, random.Random(PROVE_SEED))
    return dict(port=port, cs=cs, public=[x, digest], ref_pk=ref_pk, pk=pk,
                ref_proof=ref_proof.to_bytes(refpair.BN254), proof=proof)


def test_host_key_bytes_match_reference(run):
    pk, ref_pk = run["pk"], run["ref_pk"]
    assert run["cs"].num_variables < AUTO_HOST_VARS
    assert pk.host and ref_pk.host and pk.prepared is None and pk.device is None
    assert isinstance(pk.a_query, list) and len(pk.a_query) == run["cs"].num_variables
    assert pk.vk.to_bytes() == ref_pk.vk.to_bytes()
    assert pk.to_bytes() == ref_pk.to_bytes()
    assert pk.to_bytes(compressed=True) == ref_pk.to_bytes(compressed=True)


def test_host_proof_bytes_match_reference_and_verify(run):
    port, proof, (x, digest) = run["port"], run["proof"], run["public"]
    assert proof.to_bytes(BN254) == run["ref_proof"]
    assert port.verify(run["pk"].vk, [x, digest], proof)
    assert not port.verify(run["pk"].vk, [x, digest + 1], proof)
    with pytest.raises(ValueError, match="host-form key"):
        port.prove_assigned(run["pk"], [1] * run["cs"].num_variables, random.Random(0))


def test_device_key_proves_the_same_bytes(run):
    """The host key lifted onto the CPU's device backend (query tables as
    Jacobian limb tensors, the QAP matrices prepared from the circuit)."""
    dev = Groth16(BN254, "cpu")
    dk = dev.device_key(run["pk"], run["cs"])
    assert not dk.host and dk.device == torch.device("cpu") and dk.prepared is not None
    assert dev.device_key(dk) is dk
    assert dk.to_bytes() == run["ref_pk"].to_bytes()
    proof = dev.prove(dk, run["cs"], random.Random(PROVE_SEED))
    assert proof.to_bytes(BN254) == run["ref_proof"]
    assert dev.verify(dk.vk, run["public"], proof)
    with pytest.raises(ValueError, match="needs the circuit"):
        dev.device_key(run["pk"])


def test_from_reference_keeps_host_form(run):
    ref_pk = run["ref_pk"]
    host = ProvingKey.from_reference(ref_pk, "cpu", backend="host")
    assert host.host and host.a_query == list(ref_pk.a_query)
    assert host.to_bytes() == ref_pk.to_bytes()
    lifted = ProvingKey.from_reference(ref_pk, "cpu")
    assert not lifted.host and lifted.to_bytes() == ref_pk.to_bytes()


def _tiny():
    """x * y = z with z public: 4 variables."""
    g16 = Groth16(BN254, "cpu", backend="auto")
    com = g16.proof_compiler()
    z = com.public_input(6)
    com.assert_eq(com.mul(com.secret_witness(2), com.secret_witness(3)), z)
    return com.cs


@pytest.mark.parametrize("backend,host", [("auto", True), ("host", True), ("device", False)])
def test_backend_choice(backend, host):
    """Which backend compiles; the host-form keys also prove (a device key
    of this circuit is the device path's own tests' business)."""
    cs: R1CS = _tiny()
    g16 = Groth16(BN254, "cpu", backend=backend)
    assert g16._use_host(cs.num_variables) == host
    assert g16._use_host(AUTO_HOST_VARS - 1) == host
    assert g16._use_host(AUTO_HOST_VARS) == (backend == "host")
    if not host:
        return
    pk = g16.compile(cs, random.Random(1))
    assert pk.host == host
    proof = g16.prove(pk, cs, random.Random(2))
    assert g16.verify(pk.vk, [6], proof) and not g16.verify(pk.vk, [7], proof)


def test_groth16_defaults():
    with pytest.raises(ValueError, match="backend"):
        Groth16(BN254, "cpu", backend="tpu")
    assert Groth16(BN254, "cpu").backend == "device"
    g16 = Groth16(BN254)
    assert g16.device.type == "cuda"
    if not torch.cuda.is_available():
        # the device backend needs the card: no quiet fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            g16.compile(_tiny(), random.Random(1))
