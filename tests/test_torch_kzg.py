"""The port's KZG (`openzl_tpu_torch.proof_systems.kzg`, device backend on
the CPU) against the JAX package's host-backend KZG (pure Python, no JAX
compile) with the same `random.Random` draws: setup bytes, commit, open,
verify, batch_verify, and the `from_bytes` / `from_reference` converters.
Every comparison is exact (affine ints, bytes, booleans)."""

import os
import random

import torch

from openzl_tpu.proof_systems import KZG as RefKZG
from openzl_tpu.ref import pairing as ref_pairing
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.proof_systems import BN254, KZG, KZGParams

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DEGREE = 8


def test_kzg_device_matches_reference_host():
    kzg = KZG(BN254, backend="device", device="cpu")
    ref_kzg = RefKZG(ref_pairing.BN254, backend="host")
    params = kzg.setup(DEGREE, random.Random(5))
    ref_params = ref_kzg.setup(DEGREE, random.Random(5))
    assert not params.host and ref_params.host
    assert params.to_bytes() == ref_params.to_bytes()

    rng = random.Random(6)
    r = BN254.r
    coeffs = [rng.randrange(r) for _ in range(DEGREE + 1)]
    C = kzg.commit(params, coeffs)
    assert C == ref_kzg.commit(ref_params, coeffs)
    claims = []
    for z in (rng.randrange(r), rng.randrange(r)):
        v, w = kzg.open(params, coeffs, z)
        assert (v, w) == ref_kzg.open(ref_params, coeffs, z)
        claims.append((C, z, v, w))
    C0, z0, v0, w0 = claims[0]
    assert kzg.verify(params, C0, z0, v0, w0)
    assert not kzg.verify(params, C0, z0, (v0 + 1) % r, w0)
    bad = [(C0, z0, (v0 + 1) % r, w0), claims[1]]
    for batch, want in ((claims, True), (bad, False)):
        got = kzg.batch_verify(params, batch, random.Random(7))
        assert got == ref_kzg.batch_verify(ref_params, batch, random.Random(7)) == want
    # the zero and the constant polynomial: identity commitments and witnesses
    assert kzg.commit(params, [0, 0]) is None and kzg.open(params, [3], z0) == (3, None)


def test_kzg_params_converters_match():
    """`from_bytes` + `device_params`, and `from_reference` of the JAX
    package's host-form and device-form params, give the setup's powers."""
    kzg = KZG(BN254, backend="device", device="cpu")
    ref_kzg = RefKZG(ref_pairing.BN254, backend="host")
    params = kzg.setup(DEGREE, random.Random(8))
    ref_params = ref_kzg.setup(DEGREE, random.Random(8))
    want = jac.to_affine_ints(BN254.g1, params.powers_g1)
    loaded = KZGParams.from_bytes(BN254, params.to_bytes())
    assert loaded.host and loaded.max_degree == DEGREE and loaded.powers_g1 == want
    lifted = kzg.device_params(loaded)
    assert not lifted.host and jac.to_affine_ints(BN254.g1, lifted.powers_g1) == want
    host = KZGParams.from_reference(ref_params, device="cpu")
    assert host.host and host.powers_g1 == want and host.tau_g2 == params.tau_g2
    dev = KZGParams.from_reference(ref_kzg.device_params(ref_params), device="cpu")
    assert not dev.host and jac.to_affine_ints(BN254.g1, dev.powers_g1) == want
    assert dev.pairing is BN254 and dev.to_bytes() == ref_params.to_bytes()
