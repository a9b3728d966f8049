"""BLS12-381, the default curve of `Groth16()`, through the port on the CPU:
K3, K4, K9 and the lifted scan at 24 limbs (their plain versions), the MSM,
Groth16 and KZG, against the JAX package.

  * K3 (add, madd) and K4 over G1 and G2 in affine form against
    `openzl_tpu.ref.curve`, with every mask case: the identity on either
    side and on both, P = Q and P = -Q;
  * `msm._bucket_totals` (K9's fold, the lifted scan of its chunk totals
    and the combine) against the oracle's per-key sums, with `SCAN_NARROW`
    lowered so that the chunk levels run;
  * `msm.msm` over G1 and G2 with 255-bit scalars against `ref.msm`;
  * an 8-row circuit: the port's key and proof bytes against
    `Groth16(refpair.BLS12_381, backend="host")` with the same
    `random.Random` draws, and the JAX package's key carried across
    (`from_reference`, and `from_bytes` of its bytes);
  * `KZG(BLS12_381, backend="device", device="cpu")` against the JAX
    package's host-backend KZG at degree 8 (setup bytes, commit, open,
    verify, batch_verify), and `KZGParams.from_bytes` of its params.

Nothing here compiles a JAX kernel (the reference runs its pure-Python host
backend and oracles). Inputs come from seeded `random.Random`; every
comparison is exact (tolerance 0)."""

import os
import random

import numpy as np
import pytest
import torch

from openzl_tpu.curves.spec import BLS12_381_G1 as REF_G1, BLS12_381_G2 as REF_G2
from openzl_tpu.proof_systems import KZG as RefKZG, Groth16 as RefGroth16
from openzl_tpu.ref import curve as ref
from openzl_tpu.ref import pairing as refpair
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.curves.spec import BLS12_381_G1, BLS12_381_G2
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.ops import ec_kernel, msm
from openzl_tpu_torch.proof_systems import BLS12_381, KZG, Groth16, KZGParams, ProvingKey

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CURVES = [(BLS12_381_G1, REF_G1), (BLS12_381_G2, REF_G2)]
IDS = ["g1", "g2"]


def _points(ref_curve, n, seed):
    rng = random.Random(seed)
    G = ref.generator(ref_curve)
    return [ref.scalar_mul(ref_curve, rng.randrange(1, ref_curve.scalar.modulus), G) for _ in range(n)], rng


def _scaled(curve, P, rng):
    """The same points in Jacobian form with random Z: (x l^2, y l^3, l)."""
    F = jac.field_ops(curve)
    m = curve.base.modulus
    n = P.x.shape[-1]
    lam = F.from_ints(np.array([rng.randrange(1, m) if curve.ext == 1 else (rng.randrange(1, m), rng.randrange(m))
                                for _ in range(n)], dtype=object))
    l2 = F.mul(lam, lam)
    return jac.JPoint(F.mul(P.x, l2), F.mul(P.y, F.mul(l2, lam)), F.mul(P.z, lam))


@pytest.mark.parametrize("curve,ref_curve", CURVES, ids=IDS)
def test_k3_k4_plain_match_oracle_with_every_mask_case(curve, ref_curve):
    """Rows: two generic points, the identity as P, as Q and as both, P = Q
    and P = -Q, with P and Q Jacobian with random Z (Q affine for the
    madd)."""
    pts, rng = _points(ref_curve, 5, 1)
    A = [pts[0], None, pts[1], None, pts[2], pts[3]]
    B = [pts[4], pts[0], None, None, pts[2], ref.neg(ref_curve, pts[3])]
    Qa = jac.from_affine_ints(curve, B)
    P, Q = _scaled(curve, jac.from_affine_ints(curve, A), rng), _scaled(curve, Qa, rng)
    assert P.x.shape[0] == 24 and bool(jac.is_on_curve(curve, P).all())
    want = [ref.add(ref_curve, a, b) for a, b in zip(A, B)]
    assert jac.to_affine_ints(curve, jac.JPoint(*ec_kernel.ec_add(curve, tuple(P), tuple(Q)))) == want
    assert jac.to_affine_ints(curve, jac.JPoint(*ec_kernel.ec_add(curve, tuple(P), tuple(Qa), True))) == want
    assert jac.to_affine_ints(curve, jac.JPoint(*ec_kernel.ec_dbl(curve, tuple(P)))) == [
        ref.add(ref_curve, a, a) for a in A]


@pytest.mark.parametrize("curve,ref_curve,narrow", [(BLS12_381_G1, REF_G1, 0), (BLS12_381_G2, REF_G2, 3)],
                         ids=["g1-chunks", "g2-chunks-then-steps"])
def test_bucket_totals_match_oracle_sums(curve, ref_curve, narrow, monkeypatch):
    """Sorted keys with runs of 0 to 13 entries over 10 buckets, each entry
    one of six points or the negation of the first, folded in chunks of
    r = 2, so that runs span chunks and the scan of 20-odd chunk totals
    runs in chunks of SCAN_R all the way (narrow 0), or in chunks above 3
    and Hillis-Steele steps below (the shipped bound, steps alone at this
    size, runs in `test_msm_matches_oracle`)."""
    pts, rng = _points(ref_curve, 6, 2)
    pts.append(ref.neg(ref_curve, pts[0]))
    n_buckets, r = 10, 2
    keys = [k for k in range(n_buckets) for _ in range(rng.choice((0, 1, 2, 3, 7, 13)))]
    pidx = [rng.randrange(len(pts)) for _ in keys]
    pad = -len(keys) % r
    keys, pidx = keys + [n_buckets] * pad, pidx + [0] * pad
    monkeypatch.setattr(ec_kernel, "SCAN_NARROW", narrow)
    P = jac.normalize(curve, jac.from_affine_ints(curve, pts))
    got = msm._bucket_totals(curve, P, torch.tensor(keys), torch.tensor(pidx), r, n_buckets)
    want = [None] * n_buckets
    for k, i in zip(keys, pidx):
        if k < n_buckets:
            want[k] = ref.add(ref_curve, want[k], pts[i])
    assert jac.to_affine_ints(curve, got) == want


@pytest.mark.parametrize("curve,ref_curve,n", [(BLS12_381_G1, REF_G1, 24), (BLS12_381_G2, REF_G2, 8)], ids=IDS)
def test_msm_matches_oracle(curve, ref_curve, n):
    """255-bit scalars (0, 1 and r - 1 among them), an identity point and a
    repeated point, at the default window."""
    pts, rng = _points(ref_curve, n, 3)
    pts[3] = None
    pts[5] = pts[4]
    r = curve.scalar.modulus
    scalars = [0, 1, r - 1] + [rng.randrange(r) for _ in range(n - 3)]
    got = msm.msm(curve, limb.tensor(limb.pack(curve.scalar, scalars)), jac.from_affine_ints(curve, pts))
    assert jac.to_affine_ints(curve, got) == ref.msm(ref_curve, scalars, pts)


SETUP_SEED, PROVE_SEED = 11, 12


def _circuit(g16, x):
    """y = x^8 + x + 5 with y public: 4 constraints of the gadget, 8 rows
    with the instance rows' padding, 4 variables."""
    p = g16.fr.modulus
    y = (pow(x, 8, p) + x + 5) % p
    com = g16.proof_compiler()
    pub, w = com.public_input(y), com.secret_witness(x)
    t = w
    for _ in range(3):
        t = com.square(t)
    com.assert_eq(com.add_const(com.add(t, w), 5), pub)
    return com.cs, y


@pytest.fixture(scope="module")
def groth16():
    ref_g16 = RefGroth16(refpair.BLS12_381, backend="host")
    cs_ref, y = _circuit(ref_g16, 3)
    ref_pk = ref_g16.compile(cs_ref, random.Random(SETUP_SEED))
    ref_proof = ref_g16.prove(ref_pk, cs_ref, random.Random(PROVE_SEED)).to_bytes(refpair.BLS12_381)
    port = Groth16(BLS12_381, "cpu")
    cs, _ = _circuit(port, 3)
    pk = port.compile(cs, random.Random(SETUP_SEED))
    return dict(ref_pk=ref_pk, ref_bytes=ref_pk.to_bytes(), ref_proof=ref_proof, port=port, cs=cs, y=y, pk=pk)


def test_groth16_key_and_proof_bytes_match_reference(groth16):
    port, pk, cs = groth16["port"], groth16["pk"], groth16["cs"]
    assert Groth16().pairing is BLS12_381 and Groth16().device.type == "cuda"
    assert pk.to_bytes() == groth16["ref_bytes"]
    proof = port.prove(pk, cs, random.Random(PROVE_SEED))
    assert proof.to_bytes(BLS12_381) == groth16["ref_proof"]
    assert port.verify(pk.vk, [groth16["y"]], proof)
    assert not port.verify(pk.vk, [groth16["y"] + 1], proof)


def test_groth16_reference_key_carried_across(groth16):
    """The JAX package's BLS12-381 key through its bytes (`from_bytes`)
    serializes to the same bytes, which the port's key has too (the test
    above), and `from_reference` gives the same query tensors."""
    ref_pk = groth16["ref_pk"]
    loaded = ProvingKey.from_bytes(BLS12_381, groth16["ref_bytes"], validate=False, device="cpu")
    assert loaded.pairing is BLS12_381 and loaded.to_bytes() == groth16["ref_bytes"]
    lifted = ProvingKey.from_reference(ref_pk, device="cpu")
    assert lifted.pairing is BLS12_381 and lifted.vk == loaded.vk
    assert (lifted.beta_g1, lifted.delta_g1, lifted.domain_log2) == (loaded.beta_g1, loaded.delta_g1, loaded.domain_log2)
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        assert all(torch.equal(u, v) for u, v in zip(getattr(lifted, name), getattr(loaded, name))), name


DEGREE = 8


def test_kzg_device_matches_reference_host():
    kzg = KZG(BLS12_381, backend="device", device="cpu")
    ref_kzg = RefKZG(refpair.BLS12_381, backend="host")
    params = kzg.setup(DEGREE, random.Random(5))
    ref_params = ref_kzg.setup(DEGREE, random.Random(5))
    assert params.to_bytes() == ref_params.to_bytes()
    loaded = KZGParams.from_bytes(BLS12_381, ref_params.to_bytes())
    assert loaded.powers_g1 == jac.to_affine_ints(BLS12_381_G1, params.powers_g1)
    rng = random.Random(6)
    r = BLS12_381.r
    coeffs = [rng.randrange(r) for _ in range(DEGREE + 1)]
    C = kzg.commit(params, coeffs)
    assert C == ref_kzg.commit(ref_params, coeffs)
    z = rng.randrange(r)
    v, w = kzg.open(params, coeffs, z)
    assert (v, w) == ref_kzg.open(ref_params, coeffs, z)
    assert kzg.verify(params, C, z, v, w)
    assert not kzg.verify(params, C, z, (v + 1) % r, w)
    assert kzg.batch_verify(params, [(C, z, v, w)], random.Random(7))
