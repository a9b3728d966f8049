"""The port's `Radix2Domain` and `DensePoly` (`openzl_tpu_torch.ops.poly`)
against the JAX package's `openzl_tpu.ops.poly`, on the CPU. Both sides draw
their polynomials from `random.Random` with one seed; every comparison is
exact (coefficient lists of ints). The NTT product runs at small sizes by
monkeypatching the port's `_NTT_MUL_MIN`, at degree pairs that give domains
of 1 to 128 points; the domain transforms run at 2^3, a size the NTT tests
already compile in the reference."""

import os
import random

import pytest
import torch

from openzl_tpu.fields.spec import BLS12_381_FR as REF_BLS12_381_FR
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu.ops import poly as ref_poly
from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
from openzl_tpu_torch.ops import poly

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SPECS = {"bn254": (BN254_FR, REF_BN254_FR), "bls12_381": (BLS12_381_FR, REF_BLS12_381_FR)}


@pytest.mark.parametrize("size", [8, 1])
def test_domain_matches_reference(size):
    spec, ref_spec = SPECS["bn254"]
    dom = poly.Radix2Domain.new(spec, size, device="cpu")
    ref_dom = ref_poly.Radix2Domain.new(ref_spec, size)
    assert (dom.size, dom.log_n, dom.group_gen) == (ref_dom.size, ref_dom.log_n, ref_dom.group_gen)
    assert dom.elements() == ref_dom.elements()
    rng = random.Random(size)
    p = spec.modulus
    z = rng.randrange(p)
    assert dom.evaluate_vanishing(z) == ref_dom.evaluate_vanishing(z)
    assert dom.lagrange_coeffs(z) == ref_dom.lagrange_coeffs(z)
    on = dom.elements()[-1]
    assert dom.lagrange_coeffs(on) == ref_dom.lagrange_coeffs(on)
    coeffs = [rng.randrange(p) for _ in range(size)]
    for name in ("fft", "ifft", "coset_fft", "coset_ifft"):
        assert getattr(dom, name)(coeffs) == getattr(ref_dom, name)(coeffs), name
    assert poly.DensePoly.from_evals(dom, coeffs).coeffs == ref_poly.DensePoly.from_evals(ref_dom, coeffs).coeffs


@pytest.mark.parametrize("name", list(SPECS))
def test_dense_poly_matches_reference(name):
    spec, ref_spec = SPECS[name]
    rng, ref_rng = random.Random(7), random.Random(7)
    a, b, c = (poly.DensePoly.rand(spec, d, rng, device="cpu") for d in (7, 5, 20))
    ra, rb, rc = (ref_poly.DensePoly.rand(ref_spec, d, ref_rng) for d in (7, 5, 20))
    k, z = rng.randrange(spec.modulus), rng.randrange(spec.modulus)
    pairs = [
        (a + b, ra + rb), (a - b, ra - rb), (-a, -ra), (a.scale(k), ra.scale(k)), (a * b, ra * rb),
        (poly.DensePoly.zero(spec, "cpu") * a, ref_poly.DensePoly.zero(ref_spec) * ra),
        *zip(c.divide_with_q_and_r(b), rc.divide_with_q_and_r(rb)),
        *zip(b.divide_with_q_and_r(c), rb.divide_with_q_and_r(rc)),
    ]
    for got, want in pairs:
        assert got.coeffs == want.coeffs
    assert (a.degree, a.evaluate(z)) == (ra.degree, ra.evaluate(z))
    dom = poly.Radix2Domain.new(spec, 8, device="cpu")
    ref_dom = ref_poly.Radix2Domain.new(ref_spec, 8)
    for on_device in (False, True):
        got = c.divide_by_vanishing_poly(dom, on_device=on_device)
        want = rc.divide_by_vanishing_poly(ref_dom, device=on_device)
        assert [v.coeffs for v in got] == [v.coeffs for v in want], on_device


@pytest.mark.parametrize("name", list(SPECS))
def test_ntt_product_matches_reference(name, monkeypatch):
    """The port's NTT product (domain 64, the per-stage route) against the
    reference's host schoolbook product of the same polynomials."""
    spec, ref_spec = SPECS[name]
    rng, ref_rng = random.Random(11), random.Random(11)
    a, b = (poly.DensePoly.rand(spec, d, rng, device="cpu") for d in (40, 23))
    ra, rb = (ref_poly.DensePoly.rand(ref_spec, d, ref_rng) for d in (40, 23))
    monkeypatch.setattr(poly, "_NTT_MUL_MIN", 8)
    assert (a * b).coeffs == (ra * rb).coeffs


@pytest.mark.parametrize(
    "da,db", [(0, 0), (1, 0), (1, 1), (2, 1), (3, 4), (7, 8), (8, 8), (15, 16), (31, 0), (20, 43), (63, 64)]
)
@pytest.mark.parametrize("name", list(SPECS))
def test_ntt_product_degrees_match_reference(name, da, db, monkeypatch):
    """Every product through the NTT product (`_NTT_MUL_MIN` = 1), at
    result lengths that are and are not powers of two, against the
    reference's host schoolbook product of the same coefficients."""
    spec, ref_spec = SPECS[name]
    rng = random.Random(1000 * da + db)
    a, b = (poly.DensePoly.rand(spec, d, rng, device="cpu") for d in (da, db))
    want = ref_poly.DensePoly(ref_spec, a.coeffs) * ref_poly.DensePoly(ref_spec, b.coeffs)
    monkeypatch.setattr(poly, "_NTT_MUL_MIN", 1)
    got = a * b
    assert (got.degree, got.coeffs) == (da + db, want.coeffs)
