"""Kernels K3/K4 (plain versions) and the port's Jacobian layer against the
JAX package and the Python oracle.

In Jacobian limbs, bit-exact, against `openzl_tpu.ops.ec_kernel.ec_op` in
Pallas interpret mode on the toy curve, as tests/test_ec_kernel.py runs it,
covering every mask case: identity on either side, P = Q and P = -Q. In
affine form against `openzl_tpu.ref.curve` on BN254 G1 and G2 (the G2
kernels' Jacobian limbs are held against their plain versions on the card
by chip_smoke.py). Inputs come from seeded `random.Random`; tolerance 0."""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.curves.spec import BN254_G1, BN254_G2, toy_curve
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.ops import ec_kernel as ref_ec_kernel
from openzl_tpu.ref import curve as ref
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.ops import ec_kernel

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)



def _jacobian_ints(curve, pts, rng):
    """Affine points -> Jacobian (x l^2, y l^3, l) Montgomery limbs (G1
    shape), identities as (1, 1, 0); numpy uint32."""
    p = curve.base.modulus
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(1), ys.append(1), zs.append(0)
            continue
        lam = rng.randrange(1, p)
        xs.append(pt[0] * lam * lam % p)
        ys.append(pt[1] * lam * lam * lam % p)
        zs.append(lam)
    return [ref_limb.pack_mont(curve.base, np.array(v, dtype=object)) for v in (xs, ys, zs)]


def _g1_cases(curve, n, seed):
    rng = random.Random(seed)
    pts = [ref.random_point(curve, rng) for _ in range(n)]
    qts = [ref.random_point(curve, rng) for _ in range(n)]
    pts[0] = None
    qts[1] = None
    pts[4] = qts[4] = None
    qts[2] = pts[2]
    qts[3] = ref.neg(curve, pts[3])
    return pts, qts, rng


def _same(port, want):
    for g, w in zip(port, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def _t(arrs):
    return tuple(limb.tensor(a) for a in arrs)


def test_k3_k4_plain_match_pallas_interpret_g1():
    curve = toy_curve()
    pts, qts, rng = _g1_cases(curve, 10, 1)
    P = _jacobian_ints(curve, pts, rng)
    Q = _jacobian_ints(curve, qts, rng)
    Qa = [v.numpy().astype(np.uint32) for v in jac.from_affine_ints(curve, qts)]
    want = ref_ec_kernel.ec_op(curve.base, "add", *map(jnp.asarray, P + Q), interpret=True)
    _same(ec_kernel.ec_add_plain(curve, _t(P), _t(Q), False), want)
    want = ref_ec_kernel.ec_op(curve.base, "madd", *map(jnp.asarray, P + Qa), interpret=True)
    _same(ec_kernel.ec_add_plain(curve, _t(P), _t(Qa), True), want)
    want = ref_ec_kernel.ec_op(curve.base, "dbl", *map(jnp.asarray, P), interpret=True)
    _same(ec_kernel.ec_dbl_plain(curve, *_t(P)), want)


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_group_law_matches_oracle(curve):
    rng = random.Random(3)
    G = ref.generator(curve)
    pts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 64), G) for _ in range(6)]
    A = pts + [None, pts[0], pts[1], None]
    B = pts[::-1] + [pts[2], pts[0], ref.neg(curve, pts[1]), None]
    P, Q = jac.from_affine_ints(curve, A), jac.from_affine_ints(curve, B)
    want = [ref.add(curve, a, b) for a, b in zip(A, B)]
    S = jac.add(curve, jac.double(curve, P), Q)  # Jacobian P operand
    assert jac.to_affine_ints(curve, S) == [ref.add(curve, ref.add(curve, a, a), b) for a, b in zip(A, B)]
    assert jac.to_affine_ints(curve, jac.madd(curve, P, Q)) == want
    assert jac.to_affine_ints(curve, jac.double(curve, P)) == [ref.add(curve, a, a) for a in A]
    assert bool(jac.is_on_curve(curve, S).all())
    N = jac.normalize(curve, S)
    assert jac.to_affine_ints(curve, N) == jac.to_affine_ints(curve, S)
    assert jac.to_affine_ints(curve, jac.negate(curve, P)) == [ref.neg(curve, a) for a in A]
    assert jac.to_affine_ints(curve, jac.JPoint(*(v[..., 0] for v in P))) == A[0]


def test_batch_inv_matches_python():
    from openzl_tpu.fields.spec import BN254_FQ
    from openzl_tpu_torch.fields import ext

    F = ext.fq_ops(BN254_FQ)
    rng = random.Random(4)
    vals = [rng.randrange(1, BN254_FQ.modulus) for _ in range(13)]
    got = F.to_ints(jac.batch_inv(F, F.from_ints(np.array(vals, dtype=object))))
    assert list(got) == [pow(v, -1, BN254_FQ.modulus) for v in vals]
