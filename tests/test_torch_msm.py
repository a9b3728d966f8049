"""The port's MSMs (`msm`, `msm_multi`, `fixed_base_msm`) against the
Python oracle `openzl_tpu.ref.curve`, compared as affine points (the bucket
method is the port's own; only the group element must match). Scalars and
points come from seeded `random.Random`; tolerance 0."""

import os
import random

import pytest
import torch

from openzl_tpu.curves.spec import BN254_G1, BN254_G2
from openzl_tpu.ref import curve as ref
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.ops import msm

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)



def _case(curve, n, seed, bits=None):
    rng = random.Random(seed)
    G = ref.generator(curve)
    r = curve.scalar.modulus
    scalars = [rng.randrange(1 << bits) if bits else rng.randrange(r) for _ in range(n)]
    scalars[1] = 0
    if not bits:
        scalars[2] = r - 1
    points = [ref.scalar_mul(curve, rng.randrange(1, 1 << 32), G) for _ in range(n)]
    points[3] = None
    points[5] = points[4]  # repeated points land in shared buckets
    return scalars, points


def _scalars(curve, vals, device=None):
    return limb.tensor(limb.pack(curve.scalar, vals), device)


@pytest.mark.parametrize("n,c", [(64, 4), (256, 5)])
def test_msm_g1_matches_oracle(n, c):
    curve = BN254_G1
    scalars, points = _case(curve, n, n)
    got = msm.msm(curve, _scalars(curve, scalars), jac.from_affine_ints(curve, points), window_bits=c)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)


def test_msm_g2_matches_oracle():
    curve = BN254_G2
    scalars, points = _case(curve, 64, 7)
    got = msm.msm(curve, _scalars(curve, scalars), jac.from_affine_ints(curve, points), window_bits=4)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)


def test_msm_multi_and_sets_match_oracle():
    curve = BN254_G1
    scalars, points = _case(curve, 128, 9)
    _, other = _case(curve, 128, 10)
    P, Q = jac.from_affine_ints(curve, points), jac.from_affine_ints(curve, other)
    got = msm.msm_multi(curve, _scalars(curve, scalars), [P, Q], window_bits=5)
    assert [jac.to_affine_ints(curve, g) for g in got] == [
        ref.msm(curve, scalars, points), ref.msm(curve, scalars, other)
    ]
    # jobs with their own scalars and lengths in one pipeline
    short = scalars[:40]
    out = msm.msm_sets(curve, [(_scalars(curve, scalars), P), (_scalars(curve, short), jac.take(Q, slice(0, 40)))])
    assert jac.to_affine_ints(curve, out) == [ref.msm(curve, scalars, points), ref.msm(curve, short, other[:40])]


def test_msm_short_scalars_and_zero_scalars():
    curve = BN254_G1
    scalars, points = _case(curve, 64, 11, bits=40)
    got = msm.msm(curve, _scalars(curve, scalars), jac.from_affine_ints(curve, points), n_bits=40)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)
    zeros = msm.msm(curve, _scalars(curve, [0] * 8), jac.from_affine_ints(curve, points[:8]))
    assert jac.to_affine_ints(curve, zeros) is None


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_fixed_base_msm_matches_oracle(curve):
    rng = random.Random(12)
    r = curve.scalar.modulus
    scalars = [0, 1, r - 1] + [rng.randrange(r) for _ in range(13)]
    got = msm.fixed_base_msm(curve, _scalars(curve, scalars))
    G = ref.generator(curve)
    assert jac.to_affine_ints(curve, got) == [ref.scalar_mul(curve, k, G) for k in scalars]


def test_default_window_bits():
    assert msm.default_window_bits(1 << 17) == 11
    assert msm.default_window_bits(1 << 20) == 15
