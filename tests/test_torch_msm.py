"""The port's MSMs (`msm`, `msm_multi`, `fixed_base_msm`) against the
Python oracle `openzl_tpu.ref.curve`, compared as affine points (the bucket
method is the port's own; only the group element must match). The window
sweep runs on the reference's 2-limb toy curve with 12-bit scalars. Scalars
and points come from seeded `random.Random`; tolerance 0."""

import os
import random

import pytest
import torch

from openzl_tpu.curves.spec import BN254_G1, BN254_G2, toy_curve
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


def test_msm_bucket_across_chunks_matches_oracle():
    """80 of 100 points share digit 5 in the low window: one bucket of
    about 80 entries spans five or more fold chunks of r = 16, its offsets
    carried by the lifted scan over the chunk totals; identities and
    repeats included."""
    curve = BN254_G1
    rng = random.Random(13)
    _, points = _case(curve, 100, 13)
    scalars = [5] * 80 + [rng.randrange(1 << 8) for _ in range(20)]
    P = jac.from_affine_ints(curve, points)
    assert msm.fold_inputs(curve, [(_scalars(curve, scalars), P)], 4, 8)[3] == 16
    got = msm.msm(curve, _scalars(curve, scalars), P, window_bits=4, n_bits=8)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_msm_smallest_chunk_matches_oracle(curve):
    """An MSM of a few entries, which `_chunk_len` folds at its smallest
    chunk length r = 1 (every entry its own chunk): 3 points, 4-bit
    scalars in one window, two points sharing a digit."""
    points = _case(curve, 6, 16)[1][:3]
    points[1] = points[2]
    scalars = [9, 9, 4]
    P = jac.from_affine_ints(curve, points)
    assert msm.fold_inputs(curve, [(_scalars(curve, scalars), P)], 4, 4)[3] == 1
    got = msm.msm(curve, _scalars(curve, scalars), P, window_bits=4, n_bits=4)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)


def test_msm_g2_short_scalars_and_three_sets_match_oracle():
    """The fold over Fq2 (G2), and three G1 sets of different lengths in one
    `msm_sets` pipeline, with 16-bit scalars (a short Horner chain)."""
    rng = random.Random(14)
    scalars, points = _case(BN254_G2, 24, 14, bits=16)
    got = msm.msm(BN254_G2, _scalars(BN254_G2, scalars), jac.from_affine_ints(BN254_G2, points), n_bits=16)
    assert jac.to_affine_ints(BN254_G2, got) == ref.msm(BN254_G2, scalars, points)
    curve = BN254_G1
    jobs, want = [], []
    for n in (40, 17, 64):
        s, pts = _case(curve, n, 15 + n, bits=16)
        s[rng.randrange(n)] = s[0]  # a shared digit across points
        jobs.append((_scalars(curve, s), jac.from_affine_ints(curve, pts)))
        want.append(ref.msm(curve, s, pts))
    assert jac.to_affine_ints(curve, msm.msm_sets(curve, jobs, window_bits=4, n_bits=16)) == want


@pytest.mark.parametrize("window_bits", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12])
def test_msm_window_sweep_matches_oracle(window_bits):
    """Window widths from 1 to 12 bits over 12-bit scalars (a last window
    shorter than the others where c does not divide 12, one window at 12),
    with zero scalars, an identity point and a repeated point."""
    curve = toy_curve()
    rng = random.Random(20 + window_bits)
    G = ref.generator(curve)
    scalars = [rng.randrange(1 << 12) for _ in range(24)]
    scalars[1] = 0
    points = [ref.scalar_mul(curve, rng.randrange(1, 1 << 12), G) for _ in range(24)]
    points[3] = None
    points[5] = points[4]
    got = msm.msm(curve, _scalars(curve, scalars), jac.from_affine_ints(curve, points), window_bits=window_bits, n_bits=12)
    assert jac.to_affine_ints(curve, got) == ref.msm(curve, scalars, points)
