"""Kernel K9's plain version (`ec_kernel.fold_madd_plain`) against the JAX
package's jnp fold (`openzl_tpu.ops.msm._fold_columns`, the reference's
fold with `_FOLD_KERNEL_MODE` "off") and its tail pick, on a tiny grid of
the reference's 2-limb toy curve (a 16-limb jnp fold takes about 30 s to
compile on a CPU; the port's plain code takes any curve spec). Chunks of r = 4,
l = 8, with a duplicated point (P = Q), a point and its negation, a segment
crossing three chunks, a chunk with no start and E = 30 entries, padded to
32 with the dump key. `msm._bucket_totals` (the fold, the lifted scan of
the chunk totals and the bucket-width combine) is also held against the
oracle's per-key sums at chunk lengths r = 1 to 16. Points come from seeded
`random.Random`; every comparison is exact (tolerance 0)."""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.curves import jacobian as ref_jac
from openzl_tpu.curves.spec import toy_curve
from openzl_tpu.ops import msm as ref_msm
from openzl_tpu.ref import curve as ref
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.ops import ec_kernel, msm

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R, L = 4, 8
WIDTH = 17  # bucket slots 0..15 and the dump key 16


def _entries():
    """(points, sorted keys padded to R * L, point indices). Segments of
    lengths 3, 2, 10, 1, 4, 6 and 4 entries: keys 2 (entries 0-2, point 0
    twice), 3 (3-4, across chunks 0 and 1), 7 (5-14: chunks 1, 2 and 3,
    chunk 2 holds no start), 8, 9 (16-19, all of chunk 4: P1, -P1, then
    two more points), 12, 13; then two dump entries."""
    curve = toy_curve()
    rng = random.Random(0xF01D)
    G = ref.generator(curve)
    pts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 12), G) for _ in range(19)]
    pts.append(ref.neg(curve, pts[1]))  # index 19 = -P1
    lengths = (3, 2, 10, 1, 4, 6, 4)
    keys = [k for k, n in zip((2, 3, 7, 8, 9, 12, 13), lengths) for _ in range(n)]
    pidx = [rng.randrange(19) for _ in keys]
    pidx[0] = pidx[1] = 0  # P = Q inside key 2
    pidx[16], pidx[17] = 1, 19  # P1 + (-P1) inside key 9
    pad = R * L - len(keys)
    return curve, pts, keys + [WIDTH - 1] * pad, pidx + [0] * pad


def _reference_fold(curve, pts, keys, pidx):
    """The reference's jnp fold over the column-major (r, l) grid, then its
    pick at every segment tail (msm.py:324-380), as host arrays."""
    F = ref_jac.field_ops(curve)
    P = ref_jac.from_affine_ints(curve, pts)
    order = jnp.asarray(pidx)

    def rt(v):  # element chunk * r + j <-> column j of chunk
        return jnp.moveaxis(v.reshape(v.shape[:-1] + (L, R)), -1, -2)

    cps = ref_jac.JPoint(rt(F.take(P.x, order)), rt(F.take(P.y, order)), rt(F.one((R * L,))))
    k = np.asarray(keys)
    starts = k != np.concatenate([[-1], k[:-1]])
    tails = k != np.concatenate([k[1:], [-1]])
    totals, bufs = ref_msm._fold_columns(curve, cps, rt(jnp.asarray(starts)), True, False, F, (), L, R)
    picked = {}
    seg_start = 0
    for e in range(R * L):
        if starts[e]:
            seg_start = e
        if tails[e]:
            c, j = divmod(e, R)
            picked[int(k[e])] = (
                [np.asarray(b)[:, j, c] for b in bufs], seg_start // R == c, c,
            )
    tflag = starts.reshape(L, R).any(axis=1)
    return [np.asarray(t) for t in totals], tflag, picked


def test_fold_plain_matches_reference_fold():
    curve, pts, keys, pidx = _entries()
    want_totals, want_tflag, picked = _reference_fold(curve, pts, keys, pidx)
    P = jac.normalize(curve, jac.from_affine_ints(curve, pts))
    totals, tflag, buckets, bflag, bchunk = ec_kernel.fold_madd_plain(
        curve, P, torch.tensor(keys), torch.tensor(pidx), R, WIDTH
    )
    for got, want in zip(totals, want_totals):
        assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert tflag.tolist() == want_tflag.tolist() == [True, True, False, True, True, True, True, True]
    one = jac.field_ops(curve).one((1,))[:, 0]
    for slot in range(WIDTH):
        got = [b[:, slot].numpy().astype(np.uint32) for b in buckets]
        if slot in picked:
            values, flag, chunk = picked[slot]
            assert all(np.array_equal(g, w) for g, w in zip(got, values)), slot
            assert (bool(bflag[slot]), int(bchunk[slot])) == (flag, chunk), slot
        else:  # no tail: the identity, flag True, chunk 0
            assert np.array_equal(got[0], one.numpy()) and not got[2].any(), slot
            assert (bool(bflag[slot]), int(bchunk[slot])) == (True, 0), slot
    # key 9 passes through the identity (P1 + (-P1)) to the sum of its last
    # two points; key 7's tail (entry 14, chunk 3) belongs to a segment
    # started in chunk 1
    slot9 = jac.JPoint(*(b[..., 9:10] for b in buckets))
    assert jac.to_affine_ints(curve, slot9) == [ref.add(curve, pts[pidx[18]], pts[pidx[19]])]
    assert (bool(bflag[7]), int(bchunk[7])) == (False, 3)


def test_fold_dispatch_takes_the_plain_version_on_cpu():
    """`fold_madd` on CPU tensors returns what its plain version returns."""
    curve, pts, keys, pidx = _entries()
    P = jac.normalize(curve, jac.from_affine_ints(curve, pts))
    args = (curve, P, torch.tensor(keys), torch.tensor(pidx), R, WIDTH)
    got, want = ec_kernel.fold_madd(*args), ec_kernel.fold_madd_plain(*args)
    for g, w in zip(got, want):
        for a, b in zip(*((v,) if torch.is_tensor(v) else v for v in (g, w))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bucket_totals_match_oracle_sums(seed, r):
    """Sorted keys with runs of 0 to 13 entries over 12 buckets, each entry
    a random one of nine points or the negation of the first, padded with
    the dump key to a multiple of r: every bucket equals the oracle's sum of
    its entries (the identity where the run is empty or cancels)."""
    curve = toy_curve()
    rng = random.Random(seed)
    G = ref.generator(curve)
    pts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 12), G) for _ in range(9)]
    pts.append(ref.neg(curve, pts[0]))
    n_buckets = 12
    keys = [k for k in range(n_buckets) for _ in range(rng.choice((0, 0, 1, 2, 3, 7, 13)))]
    pidx = [rng.randrange(len(pts)) for _ in keys]
    pad = -len(keys) % r
    keys, pidx = keys + [n_buckets] * pad, pidx + [0] * pad
    P = jac.normalize(curve, jac.from_affine_ints(curve, pts))
    got = msm._bucket_totals(curve, P, torch.tensor(keys), torch.tensor(pidx), r, n_buckets)
    want = [None] * n_buckets
    for k, i in zip(keys, pidx):
        if k < n_buckets:
            want[k] = ref.add(curve, want[k], pts[i])
    assert jac.to_affine_ints(curve, got) == want
