"""Kernels K2's and K8's plain versions and the port's NTTs against the JAX
package.

K2 (plain) is held against `openzl_tpu.ops.ntt_kernel.small_ntt` in Pallas
interpret mode on BabyBear, K8 (plain) against `ntt_kernel.butterfly` in
interpret mode on BN254 Fr, as tests/test_ntt_kernel.py runs them; `ntt`,
`intt`, `coset_ntt` and `coset_intt` against `openzl_tpu.ops.ntt` on BN254
Fr at 2^3 to 2^10 and on a batch axis, through both routes (per-stage
below 2^13, and the four-step route, reached by lowering the threshold or
through `fourstep_transform`). K8 stages and the per-stage transforms are also
held against sums over Python ints (no JAX compile) on BN254 Fr,
BLS12-381 Fr and BabyBear. K8's one-launch transform's plain version
(`transform_plain`) is held against the JAX package's `_ntt_core` at 2^1
and 2^10, forward and inverse, on a batch of 3 and on its first column
alone (one XLA compile per size and direction, shared by both batches),
and against O(N^2) sums over Python ints at every size from 2^1 to 2^10
on BN254 Fr and at 2^3 and 2^10 on two 16-limb primes past `F1c`'s bound.
Inputs come from numpy.random.default_rng(seed); every comparison is exact
equality (tolerance 0)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BLS12_381_FR, BN254_FR, FieldSpec
from openzl_tpu.ops import ntt as ref_ntt
from openzl_tpu.ops import ntt_kernel as ref_ntt_kernel
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.ops import ntt, ntt_kernel

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


BABYBEAR = FieldSpec(name="babybear", modulus=2013265921)


def _rand_mont(spec, shape, seed):
    rng = np.random.default_rng(seed)
    vals = np.array(
        [int(v) % spec.modulus for v in rng.integers(0, 1 << 62, int(np.prod(shape)))],
        dtype=object,
    ).reshape(shape)
    return ref_limb.pack_mont(spec, vals)


def _roots(spec, log_n, inverse=False):
    """Montgomery limbs of w^j, j < n (the reference's _root_powers table,
    computed here so no cache file is written)."""
    n = 1 << log_n
    w = ref_ntt.group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, spec.modulus)
    pows, acc = [], 1
    for _ in range(n):
        pows.append(acc)
        acc = acc * w % spec.modulus
    return ref_limb.pack_mont(spec, np.array(pows, dtype=object))


@pytest.mark.parametrize("m,lanes,post", [(8, 5, False), (16, 3, True), (64, 2, True), (2, 4, False)])
def test_k2_plain_matches_pallas_interpret(m, lanes, post):
    spec = BABYBEAR
    log_n = 10
    R = _roots(spec, log_n)
    ref_tw = ref_ntt._stage_twiddles(spec, R, 1 << log_n, m)  # (n, log m, m)
    x = _rand_mont(spec, (m, lanes), m * 100 + lanes)
    post_tw = _rand_mont(spec, (m, lanes), 7) if post else None
    want = ref_ntt_kernel.small_ntt(
        spec, jnp.asarray(x), jnp.asarray(ref_tw),
        None if post_tw is None else jnp.asarray(post_tw), interpret=True,
    )
    # the port's table keeps entry j < h of each stage: (n, log m, m / 2)
    port_tw = limb.tensor(ref_tw[:, :, : m // 2])
    got = ntt_kernel.small_ntt(
        spec, limb.tensor(x), port_tw, None if post_tw is None else limb.tensor(post_tw)
    )
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_k2_stage_table_matches_reference_layout():
    """The port's own plan tables equal the reference's in every entry a
    stage reads (j < h = m >> (s + 1))."""
    spec = BN254_FR
    log_n, m = 10, 32
    R = _roots(spec, log_n)
    ref_tw = ref_ntt._stage_twiddles(spec, R, 1 << log_n, m)
    port_tw = ntt._stage_twiddles(limb.tensor(R), 1 << log_n, m).numpy()
    for s in range(m.bit_length() - 1):
        h = m >> (s + 1)
        assert np.array_equal(port_tw[:, s, :h], ref_tw[:, s, :h])


#: `_FOURSTEP_MIN` values that send a transform below 2^13 to each route
ROUTES = {"stage": ntt._FOURSTEP_MIN, "fourstep": 1}


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_transforms_match_reference(log_n, monkeypatch):
    """All four transforms through both routes. At these sizes the
    four-step route has two levels (level twiddles, transposes and an
    inner node), as at the prover's 2^17 (three levels)."""
    assert len(ntt._levels(log_n)) == 2
    spec = BN254_FR
    x = _rand_mont(spec, (1 << log_n,), log_n)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for port_fn, ref_fn in (
        (ntt.ntt, ref_ntt.ntt),
        (ntt.intt, ref_ntt.intt),
        (ntt.coset_ntt, ref_ntt.coset_ntt),
        (ntt.coset_intt, ref_ntt.coset_intt),
    ):
        want = np.asarray(ref_fn(spec, jx))
        for route, threshold in ROUTES.items():
            monkeypatch.setattr(ntt, "_FOURSTEP_MIN", threshold)
            got = port_fn(spec, tx)
            assert np.array_equal(got.numpy().astype(np.uint32), want), (port_fn.__name__, route)


def test_transform_batch_axis_matches_reference(monkeypatch):
    """A trailing batch axis of 3 through both routes (two four-step
    levels, the inner node carrying n1 x 3 lanes)."""
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 11)
    want = np.asarray(ref_ntt.ntt(spec, jnp.asarray(x)))
    for route, threshold in ROUTES.items():
        monkeypatch.setattr(ntt, "_FOURSTEP_MIN", threshold)
        got = ntt.ntt(spec, limb.tensor(x))
        assert np.array_equal(got.numpy().astype(np.uint32), want), route


def test_k8_plain_matches_pallas_interpret():
    """butterfly_plain against the reference's fused butterfly over a batch
    axis, including the zero and p - 1 rows."""
    spec = BN254_FR
    u, t, w = (_rand_mont(spec, (7, 3), seed) for seed in (31, 32, 33))
    u[:, 0, 0] = 0
    t[:, 1, 0] = ref_limb.pack_mont(spec, spec.modulus - 1)
    want = ref_ntt_kernel.butterfly(spec, *(jnp.asarray(v) for v in (u, t, w)), interpret=True)
    got = ntt_kernel.butterfly(spec, *(limb.tensor(v) for v in (u, t, w)))
    for g, e in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(e))


def test_k8_stage_matches_butterflies():
    """One Pease stage on a batched x: lo and hi of pair k land in slots 2k
    and 2k + 1, with the twiddle W[k & ~(2^s - 1)] broadcast over the batch."""
    spec = BN254_FR
    log_n, B = 4, 3
    x = limb.tensor(_rand_mont(spec, (1 << log_n, B), 41))
    table = limb.tensor(_roots(spec, log_n)[:, : (1 << log_n) // 2])
    H = (1 << log_n) // 2
    for s in range(log_n):
        got = ntt_kernel.stage(spec, x, table, s)
        for k in range(H):
            tw = table[:, k & ~((1 << s) - 1)].reshape(-1, 1).expand(-1, B)
            lo, hi = ntt_kernel.butterfly_plain(spec, x[:, k], x[:, k + H], tw)
            assert torch.equal(got[:, 2 * k], lo) and torch.equal(got[:, 2 * k + 1], hi)


@pytest.mark.parametrize("log_n", [3, 6])
@pytest.mark.parametrize("route", ["stage", "fourstep"])
def test_routes_match_reference(route, log_n):
    """Both routes at sizes below the four-step threshold, where the
    transforms run the per-stage route by default."""
    spec = BN254_FR
    x = _rand_mont(spec, (1 << log_n,), 50 + log_n)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for inverse, ref_fn in ((False, ref_ntt.ntt), (True, ref_ntt.intt)):
        if route == "stage":
            got = ntt._transform(spec, tx, inverse)
        else:
            got = ntt.fourstep_transform(spec, tx, inverse)
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref_fn(spec, jx))), inverse
    if route == "stage":
        for port_fn, ref_fn in ((ntt.coset_ntt, ref_ntt.coset_ntt), (ntt.coset_intt, ref_ntt.coset_intt)):
            got = port_fn(spec, tx)
            assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref_fn(spec, jx))), port_fn.__name__


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_tables_match_reference(inverse):
    """The root powers and coset scales, built on the tensor's device by
    `limb.geom_series_mont`, equal the reference's host tables."""
    spec, log_n = BN254_FR, 9
    cpu = torch.device("cpu")
    R = ntt._root_powers(spec, log_n, inverse, cpu)
    assert np.array_equal(R.numpy(), _roots(spec, log_n, inverse))
    scales = ntt._coset_scales(spec, 1 << log_n, inverse, cpu)
    assert np.array_equal(scales.numpy(), ref_ntt._coset_scales(spec, 1 << log_n, inverse))


def test_coset_transforms_batch_axis_match_reference(monkeypatch):
    """The batched coset transforms of the prover's h polynomial (u, v and w
    stacked on a trailing axis of 3), through both routes."""
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 12)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for port_fn, ref_fn in ((ntt.coset_ntt, ref_ntt.coset_ntt), (ntt.coset_intt, ref_ntt.coset_intt)):
        want = np.asarray(ref_fn(spec, jx))
        for route, threshold in ROUTES.items():
            monkeypatch.setattr(ntt, "_FOURSTEP_MIN", threshold)
            got = port_fn(spec, tx)
            assert np.array_equal(got.numpy().astype(np.uint32), want), (port_fn.__name__, route)


@pytest.mark.parametrize("log_n", [1, 4, 13])
def test_round_trip_and_level_split(log_n):
    spec = BN254_FR
    x = limb.tensor(_rand_mont(spec, (1 << log_n,), 100 + log_n))
    assert torch.equal(ntt.intt(spec, ntt.ntt(spec, x)), x)
    levels = ntt._levels(log_n)
    assert sum(levels) == log_n and max(levels) <= 6 and max(levels) - min(levels) <= 1


INT_SPECS = {"bn254_fr": BN254_FR, "bls12_381_fr": BLS12_381_FR, "babybear": BABYBEAR}


def _ints(spec, x):
    """Montgomery limbs (a numpy array or a CPU tensor) -> canonical ints."""
    if torch.is_tensor(x):
        x = x.numpy().astype(np.uint32)
    return ref_limb.unpack_mont(spec, np.ascontiguousarray(x))


@pytest.mark.parametrize("log_n", [1, 2, 3, 5])
@pytest.mark.parametrize("name", list(INT_SPECS))
def test_k8_stage_plain_matches_int_oracle(name, log_n):
    """Every stage s of an (N, 2) input against the DIF stage over Python
    ints: slot 2k holds x[k] + x[k + N/2] and slot 2k + 1 holds
    (x[k] - x[k + N/2]) w^(k & ~(2^s - 1)), w the reference's N-th root."""
    spec = INT_SPECS[name]
    p, N = spec.modulus, 1 << log_n
    H = N // 2
    x = _rand_mont(spec, (N, 2), 60 + log_n)
    table = np.ascontiguousarray(_roots(spec, log_n)[:, :H])
    xs, ws = _ints(spec, x), _ints(spec, table)
    for s in range(log_n):
        got = _ints(spec, ntt_kernel.stage(spec, limb.tensor(x), limb.tensor(table), s))
        for k in range(H):
            w = int(ws[k & ~((1 << s) - 1)])
            for b in range(2):
                u, t = int(xs[k, b]), int(xs[k + H, b])
                assert (int(got[2 * k, b]), int(got[2 * k + 1, b])) == ((u + t) % p, (u - t) * w % p), (s, k, b)


def _dft(p, w, xs, scale=1, shift=1):
    """X_i = scale * sum_j shift^j x_j w^(ij) mod p."""
    n = len(xs)
    return [scale * sum(x * pow(shift, j, p) * pow(w, i * j, p) for j, x in enumerate(xs)) % p for i in range(n)]


@pytest.mark.parametrize("log_n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fr"])
def test_stage_route_matches_naive_dft(name, log_n):
    """`ntt`, `intt`, `coset_ntt` and `coset_intt` below the four-step
    threshold (the per-stage route: K8 stages, then the bit-reversal
    gather) against O(N^2) sums over Python ints, with the reference's root
    of unity w and coset generator g."""
    spec = INT_SPECS[name]
    p, N = spec.modulus, 1 << log_n
    w = ref_ntt.group_gen(spec, log_n)
    w_inv, n_inv = pow(w, -1, p), pow(N, -1, p)
    g = ref_ntt.GENERATORS[spec.name]
    g_inv = pow(g, -1, p)
    x = _rand_mont(spec, (N,), 70 + log_n)
    xs = [int(v) for v in _ints(spec, x)]
    tx = limb.tensor(x)
    want = {
        ntt.ntt: _dft(p, w, xs),
        ntt.intt: _dft(p, w_inv, xs, n_inv),
        ntt.coset_ntt: _dft(p, w, xs, shift=g),
    }
    for fn, values in want.items():
        assert [int(v) for v in _ints(spec, fn(spec, tx))] == values, fn.__name__
    inv = _dft(p, w_inv, xs, n_inv)
    assert [int(v) for v in _ints(spec, ntt.coset_intt(spec, tx))] == [
        v * pow(g_inv, j, p) % p for j, v in enumerate(inv)
    ]


@pytest.mark.parametrize("log_n", [1, 10])
def test_transform_plain_matches_reference_core(log_n):
    """K8's plain transform (the Pease stages, the bit-reversal gather and
    the inverse's 1/N scale, with the port's `_plan` tables) against the
    JAX package's `_ntt_core`, forward and inverse, at batch 3 and batch 1
    (the first column, without a batch axis), at the smallest and the
    largest size (one XLA compile per size and direction; every size in
    between is held against the naive DFT below)."""
    spec = BN254_FR
    x = _rand_mont(spec, (1 << log_n, 3), 200 + log_n)
    for inverse in (False, True):
        want = np.asarray(ref_ntt._ntt_core(spec, jnp.asarray(x), inverse))
        rev, table, n_inv = ntt._plan(spec, log_n, inverse, torch.device("cpu"))
        got = ntt_kernel.transform_plain(spec, limb.tensor(x), table, rev, n_inv, inverse)
        assert np.array_equal(got.numpy().astype(np.uint32), want), inverse
        got1 = ntt_kernel.transform(spec, limb.tensor(np.ascontiguousarray(x[:, :, 0])), table, rev, n_inv, inverse)
        assert np.array_equal(got1.numpy().astype(np.uint32), want[:, :, 0]), inverse


#: 16-limb primes k 2^32 + 1 with p's top word at `F1c`'s bound (0x7FFFFFFF)
#: and at its largest: the kernels run them on F1
F1_PRIMES = {
    "top_7fffffff": FieldSpec("top_7fffffff", 0x7FFFFFFF00000000000000000000000000000000000000000000004700000001),
    "top_ffffffff": FieldSpec("top_ffffffff", 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFD500000001),
}


def _dft_plan(spec, log_n, inverse):
    """(w, bit-reversal index, root table, 1/N) of an N-point transform:
    the reference's root for BN254 Fr, else a root of an element of order
    2^32 of a prime k 2^32 + 1; the table W[j] = w^j, j < N/2."""
    p, N = spec.modulus, 1 << log_n
    if spec.name in F1_PRIMES:
        w = next(w for w in (pow(g, (p - 1) >> 32, p) for g in range(2, 64)) if pow(w, 1 << 31, p) != 1)
        w = pow(w, 1 << (32 - log_n), p)
    else:
        w = ref_ntt.group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, p)
    table = limb.tensor(ref_limb.pack_mont(spec, np.array([pow(w, j, p) for j in range(N // 2)], dtype=object)))
    n_inv = limb.tensor(ref_limb.pack_mont(spec, pow(N, -1, p)))
    return w, torch.as_tensor(ntt._bitrev(N)), table, n_inv


@pytest.mark.parametrize("name,log_n", [("bn254_fr", k) for k in range(1, 11)]
                         + [(name, k) for name in F1_PRIMES for k in (3, 10)])
def test_transform_plain_matches_naive_dft(name, log_n):
    """K8's plain transform against O(N^2) sums over Python ints, forward
    and inverse, on a batch of 2 and on its first column alone: BN254 Fr
    at every size from 2 to 2^10 with the port's `_plan` tables, and the
    two primes past `F1c`'s bound (on which the card's transform runs F1)."""
    spec = BN254_FR if name == "bn254_fr" else F1_PRIMES[name]
    p, N = spec.modulus, 1 << log_n
    x = _rand_mont(spec, (N, 2), 300 + log_n)
    cols = [[int(v) for v in col] for col in _ints(spec, x).T]
    for inverse in (False, True):
        w, rev, table, n_inv = _dft_plan(spec, log_n, inverse)
        if name == "bn254_fr":
            rev, table, n_inv = ntt._plan(spec, log_n, inverse, torch.device("cpu"))
        powers = [pow(w, k, p) for k in range(N)]
        scale = pow(N, -1, p) if inverse else 1
        want = [[scale * sum(v * powers[i * j % N] for j, v in enumerate(col)) % p for i in range(N)] for col in cols]
        got = _ints(spec, ntt_kernel.transform_plain(spec, limb.tensor(x), table, rev, n_inv, inverse))
        assert [[int(v) for v in col] for col in got.T] == want, inverse
        got1 = _ints(spec, ntt_kernel.transform_plain(spec, limb.tensor(np.ascontiguousarray(x[:, :, 0])), table,
                                                       rev, n_inv, inverse))
        assert [int(v) for v in got1] == want[0], inverse
