"""Kernels K2's and K8's plain versions and the port's NTTs against the JAX
package.

K2's M-point DIF (`small_ntt_plain`, from which its plain level is built)
is held against `openzl_tpu.ops.ntt_kernel.small_ntt` in Pallas interpret
mode on BabyBear, K8 (plain) against `ntt_kernel.butterfly` in interpret
mode on BN254 Fr, as tests/test_ntt_kernel.py runs them; `ntt`, `intt`,
`coset_ntt` and `coset_intt` against `openzl_tpu.ops.ntt` on BN254 Fr at
2^3 to 2^10 and on a batch axis of 3, through every route (per-stage below
2^13, and the four-step route, reached by lowering the threshold or
through `fourstep_transform`, in two levels and, with `ntt_kernel.M_MAX`
lowered to 8, in three or four; the inverses at batch 3 through the JAX
package's forward results). K2's plain level is held against sums over
Python ints, one level with and without its scales and the four-step
route in three levels over BabyBear and BLS12-381 Fr, with
no JAX compile. K8 stages and the per-stage transforms are also
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
    got = ntt_kernel.small_ntt_plain(
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
    port_tw = ntt_kernel.stage_twiddles(limb.tensor(R), 1 << log_n, m).numpy()
    for s in range(m.bit_length() - 1):
        h = m >> (s + 1)
        assert np.array_equal(port_tw[:, s, :h], ref_tw[:, s, :h])


#: (`_FOURSTEP_MIN`, `ntt_kernel.M_MAX`) that send a transform below 2^13
#: to each route: the per-stage route, the four-step route in levels of
#: up to 64 points (two levels at 2^8-2^10), and in levels of up to 8
#: points (three levels at 2^8 and 2^9, four at 2^10; the prover's 2^17
#: has three)
ROUTES = {"stage": (ntt._FOURSTEP_MIN, 64), "fourstep": (1, 64), "fourstep_deep": (1, 8)}


def _route(monkeypatch, route):
    threshold, m_max = ROUTES[route]
    monkeypatch.setattr(ntt, "_FOURSTEP_MIN", threshold)
    monkeypatch.setattr(ntt_kernel, "M_MAX", m_max)


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_transforms_match_reference(log_n, monkeypatch):
    """All four transforms through every route. At these sizes the
    four-step route has two levels, and three or four with M_MAX at 8, as
    at the prover's 2^17 (three levels)."""
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
        for route in ROUTES:
            _route(monkeypatch, route)
            assert len(ntt._levels(log_n)) == {"fourstep_deep": -(-log_n // 3)}.get(route, 2)
            got = port_fn(spec, tx)
            assert np.array_equal(got.numpy().astype(np.uint32), want), (port_fn.__name__, route)


def test_transform_batch_axis_matches_reference(monkeypatch):
    """A trailing batch axis of 3 through every route (two and three
    four-step levels, the later ones carrying n1 x 3 lanes); the inverse
    through the JAX package's forward result (intt(ntt(x)) = x)."""
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 11)
    want = np.asarray(ref_ntt.ntt(spec, jnp.asarray(x)))
    for route in ROUTES:
        _route(monkeypatch, route)
        got = ntt.ntt(spec, limb.tensor(x))
        assert np.array_equal(got.numpy().astype(np.uint32), want), route
        back = ntt.intt(spec, limb.tensor(want.astype(np.int32)))
        assert np.array_equal(back.numpy().astype(np.uint32), x), route


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
    `limb.geom_series_mont`, equal the reference's host tables; the
    four-step route's word-packed scales are the same series, the
    inverse's times 1/N."""
    spec, log_n = BN254_FR, 9
    cpu = torch.device("cpu")
    R = ntt._root_powers(spec, log_n, inverse, cpu)
    assert np.array_equal(R.numpy(), _roots(spec, log_n, inverse))
    scales = ntt._coset_scales(spec, 1 << log_n, inverse, cpu)
    assert np.array_equal(scales.numpy(), ref_ntt._coset_scales(spec, 1 << log_n, inverse))
    if inverse:
        n_inv = limb.tensor(limb.pack_mont(spec, pow(1 << log_n, -1, spec.modulus)))
        scales = ntt_kernel.mont_mul_plain(spec, scales, n_inv.reshape(-1, 1)).to(limb.DTYPE)
    words = ntt._coset_scales(spec, 1 << log_n, inverse, cpu, words=True)
    assert torch.equal(words, ntt_kernel.to_words(spec, scales))


def test_coset_transforms_batch_axis_match_reference(monkeypatch):
    """The batched coset transforms of the prover's h polynomial (u, v and w
    stacked on a trailing axis of 3), through every route; the coset
    inverse also of the JAX package's forward result."""
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 12)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for port_fn, ref_fn in ((ntt.coset_ntt, ref_ntt.coset_ntt), (ntt.coset_intt, ref_ntt.coset_intt)):
        want = np.asarray(ref_fn(spec, jx))
        for route in ROUTES:
            _route(monkeypatch, route)
            got = port_fn(spec, tx)
            assert np.array_equal(got.numpy().astype(np.uint32), want), (port_fn.__name__, route)
            if port_fn is ntt.coset_ntt:
                back = ntt.coset_intt(spec, limb.tensor(want.astype(np.int32)))
                assert np.array_equal(back.numpy().astype(np.uint32), x), route


@pytest.mark.parametrize("log_n", [1, 4, 13])
def test_round_trip_and_level_split(log_n):
    spec = BN254_FR
    x = limb.tensor(_rand_mont(spec, (1 << log_n,), 100 + log_n))
    assert torch.equal(ntt.intt(spec, ntt.ntt(spec, x)), x)
    levels = ntt._levels(log_n)
    cap = ntt_kernel.M_MAX.bit_length() - 1
    assert sum(levels) == log_n and max(levels) <= cap and max(levels) - min(levels) <= 1


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


@pytest.mark.parametrize("log_n,m_max", [(6, 4), (7, 8)])
@pytest.mark.parametrize("name", ["babybear", "bls12_381_fr"])
def test_fourstep_route_matches_naive_dft(name, log_n, m_max, monkeypatch):
    """The four-step route in three levels ([2, 2, 2] with M_MAX = 4,
    [3, 2, 2] with 8, as the prover's 2^17 has three), all four transforms
    on a batch of 2, against O(N^2) sums over Python ints with the
    reference's root w and coset generator g."""
    spec = INT_SPECS[name]
    monkeypatch.setattr(ntt_kernel, "M_MAX", m_max)
    assert len(ntt._levels(log_n)) == 3
    p, N = spec.modulus, 1 << log_n
    w = ref_ntt.group_gen(spec, log_n)
    g, n_inv = ref_ntt.GENERATORS[spec.name], pow(N, -1, p)
    x = _rand_mont(spec, (N, 2), 400 + log_n)
    cols = [[int(v) for v in col] for col in _ints(spec, x).T]
    want = {
        ntt.ntt: [_dft(p, w, col) for col in cols],
        ntt.intt: [_dft(p, pow(w, -1, p), col, n_inv) for col in cols],
        ntt.coset_ntt: [_dft(p, w, col, shift=g) for col in cols],
        ntt.coset_intt: [[v * pow(g, -j, p) % p for j, v in enumerate(_dft(p, pow(w, -1, p), col, n_inv))]
                         for col in cols],
    }
    monkeypatch.setattr(ntt, "_FOURSTEP_MIN", 1)
    for fn, values in want.items():
        got = _ints(spec, fn(spec, limb.tensor(x)))
        assert [[int(v) for v in col] for col in got.T] == values, fn.__name__


@pytest.mark.parametrize("log_n,log_m,log_nt,batch", [(5, 2, 5, 1), (5, 3, 4, 3), (6, 2, 3, 2), (4, 4, 4, 1)])
@pytest.mark.parametrize("name", ["bn254_fr", "babybear"])
def test_level_plain_matches_int_oracle(name, log_n, log_m, log_nt, batch):
    """K2's plain version, one level: x (N, B) read as (M, S, c) gives (S, M,
    c) with out[j2, k1, b] = w_nt^(k1 j2) sum_j1 x[j1, j2, b] w_M^(j1 k1)
    (w_nt = w_N^(N / nt), w_M = w_nt^S), times pre[i] before and post[i]
    after (i the element's row), and with post a single element."""
    spec = INT_SPECS[name]
    p, N, M, nt = spec.modulus, 1 << log_n, 1 << log_m, 1 << log_nt
    S, c = nt // M, N * batch // nt
    w = ref_ntt.group_gen(spec, log_n)
    roots = ntt_kernel.to_words(spec, limb.tensor(_roots(spec, log_n)))
    x = _rand_mont(spec, (N, batch), 500 + log_n + log_m)
    pre, post = _rand_mont(spec, (N,), 7), _rand_mont(spec, (N,), 8)
    xs, pres, posts = (_ints(spec, v) for v in (x, pre, post))
    flat = [int(v) for v in xs.reshape(-1)]  # element (j1, j2, b) at (j1 S + j2) c + b
    w_nt = pow(w, N // nt, p)
    w_m = pow(w_nt, S, p)
    for use_pre, use_post in ((False, False), (True, False), (False, True), (False, "one")):
        got = ntt_kernel.level_plain(
            spec, limb.tensor(x), roots, log_m, nt,
            ntt_kernel.to_words(spec, limb.tensor(pre)) if use_pre else None,
            None if not use_post else ntt_kernel.to_words(spec, limb.tensor(post[:, :1] if use_post == "one" else post)),
        )
        got = [int(v) for v in _ints(spec, got).reshape(-1)]
        for j2 in range(S):
            for k1 in range(M):
                for b in range(c):
                    acc = 0
                    for j1 in range(M):
                        i = (j1 * S + j2) * c + b
                        v = flat[i] * (int(pres[i // batch]) if use_pre else 1)
                        acc += v * pow(w_m, j1 * k1, p)
                    o = (j2 * M + k1) * c + b
                    want = acc * pow(w_nt, k1 * j2, p) % p
                    if use_post:
                        want = want * int(posts[0 if use_post == "one" else o // batch]) % p
                    assert got[o] == want, (use_pre, use_post, j2, k1, b)


def test_word_tables_round_trip():
    """`to_words` packs limbs 2w and 2w + 1 into word w (as int32 bits) with
    an element's words contiguous, and `from_words` undoes it, at 2, 16
    and 24 limbs, p - 1 among the values."""
    for spec in (BABYBEAR, BN254_FR, BLS12_381_FR):
        vals = _rand_mont(spec, (5,), 9)
        vals[:, 0] = ref_limb.pack_mont(spec, spec.modulus - 1)
        t = limb.tensor(vals)
        w = ntt_kernel.to_words(spec, t)
        assert w.shape == (5, spec.n_limbs // 2) and w.dtype == torch.int32
        ints = _ints(spec, vals)
        for i in range(5):
            m = int(ints[i]) * spec.R % spec.modulus
            assert [int(v) & 0xFFFFFFFF for v in w[i]] == [(m >> (32 * k)) & 0xFFFFFFFF for k in range(spec.n_limbs // 2)]
        assert torch.equal(ntt_kernel.from_words(spec, w), t)
