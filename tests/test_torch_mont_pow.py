"""K1's exponentiation against the JAX package on the CPU, and K6's
constant buffer.

The port's `limb.mont_pow` and `mont_inv` (on CPU tensors: the plain chain
of products, `ntt_kernel.mont_pow_plain`) against `openzl_tpu.fields.limb`
`mont_pow` (and, by p - 2, `mont_inv`, which is its `mont_pow` by p - 2)
over BN254 Fr, BN254 Fq and BLS12-381 Fq, at the exponents 0, 1, p - 2
and a random 256-bit one, on batches of shape (1,), (3,) and (2, 5) with
0 among the inputs; the BLS12-381 Fq2 inverse against
`openzl_tpu.fields.ext`. The JAX functions are jitted per exponent and
shape, so each case hands them the three batches as one flat batch (the
functions are elementwise) and compares slices: one compile a case.

Then, with the kernel library replaced by a stand-in that computes the
plain versions on the buffers it is handed, the wrapper's launch path:
the exponent's words and bit length, the Montgomery one, the launch count,
and that `mont_inv`, `FqOps.inv` and `Fq2Ops.inv` reach the entry point.
Last, the packed K6 constant buffer against the permutation's matrices at
width 3 and at a width of the run-time-width kernel (its pre-sparse
matrix laid out by columns). Every comparison is exact (tolerance 0)."""

import ctypes
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.fields import ext as ref_ext
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields import spec as ref_spec
from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
from openzl_tpu_torch.fields import ext, limb
from openzl_tpu_torch.fields import spec as port_spec
from openzl_tpu_torch.ops import ntt_kernel, poseidon_kernel
from openzl_tpu_torch.utils import build

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FIELDS = ["BN254_FR", "BN254_FQ", "BLS12_381_FQ"]
SHAPES = [(1,), (3,), (2, 5)]
EXPONENTS = ["0", "1", "p - 2", "random"]


def _exponent(spec, which: str) -> int:
    if which == "random":
        return random.Random(spec.name).getrandbits(256)
    return {"0": 0, "1": 1, "p - 2": spec.modulus - 2}[which]


def _batches(spec, seed: int):
    """Montgomery limbs (uint32) of one batch per shape of SHAPES: p - 1
    alone, then 0, 1 and a random value, then ten values with a 0."""
    rng = np.random.default_rng(seed)
    p = spec.modulus
    values = [[p - 1], [0, 1, int(rng.integers(1 << 62)) * p // (1 << 62)]]
    values.append([0] + [int.from_bytes(rng.bytes(64), "little") % p for _ in range(9)])
    return [ref_limb.pack_mont(spec, np.array(v, dtype=object).reshape(shape))
            for v, shape in zip(values, SHAPES)]


def _flat(batches):
    return np.concatenate([b.reshape(b.shape[0], -1) for b in batches], axis=1)


def _eq_slices(port_fn, batches, want):
    """port_fn on each batch equals its slice of `want` (the JAX function
    on the flat batch)."""
    start = 0
    for b in batches:
        got = port_fn(limb.tensor(b))
        assert tuple(got.shape) == b.shape
        size = int(np.prod(b.shape[1:]))
        assert np.array_equal(got.numpy().astype(np.uint32).reshape(b.shape[0], -1), want[:, start:start + size])
        start += size


@pytest.mark.parametrize("which", EXPONENTS)
@pytest.mark.parametrize("field", FIELDS)
def test_mont_pow_matches_reference(field, which):
    spec, rspec = getattr(port_spec, field), getattr(ref_spec, field)
    e = _exponent(spec, which)
    batches = _batches(spec, FIELDS.index(field))
    if which == "p - 2":  # the JAX mont_inv is its mont_pow by p - 2: one compile for both
        want = np.asarray(ref_limb.mont_inv(rspec, jnp.asarray(_flat(batches))))
        _eq_slices(lambda a: limb.mont_inv(spec, a), batches, want)
        assert not _flat(batches)[:, 1].any() and not want[:, 1].any()  # 0 maps to 0
    else:
        want = np.asarray(ref_limb.mont_pow(rspec, jnp.asarray(_flat(batches)), e))
    _eq_slices(lambda a: limb.mont_pow(spec, a, e), batches, want)


def test_fq2_inverse_matches_reference():
    rng = random.Random(61)
    p = port_spec.BLS12_381_FQ.modulus
    pairs = np.array([[rng.randrange(p), rng.randrange(p)] for _ in range(5)] + [[0, 1], [1, 0], [p - 1, 0]],
                     dtype=object)
    F, R = ext.fq2_ops(port_spec.BLS12_381_FQ, -1), ref_ext.fq2_ops(ref_spec.BLS12_381_FQ, -1)
    x = F.from_ints(pairs)
    got = F.inv(x)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(R.inv(jnp.asarray(R.from_ints(pairs)))))


# ---------------------------------------------------------------------------
# the wrapper's launch path through a stand-in library
# ---------------------------------------------------------------------------


def _view(ptr: int, n: int, dtype=ctypes.c_int32) -> np.ndarray:
    return np.ctypeslib.as_array((dtype * n).from_address(ptr))


class _FakeLib:
    """Stands in for the kernel library on CPU buffers: K1's product and
    exponentiation compute their plain versions; each exponentiation
    records (N, exponent, bits, Montgomery one) as it read them."""

    def __init__(self, spec):
        self.spec, self.pows = spec, []

    def ozl_mont_mul(self, out, a, b, N, b_ls, b_es, n_limbs, p, n0, stream):
        x = torch.from_numpy(_view(a, n_limbs * N).reshape(n_limbs, N).copy())
        y = torch.from_numpy(_view(b, n_limbs * (N if b_es else 1)).reshape(n_limbs, -1).copy())
        _view(out, n_limbs * N)[:] = ntt_kernel.mont_mul_plain(self.spec, x, y).numpy().reshape(-1)
        return 0

    def ozl_mont_pow(self, out, a, N, e, bits, n_limbs, p, n0, one, stream):
        n_words = max(1, -(-bits // 32))
        words = _view(e, n_words, ctypes.c_uint32)
        exponent = sum(int(w) << (32 * i) for i, w in enumerate(words))
        one_words = _view(one, n_limbs // 2, ctypes.c_uint32)
        self.pows.append((N, exponent, bits, sum(int(w) << (32 * i) for i, w in enumerate(one_words))))
        x = torch.from_numpy(_view(a, n_limbs * N).reshape(n_limbs, N).copy())
        _view(out, n_limbs * N)[:] = ntt_kernel.mont_pow_plain(self.spec, x, exponent).numpy().reshape(-1)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    spec = port_spec.BLS12_381_FQ
    fake = _FakeLib(spec)
    monkeypatch.setattr(ntt_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    for k in (ntt_kernel.K1, ntt_kernel.K1P):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "by_width", {})
        monkeypatch.setattr(k, "by_limbs", {})
    return spec, fake


def test_mont_pow_wrapper_launches_one_kernel(fake_card):
    spec, fake = fake_card
    p = spec.modulus
    a = limb.tensor(limb.pack_mont(spec, np.array([[0, 5, p - 1], [7, 1, 2]], dtype=object)))
    big = (1 << 700) + 12345
    for e in (0, 1, p - 2, big):
        got = ntt_kernel.mont_pow(spec, a[:, :, 1:], e)  # a non-contiguous view
        assert torch.equal(got, ntt_kernel.mont_pow_plain(spec, a[:, :, 1:], e))
        assert fake.pows[-1] == (4, e, e.bit_length(), spec.R % p)
    assert ntt_kernel.K1P.launches == 4 and ntt_kernel.K1P.by_limbs == {24: 4}
    assert ntt_kernel.K1.launches == 0
    with pytest.raises(ValueError):
        ntt_kernel.mont_pow(spec, a, -1)


def test_inverses_reach_the_exponentiation(fake_card):
    """`limb.mont_inv`, `FqOps.inv` and `Fq2Ops.inv` launch K1's
    exponentiation once each by p - 2, and the products around it through
    K1; the results equal the CPU's."""
    spec, fake = fake_card
    p = spec.modulus
    x = limb.tensor(limb.pack_mont(spec, np.array([3, 0, p - 1], dtype=object)))
    F, F2 = ext.fq_ops(spec), ext.fq2_ops(spec, -1)
    y = F2.from_ints(np.array([[3, 4], [0, 1]], dtype=object))
    got = [limb.mont_inv(spec, x), F.inv(x), F2.inv(y)]
    assert [pw[1] for pw in fake.pows] == [p - 2] * 3 and ntt_kernel.K1P.launches == 3
    assert ntt_kernel.K1.launches > 0
    assert torch.equal(got[0], got[1])
    assert F.to_ints(got[0]).tolist() == [pow(3, p - 2, p), 0, p - 1]
    inv = F2.to_ints(got[2])
    assert [tuple(int(c) for c in v) for v in inv][1] == (0, p - 1)  # 1 / u = -u


# ---------------------------------------------------------------------------
# K6's constant buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [3, 5])
def test_k6_buffer_rows_match_the_matrices(width):
    """`_optimized_words` at width 3 (the register kernel) and 5 (the
    run-time-width kernel): every section at its offset, the pre-sparse
    block's row j equal to column j of the matrix (the kernel applies it
    at left), the MDS block's row o to row o."""
    spec = port_spec.BN254_FR
    perm = Poseidon.create(spec, width - 1)
    buf = poseidon_kernel._optimized_words(perm, "cpu").numpy().view(np.uint32)
    nw, rf, rp = spec.n_limbs // 2, perm.full_rounds, perm.partial_rounds

    def w(limbs):  # (n_limbs,) 16-bit limbs -> nw 32-bit words
        limbs = np.asarray(limbs, dtype=np.uint32)
        return limbs[0::2] | (limbs[1::2] << np.uint32(16))

    sizes = [width, (rf - 1) * width, rp, width * width, width * width, rp * width, rp * (width - 1)]
    offsets = np.cumsum([0] + sizes) * nw
    assert len(buf) == offsets[-1]
    section = [buf[a:b].reshape(-1, nw) for a, b in zip(offsets[:-1], offsets[1:])]
    init, fkeys, pkeys, pre, mds, w_hat, v_rest = section
    for j in range(width):
        assert np.array_equal(init[j], w(perm.opt_initial[:, j]))
        for i in range(width):
            assert np.array_equal(pre[j * width + i], w(perm.opt_pre_sparse[:, i, j]))
            assert np.array_equal(mds[j * width + i], w(perm.mds[:, j, i]))
    for r in (0, rf - 2):
        for j in range(width):
            assert np.array_equal(fkeys[r * width + j], w(perm.opt_full_keys[r, :, j]))
    for q in (0, rp - 1):
        assert np.array_equal(pkeys[q], w(perm.opt_partial_keys[q]))
        for i in range(width):
            assert np.array_equal(w_hat[q * width + i], w(perm.opt_w_hat[q, :, i]))
        for i in range(width - 1):
            assert np.array_equal(v_rest[q * (width - 1) + i], w(perm.opt_v_rest[q, :, i]))
