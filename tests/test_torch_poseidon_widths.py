"""Poseidon and Poseidon2 of the port at every state width its kernels are
built for, held against the JAX package on the CPU (tolerance 0: the same
round numbers, the same Montgomery limbs, the same field elements).

- Round numbers: the port's own `constants.from_arity` (the security
  search `Poseidon.create` runs for a width the reference pins none for)
  against the JAX package's at arities 6, 7 and 10, at 254 and 255 bits;
  `Poseidon.create`'s round numbers at every built width against the
  pinned table or the JAX package's search results (`SEARCHED`, which
  `test_from_arity_matches_reference` runs live at three of them).
- Poseidon at the reference's pinned widths 2, 4, 5, 6, 9 and 17 and a
  searched one (7 over BN254 Fr, 8 over BLS12-381 Fr): `create`'s round
  numbers and parameter arrays against `Poseidon.from_reference` of the
  JAX package's `Poseidon.create`, then the port's `permute`,
  `permute_optimized` and `hash` on `device="cpu"` (the plain K5 and K6)
  against the JAX package's Python-int oracle (`openzl_tpu/ref/poseidon.py`
  `permute`, `permute_optimized`, `hash`) on 4 states: rows of p - 1 and 0
  and two of uniform values from a seeded numpy generator. The other
  widths run the same code with other loop bounds; each of their JAX
  instances costs 2-5 s of the JAX package's host code.
- Poseidon2 at widths 2, 4, 8 and 12: `create` against the JAX package's
  (at 2 and 4 its `create`; at 8 and 12 its round-key generator and the
  internal diagonal its search returns, recorded in `DIAGONALS`, which
  `permute_ints` then takes too: the search takes 10-35 s, one check of a
  diagonal 15-60 s) and the plain K7 and `hash` against its
  `permute_ints`.
- The plain K7 on the worst-case state (every element p - 1, the largest
  input of every linear-layer sum the kernel leaves unreduced) at every
  built width over both fields, against the JAX package's `permute_ints`
  on the port's round keys and diagonal; and over two 16-limb primes
  past `F1c`'s bound (the card's K7 runs them on F1) with seeded keys and
  diagonal.
- The port's Rabin irreducibility test against the JAX package's.
- One XLA compile per family: the JAX package's jnp `Poseidon.permute` at
  width 5 and `Poseidon2.permute` at width 2 against the port's `permute`
  and `hash`. The two compiles take most of this file's time.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openzl_tpu.crypto import poseidon2 as ref_p2
from openzl_tpu.crypto.poseidon import constants as ref_constants
from openzl_tpu.crypto.poseidon import param_gen as ref_param_gen
from openzl_tpu.crypto.poseidon.permutation import Poseidon as RefPoseidon
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BLS12_381_FR as REF_BLS12_381_FR
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu.fields.spec import FieldSpec as RefFieldSpec
from openzl_tpu.ref import poseidon as ref_oracle
from openzl_tpu_torch.crypto import poseidon2
from openzl_tpu_torch.crypto.poseidon import constants
from openzl_tpu_torch.crypto.poseidon.permutation import ROUND_NUMBERS, Poseidon, round_numbers
from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR, FieldSpec
from openzl_tpu_torch.ops import poseidon2_kernel, poseidon_kernel

# xdist workers share the machine's cores: one torch thread each
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FIELDS = {"bn254_fr": (BN254_FR, REF_BN254_FR), "bls12_381_fr": (BLS12_381_FR, REF_BLS12_381_FR)}
NEW_WIDTHS = [w for w in poseidon_kernel.KERNEL_WIDTHS if w != 3]
#: the widths held against the JAX package's instances: its pinned ones
#: and a searched one per field
REF_WIDTHS = {"bn254_fr": (2, 4, 5, 6, 7, 9, 17), "bls12_381_fr": (2, 5, 8, 9, 17)}
#: (R_F, R_P) the JAX package's `from_arity` returns for the widths it pins
#: none for, the same at 254 and 255 bits
SEARCHED = {7: (8, 56), 8: (8, 57), 10: (8, 57), 11: (8, 57), 12: (8, 57), 13: (8, 57), 14: (8, 57),
            15: (8, 57), 16: (8, 59)}
#: the internal diagonal the JAX package's `internal_matrix` search returns
DIAGONALS = {("bn254_fr", 8): (1, 2, 3, 4, 5, 6, 7, 19), ("bn254_fr", 12): (*range(1, 12), 19)}
BATCH = 4
ARRAYS = ("round_keys", "mds", "opt_initial", "opt_full_keys", "opt_partial_keys", "opt_pre_sparse",
          "opt_w_hat", "opt_v_rest")


def _values(spec, width, seed):
    """(width, BATCH) field elements: a state of p - 1, a state of 0, then
    uniform values from a seeded numpy generator."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    vals = np.empty((width, BATCH), dtype=object)
    vals[:, 0], vals[:, 1] = p - 1, 0
    for j in range(width):
        for b in range(2, BATCH):
            vals[j, b] = int.from_bytes(rng.bytes(spec.n_bytes + 8), "little") % p
    return vals


def _ints(spec, t: torch.Tensor):
    """Montgomery limbs (n_limbs, *batch) -> Python ints (*batch)."""
    return limb.unpack_mont(spec, t.numpy())


@pytest.mark.parametrize("bits", [254, 255])
@pytest.mark.parametrize("arity", [6, 7, 10])
def test_from_arity_matches_reference(arity, bits):
    got = constants.from_arity(arity, modulus_bits=bits)
    want = ref_constants.from_arity(arity, modulus_bits=bits)
    assert (got.width, got.full_rounds, got.partial_rounds) == (want.width, want.full_rounds, want.partial_rounds)
    assert (got.full_rounds, got.partial_rounds) == SEARCHED[arity + 1]


@pytest.mark.parametrize("width", NEW_WIDTHS)
@pytest.mark.parametrize("field", FIELDS)
def test_round_numbers_at_every_width(field, width):
    """The round numbers `Poseidon.create` takes at each built width."""
    assert set(NEW_WIDTHS) == set(ROUND_NUMBERS) - {3} | set(SEARCHED)
    assert round_numbers(width, FIELDS[field][0].bits) == ROUND_NUMBERS.get(width, SEARCHED.get(width))


@pytest.mark.parametrize("field,width", [(f, w) for f, ws in REF_WIDTHS.items() for w in ws])
def test_poseidon_width_matches_reference(field, width):
    spec, ref_spec = FIELDS[field]
    arity = width - 1
    ref = RefPoseidon.create(ref_spec, arity)
    port = Poseidon.create(spec, arity, device="cpu")
    carried = Poseidon.from_reference(ref, device="cpu")
    rounds = (port.full_rounds, port.partial_rounds)
    assert rounds == (ref.full_rounds, ref.partial_rounds) == (carried.full_rounds, carried.partial_rounds)
    assert rounds == ROUND_NUMBERS.get(width, SEARCHED.get(width))
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(carried, name), np.asarray(getattr(ref, name)), err_msg=name)

    # the JAX package's Python-int oracle over the same integer parameters
    keys = [int(v) for r in range(ref.rounds) for v in ref_limb.unpack_mont(ref_spec, np.asarray(ref.round_keys[r]))]
    mds = [int(v) for v in ref_limb.unpack_mont(ref_spec, np.asarray(ref.mds)).reshape(-1)]
    params = ref_oracle.PoseidonParams(ref_spec, width, ref.full_rounds, ref.partial_rounds, tuple(keys), tuple(mds))
    opt = ref_oracle.OptimizedPoseidonParams.derive(params)
    vals = _values(spec, width, seed=width)
    state = limb.tensor(limb.pack_mont(spec, vals), "cpu")
    cols = [[int(v) for v in vals[:, b]] for b in range(BATCH)]
    want = [ref_oracle.permute(params, c) for c in cols]
    assert [ref_oracle.permute_optimized(opt, c) for c in cols] == want
    for out in (port.permute(state), port.permute_optimized(state)):
        assert [[int(v) for v in col] for col in _ints(spec, out).T] == want
    digest = port.hash(state[:, 1:])
    assert [int(v) for v in _ints(spec, digest)] == [ref_oracle.hash(params, c[1:]) for c in cols]


@pytest.mark.parametrize("field,width", [("bn254_fr", 2), ("bn254_fr", 4), ("bn254_fr", 8), ("bn254_fr", 12),
                                         ("bls12_381_fr", 2), ("bls12_381_fr", 4)])
def test_poseidon2_width_matches_reference(field, width, monkeypatch):
    spec, ref_spec = FIELDS[field]
    port = Poseidon2.create(spec, width - 1, device="cpu")
    rf, rp = ref_p2.ROUND_NUMBERS_128[width]
    if (field, width) in DIAGONALS:
        # the JAX package's create, without its diagonal search
        lfsr = ref_param_gen.generate_lfsr(ref_spec.bits, width, rf, rp)
        flat = [ref_param_gen.sample_field_element(lfsr, ref_spec) for _ in range(rf * width + rp)]
        ext = [flat[r * width:(r + 1) * width] for r in range(rf)]
        ints = flat[rf * width:]
        diag = DIAGONALS[field, width]
        monkeypatch.setattr(ref_p2, "internal_matrix", lambda p, w: diag)  # for permute_ints
        ext_arr = np.moveaxis(ref_limb.pack_mont(ref_spec, np.array(ext, dtype=object)), 0, 1)
        int_arr = np.moveaxis(ref_limb.pack_mont(ref_spec, np.array(ints, dtype=object)), 0, 1)
        ports = (port,)
    else:
        ref = ref_p2.Poseidon2.create(ref_spec, width - 1)
        ext = [[int(v) for v in ref_limb.unpack_mont(ref_spec, np.asarray(ref.ext_keys[r]))] for r in range(rf)]
        ints = [int(v) for v in ref_limb.unpack_mont(ref_spec, np.asarray(ref.int_keys).T)]
        ext_arr, int_arr, diag = np.asarray(ref.ext_keys), np.asarray(ref.int_keys), tuple(ref.diag)
        ports = (port, Poseidon2.from_reference(ref, device="cpu"))
    for p2 in ports:
        assert (p2.width, p2.full_rounds, p2.partial_rounds) == (width, rf, rp)
        np.testing.assert_array_equal(p2.ext_keys, ext_arr)
        np.testing.assert_array_equal(p2.int_keys, int_arr)
        assert p2.diag == diag

    def oracle(col):
        return ref_p2.permute_ints(ref_spec, width, rf, rp, ext, ints, col)

    vals = _values(spec, width, seed=100 + width)
    state = limb.tensor(limb.pack_mont(spec, vals), "cpu")
    cols = [[int(v) for v in vals[:, b]] for b in range(BATCH)]
    got = port.permute(state)
    assert [[int(v) for v in col] for col in _ints(spec, got).T] == [oracle(c) for c in cols]
    tag = (1 << (width - 1)) - 1
    digest = port.hash(state[:, 1:])
    assert [int(v) for v in _ints(spec, digest)] == [oracle([tag, *c[1:]])[0] for c in cols]
    assert width in poseidon2_kernel.KERNEL_WIDTHS


@pytest.mark.parametrize("width", poseidon2_kernel.KERNEL_WIDTHS)
@pytest.mark.parametrize("field", FIELDS)
def test_poseidon2_plain_takes_the_worst_case_state(field, width, monkeypatch):
    """Every element p - 1, and a zero state beside it, through the plain
    K7 against the JAX package's Python-int oracle with the port's round
    keys and internal diagonal (the oracle's diagonal search replaced by
    the port's result)."""
    spec, ref_spec = FIELDS[field]
    port = Poseidon2.create(spec, width - 1, device="cpu")
    ext = [[int(v) for v in limb.unpack_mont(spec, np.ascontiguousarray(port.ext_keys[r]))]
           for r in range(port.full_rounds)]
    ints = [int(v) for v in limb.unpack_mont(spec, np.ascontiguousarray(port.int_keys.T))]
    monkeypatch.setattr(ref_p2, "internal_matrix", lambda p, w: port.diag)
    cols = [[spec.modulus - 1] * width, [0] * width]
    state = limb.tensor(limb.pack_mont(spec, np.array(cols, dtype=object).T), "cpu")
    got = [[int(v) for v in col] for col in _ints(spec, poseidon2_kernel.poseidon2_permute_plain(port, state)).T]
    assert got == [ref_p2.permute_ints(ref_spec, width, port.full_rounds, port.partial_rounds, ext, ints, c)
                   for c in cols]


#: 16-limb primes k 2^32 + 1 (5 not dividing k) with p's top word at
#: `F1c`'s bound (0x7FFFFFFF) and at its largest: K7 runs them on F1
F1_PRIMES = {
    "top_7fffffff": 0x7FFFFFFF00000000000000000000000000000000000000000000004700000001,
    "top_ffffffff": 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFD500000001,
}


@pytest.mark.parametrize("width", poseidon2_kernel.KERNEL_WIDTHS)
@pytest.mark.parametrize("prime", F1_PRIMES)
def test_poseidon2_plain_on_primes_past_the_carry_chain_bound(prime, width, monkeypatch):
    """The plain K7 over the two primes the card's K7 runs on F1, with
    seeded round keys and a diagonal of 2 to 40 (as the card's test of
    that instantiation builds them), on the worst-case state, a zero state
    and random ones, against the JAX package's Python-int oracle given the
    same keys and diagonal."""
    p = F1_PRIMES[prime]
    spec, ref_spec = FieldSpec(prime, p), RefFieldSpec(prime, p)
    rng = np.random.default_rng(width)
    rand = lambda *shape: np.array([int.from_bytes(rng.bytes(40), "little") % p for _ in range(int(np.prod(shape)))],
                                   dtype=object).reshape(shape)
    full, partial = poseidon2.ROUND_NUMBERS_128[width]
    ext, ints = rand(full, width), rand(partial)
    diag = tuple(int(d) for d in rng.integers(2, 41, width))
    port = Poseidon2(spec, width, full, partial, np.moveaxis(limb.pack_mont(spec, ext), 0, 1),
                     np.moveaxis(limb.pack_mont(spec, ints), 0, 1), diag, torch.device("cpu"))
    monkeypatch.setattr(ref_p2, "internal_matrix", lambda p, w: diag)
    vals = rand(width, BATCH)
    vals[:, 0], vals[:, 1] = p - 1, 0
    state = limb.tensor(limb.pack_mont(spec, vals), "cpu")
    got = [[int(v) for v in col] for col in _ints(spec, poseidon2_kernel.poseidon2_permute_plain(port, state)).T]
    assert got == [ref_p2.permute_ints(ref_spec, width, full, partial, [[int(v) for v in r] for r in ext],
                                       [int(v) for v in ints], [int(v) for v in col]) for col in vals.T]


@pytest.mark.parametrize("field", FIELDS)
def test_irreducibility_test_matches_reference(field):
    """The port's Rabin test (x^(p^k) through the Frobenius matrix) against
    the JAX package's (an exponentiation by p for each k), on the
    characteristic polynomials of ones + diag(mu) at widths 2-5, where
    small diagonals pass and fail."""
    p = FIELDS[field][0].modulus
    for width in (2, 3, 4, 5):
        for diag in ((1,) * width, tuple(range(1, width + 1)), (1, 2, 3, 10, 11)[:width]):
            m = [[1 + (i == j) * diag[i] for j in range(width)] for i in range(width)]
            f = ref_p2._char_poly(p, m)
            assert poseidon2._is_irreducible(p, f) == ref_p2._is_irreducible(p, f), (width, diag)


@pytest.mark.parametrize("family,width", [("poseidon", 5), ("poseidon2", 2)])
def test_jnp_permutation_at_another_width_matches(family, width):
    """One XLA compile per family: the JAX package's jnp Poseidon at width 5
    and Poseidon2 at width 2 (at width 4 its jnp permutation takes about
    two minutes to compile on the CPU, against 27 s at width 2) against
    the port's `permute` and `hash`."""
    cls, port_cls = {"poseidon": (RefPoseidon, Poseidon), "poseidon2": (ref_p2.Poseidon2, Poseidon2)}[family]
    ref = cls.create(REF_BN254_FR, width - 1)
    port = port_cls.from_reference(ref, device="cpu")
    vals = _values(BN254_FR, width, seed=7 * width)
    vals[0] = (1 << (width - 1)) - 1  # the domain tag, so that element 0 is also the hash
    limbs = ref_limb.pack_mont(REF_BN254_FR, vals)
    want = np.asarray(ref.permute(jnp.asarray(limbs)))
    np.testing.assert_array_equal(port.permute(limbs).numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(port.hash(limbs[:, 1:]).numpy(), want[:, 0].astype(np.int32))
