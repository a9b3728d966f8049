"""The port's compilers and gadgets against the JAX package.

`TorchCompiler` on the CPU against the reference's `JaxCompiler` (limb
equality in numpy) and `NativeCompiler` (ints) at batch 8 over BN254 Fr,
one op a case on one batch shape, so that each JAX limb op compiles once;
the port's `NativeCompiler` against the reference's; `select_from_table`,
`UnsignedInteger` and `div_rem_mod_prime` under `R1CSCompiler` (matrices,
assignment and `measure` sizes equal to the reference's)."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openzl_tpu.eclair import compilers as refcomp
from openzl_tpu.eclair import gadgets as refgadgets
from openzl_tpu.eclair import measure as refmeasure
from openzl_tpu.fields import limb as reflimb
from openzl_tpu.fields.spec import BN254_FR as REF_FR
from openzl_tpu_torch.eclair import NativeCompiler, R1CSCompiler, TorchCompiler, gadgets, measure
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BN254_FR as FR

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

P = FR.modulus
B = 8


def _values(seed, small=False):
    """8 field elements: 0 and p - 1 first (a 64-bit value in place of
    p - 1 when `small`), then random ones, every other one below 2^64."""
    rng = random.Random(seed)
    vals = [0, (1 << 64) - 1 if small else P - 1]
    vals += [rng.randrange(1 << 64) if i % 2 else rng.randrange(P) for i in range(B - 2)]
    return vals


def _bits(seed):
    rng = random.Random(seed)
    return [bool(rng.getrandbits(1)) for _ in range(B)]


#: name -> (fn(com, *args), arity); args are field elements, except a
#: leading bit for select / swap and all bits for the boolean ops
OPS = {
    "add": (lambda c, a, b: c.add(a, b), 2),
    "sub": (lambda c, a, b: c.sub(a, b), 2),
    "mul": (lambda c, a, b: c.mul(a, b), 2),
    "neg": (lambda c, a: c.neg(a), 1),
    "square": (lambda c, a: c.square(a), 1),
    "pow5": (lambda c, a: c.pow5(a), 1),
    "inv": (lambda c, a: c.inv(a), 1),
    "addc": (lambda c, a: c.add_const(a, 12345), 1),
    "mulc": (lambda c, a: c.mul_const(a, 98765), 1),
    "select": (lambda c, bit, a, b: c.select(bit, a, b), 2),
    "swap": (lambda c, bit, a, b: c.swap(bit, a, b), 2),
    "is_eq": (lambda c, a, b: c.is_eq(a, b), 2),
    "is_zero": (lambda c, a: c.is_zero(a), 1),
    "assert_eq": (lambda c, a, b: c.assert_eq(a, b), 2),
    "bits": (lambda c, a: c.to_bits_le(a, FR.bits), 1),
    "bits_roundtrip": (lambda c, a: c.from_bits_le(c.to_bits_le(a, 64)), 1),
    "range64": (lambda c, a: c.assert_within_bit_range(a, 64), 1),
    "range70": (lambda c, a: c.assert_within_bit_range(a, 70), 1),
    "bool_ops": (lambda c, x, y: [c.and_(x, y), c.or_(x, y), c.xor_(x, y), c.not_(x),
                                  c.and_(x, c.bool_constant(True))], 0),
}


def _native(name, fn, args):
    """The op element by element under the port's NativeCompiler; None
    where the native op asserts (an out-of-range decomposition) or has no
    value (the inverse of 0)."""
    com = NativeCompiler(FR)
    out = []
    for i in range(B):
        xs = [a[i] for a in args]
        if name == "inv" and xs[0] == 0:
            out.append(0)  # the batched inverse maps 0 to 0
            continue
        if name.startswith("range"):
            n = int(name[5:])
            out.append(xs[0] < 1 << n)
            continue
        if name == "assert_eq":
            out.append(com.is_eq(*xs))
            continue
        if name == "bits_roundtrip" and xs[0] >= 1 << 64:
            out.append(None)
            continue
        out.append(fn(com, *xs))
    return out


def _to_host(x):
    """A port or reference result as nested lists of ints / bools."""
    if isinstance(x, (list, tuple)):
        return [_to_host(v) for v in x]
    return np.asarray(x).astype(np.int64).tolist()


@pytest.mark.parametrize("name", list(OPS))
def test_torch_compiler_matches_jax_and_native(name):
    fn, arity = OPS[name]
    tcom = TorchCompiler(FR, (B,), device="cpu")
    jcom = refcomp.JaxCompiler(REF_FR, (B,))
    if name == "bool_ops":
        args = [_bits(1), _bits(2)]
        t_in = [torch.tensor(a) for a in args]
        j_in = [jnp.asarray(a) for a in args]
    else:
        args = [_values(10 + k, small=name == "bits_roundtrip") for k in range(arity)]
        if name in ("is_eq", "assert_eq"):
            args[1] = args[0][:4] + args[1][4:]  # half the pairs equal
        t_in = [limb.tensor(limb.pack_mont(FR, a)) for a in args]
        j_in = [jnp.asarray(reflimb.pack_mont(REF_FR, a)) for a in args]
        if name in ("select", "swap"):
            bit = _bits(3)
            args = [bit] + args
            t_in = [torch.tensor(bit)] + t_in
            j_in = [jnp.asarray(bit)] + j_in
    got = fn(tcom, *t_in)
    want_jax = fn(jcom, *j_in)
    assert _to_host(got) == _to_host(want_jax)

    native = _native(name, fn, args)
    if name == "bool_ops":
        assert _to_host(got) == [[int(v[k]) for v in native] for k in range(5)]
        return
    outs = got if isinstance(got, (list, tuple)) else [got]
    for k, t in enumerate(outs):
        if t.dtype == torch.bool:
            vals = t.tolist()
        else:
            vals = [int(v) for v in limb.unpack_mont(FR, t)]
        for i, v in enumerate(vals):
            w = native[i]
            if w is None:
                continue
            if isinstance(w, (list, tuple)):
                w = w[k]
            assert v == w, (name, k, i)


def test_native_compiler_matches_reference():
    rng = random.Random(5)
    port, ref = NativeCompiler(FR), refcomp.NativeCompiler(REF_FR)
    for _ in range(8):
        a, b = rng.randrange(P), rng.randrange(1, P)
        bit = bool(rng.getrandbits(1))
        small = rng.randrange(1 << 40)
        for com in (port, ref):
            assert com.p == P
        for f in (
            lambda c: [c.constant(a + P), c.public_input(-a), c.secret_witness(b)],
            lambda c: [c.add(a, b), c.sub(a, b), c.neg(a), c.mul(a, b), c.square(a)],
            lambda c: [c.mul_const(a, 7), c.add_const(a, P - 1), c.inv(b), c.pow5(a)],
            lambda c: [c.and_(bit, True), c.or_(bit, False), c.xor_(bit, True), c.not_(bit)],
            lambda c: [c.is_eq(a, a + P), c.is_zero(P), c.select(bit, a, b), c.swap(bit, a, b)],
            lambda c: [c.to_bits_le(small, 40), c.from_bits_le(c.to_bits_le(small, 40)),
                       c.divmod_hint(a, 1 << 100), c.bool_constant(1)],
        ):
            assert f(port) == f(ref)
    for com in (port, ref):
        with pytest.raises(AssertionError):
            com.to_bits_le(1 << 40, 40)
        with pytest.raises(AssertionError):
            com.assert_eq(1, 2)
        with pytest.raises(AssertionError):
            com.assert_within_bit_range(1 << 40, 40)


def _instrument(com, gmod):
    return (measure if gmod is gadgets else refmeasure).Instrument(com)


def _prove_run(com, gmod, x, y, idx):
    """select_from_table (over constants and over variable pairs),
    UnsignedInteger's ops and div_rem_mod_prime in prove mode; returns the
    measured spans."""
    alloc = com.secret_witness
    inst = _instrument(com, gmod)
    with inst.span("select_from_table"):
        bits = com.to_bits_le(alloc(idx), 3)
        table = [com.constant(100 + 7 * i) for i in range(8)]
        com.assert_eq(gmod.select_from_table(com, bits, table), com.constant(100 + 7 * idx))
        pairs = [(alloc(x + i), alloc(y + i)) for i in range(4)]
        sel = gmod.select_from_table(com, bits[:2], pairs)
        com.assert_eq(sel[0], com.constant(x + idx % 4))
    with inst.span("unsigned"):
        u = gmod.U32.new(com, alloc(x % (1 << 32)))
        v = gmod.UnsignedInteger.new(com, alloc(y % (1 << 32)), 32)
        s = u.add(com, v)
        m = u.mul(com, v)
        sh = s.shr(com, 5).shl(com, 3)
        c = u.add_checked(com, gmod.U32.new(com, alloc(1)))
        com.assert_eq(s.is_eq(com, s), com.constant(1))
        m.assert_eq(com, m)
        for w in (s, m, sh, c):
            com.public_input(w.var.value)
    with inst.span("div_rem_mod_prime"):
        gmod.div_rem_mod_prime(com, alloc(x), 2**61 - 1)
        gmod.rem_mod_prime(com, alloc(y), 65521)
    return inst


def _setup_run(com, gmod):
    """The same gadgets in setup mode, on unvalued allocations."""
    alloc = com.secret_witness
    inst = _instrument(com, gmod)
    with inst.span("select_from_table"):
        bits = com.to_bits_le(alloc(None), 3)
        table = [com.constant(100 + 7 * i) for i in range(8)]
        com.assert_eq(gmod.select_from_table(com, bits, table), alloc(None))
    with inst.span("unsigned"):
        u = gmod.U32.new(com, alloc(None))
        v = gmod.UnsignedInteger.new(com, alloc(None), 32)
        u.add(com, v).mul(com, v).shr(com, 5)
    with inst.span("div_rem_mod_prime"):
        gmod.div_rem_mod_prime(com, alloc(None), 2**61 - 1)
    return inst


def _spans(inst):
    return [(label, s.constraints, s.instance_variables, s.witness_variables) for label, s in inst.measurements]


@pytest.mark.parametrize("setup", [False, True], ids=["prove", "setup"])
def test_gadgets_under_r1cs_match_reference(setup):
    """Equal matrices, assignment and measured sizes to the reference's for
    the same inputs."""
    rng = random.Random(6)
    x, y, idx = rng.randrange(P), rng.randrange(P), 5
    if setup:
        port, ref = R1CSCompiler.for_contexts(FR), refcomp.R1CSCompiler.for_contexts(REF_FR)
        got, want = _setup_run(port, gadgets), _setup_run(ref, refgadgets)
    else:
        port, ref = R1CSCompiler.for_proofs(FR), refcomp.R1CSCompiler.for_proofs(REF_FR)
        got, want = _prove_run(port, gadgets, x, y, idx), _prove_run(ref, refgadgets, x, y, idx)
    cs, rcs = port.cs, ref.cs
    assert cs.num_constraints == rcs.num_constraints
    assert (cs.num_instance, cs.num_witness) == (rcs.num_instance, rcs.num_witness)
    for (pr, pc, pv), (rr, rc, rv) in zip(cs.matrices_coo(), rcs.matrices_coo()):
        assert np.array_equal(pr, rr) and np.array_equal(pc, rc) and list(pv) == list(rv)
    assert _spans(got) == _spans(want)
    assert got.report() == want.report()
    whole = measure.measure(port)
    assert (whole.constraints, whole.instance_variables, whole.witness_variables) == (
        rcs.num_constraints, rcs.num_instance, rcs.num_witness)
    if not setup:
        assert cs.assignment() == rcs.assignment()
        assert cs.is_satisfied()


def test_measure_constraints_matches_reference():
    rng = random.Random(8)
    a, b = rng.randrange(P), rng.randrange(P)
    port, ref = R1CSCompiler.for_proofs(FR), refcomp.R1CSCompiler.for_proofs(REF_FR)

    def fn(com):
        x, y = com.secret_witness(a), com.secret_witness(b)
        return com.is_eq(com.pow5(com.mul(x, y)), com.inv(x))

    out, size = measure.measure_constraints(port, fn, port)
    rout, rsize = refmeasure.measure_constraints(ref, fn, ref)
    assert out.value == rout.value
    assert (size.constraints, size.instance_variables, size.witness_variables) == (
        rsize.constraints, rsize.instance_variables, rsize.witness_variables)
    assert size + size == measure.Size(2 * size.constraints, 0, 2 * size.witness_variables)


def test_torch_compiler_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TorchCompiler(FR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchCompiler(FR)
