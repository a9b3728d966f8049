"""Edwards curves, the EC gadget and both Schnorr schemes against the JAX
package: the curve constants, native group operations, signatures from the
same seeded rng, the verification circuit's R1CS in setup and prove mode
over Baby Jubjub and Jubjub, and the gadgets under `TorchCompiler` on the
CPU at batch 4 against the reference's `NativeCompiler`. The reference
runs here on host ints only: nothing in this file compiles JAX."""

import os
import random

import numpy as np
import pytest
import torch

from openzl_tpu.crypto import algebra as refalgebra
from openzl_tpu.crypto import ec_gadget as refecg
from openzl_tpu.crypto import signature as refsig
from openzl_tpu.crypto.signature import convert as refconvert
from openzl_tpu.crypto.signature import schnorr as refschnorr
from openzl_tpu.curves import edwards as refed
from openzl_tpu.curves import spec as refcurves
from openzl_tpu.eclair import compilers as refcomp
from openzl_tpu_torch.crypto import algebra
from openzl_tpu_torch.crypto import ec_gadget as ecg
from openzl_tpu_torch.crypto import signature as sig
from openzl_tpu_torch.crypto.signature import convert, schnorr
from openzl_tpu_torch.curves import edwards as ed
from openzl_tpu_torch.curves import spec as curves
from openzl_tpu_torch.eclair import NativeCompiler, R1CSCompiler, TorchCompiler
from openzl_tpu_torch.fields import limb

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SPECS = {"baby_jubjub": (lambda: ed.BABY_JUBJUB, lambda: refed.BABY_JUBJUB),
         "jubjub": (ed.jubjub, refed.jubjub)}


@pytest.fixture(params=list(SPECS), scope="module")
def specs(request):
    port, ref = SPECS[request.param]
    return port(), ref()


def _fields(spec):
    return (spec.name, spec.base.name, spec.base.modulus, spec.a, spec.d, spec.order, spec.cofactor,
            spec.gen, spec.scalar_bits)


def test_curve_constants_match_reference(specs):
    port, ref = specs
    assert _fields(port) == _fields(ref)
    ed.validate(port)
    assert not hasattr(ed, "ed_on_bls12_377")


def test_native_group_operations_match_reference(specs):
    port, ref = specs
    rng = random.Random(1)
    pts = [ed.scalar_mul(port, rng.randrange(port.order), port.gen) for _ in range(4)]
    pts.append(ed.identity())
    for P in pts:
        for Q in pts:
            assert ed.add(port, P, Q) == refed.add(ref, P, Q)
        assert ed.neg(port, P) == refed.neg(ref, P)
        assert ed.is_on_curve(port, P) and ed.double(port, P) == refed.double(ref, P)
    k = rng.randrange(port.order)
    assert ed.scalar_mul(port, k, pts[0]) == refed.scalar_mul(ref, k, pts[0])
    assert ed._sqrt(port.base.modulus, 5) == refed._sqrt(ref.base.modulus, 5)

    # fixed-base (windowed table) and variable-base products under the
    # native compilers
    table = ecg.FixedBaseTable.build(port, port.gen, 3)
    assert table.rows == refecg.FixedBaseTable.build(ref, ref.gen, 3).rows
    com, rcom = NativeCompiler(port.base), refcomp.NativeCompiler(ref.base)
    bits, rbits = com.to_bits_le(k, port.scalar_bits), rcom.to_bits_le(k, ref.scalar_bits)
    fb = ecg.fixed_base_scalar_mul(com, table, bits)
    assert fb.coords() == refecg.fixed_base_scalar_mul(rcom, refecg.FixedBaseTable.build(ref, ref.gen, 3),
                                                        rbits).coords()
    assert fb.coords() == ed.scalar_mul(port, k, port.gen)
    vb = ecg.scalar_mul(com, port, bits[:40], ecg.PointVar(*pts[1]))
    assert vb.coords() == refecg.scalar_mul(rcom, ref, rbits[:40], refecg.PointVar(*pts[1])).coords()


def test_ed_schnorr_signs_and_verifies_as_reference(specs):
    port, ref = specs
    scheme, rscheme = schnorr.EdSchnorr(port), refschnorr.EdSchnorr(ref)
    rng, rrng = random.Random(2), random.Random(2)
    sk, rsk = scheme.generate_key(rng), rscheme.generate_key(rrng)
    assert sk == rsk and scheme.derive(sk) == rscheme.derive(rsk)
    msg = rng.randrange(port.base.modulus)
    assert msg == rrng.randrange(ref.base.modulus)
    s = scheme.sign(sk, 4242, msg)
    rs = rscheme.sign(rsk, 4242, msg)
    assert (s.scalar, s.nonce_point) == (rs.scalar, rs.nonce_point)
    vk, vk2 = scheme.derive(sk), scheme.derive(sk + 1)
    forged = schnorr.EdSchnorrSignature(scalar=(s.scalar + 1) % port.order, nonce_point=s.nonce_point)
    rforged = refschnorr.EdSchnorrSignature(scalar=forged.scalar, nonce_point=s.nonce_point)
    cases = [(vk, msg, s, rs), (vk2, msg, s, rs), (vk, msg + 1, s, rs), (vk, msg, forged, rforged)]
    got = [scheme.verify(v, m, x) for v, m, x, _ in cases]
    assert got == [rscheme.verify(v, m, rx) for v, m, _, rx in cases] == [True, False, False, False]


def _fold(msg):
    """A structured message (a list of ints) -> a one-element message."""
    return [sum(msg)]


def test_group_schnorr_and_converter_match_reference():
    """The hash-based `Schnorr` over BN254 G1 (Poseidon over Fq) and the
    message converter, from the same seeded rng."""
    group, rgroup = algebra.CurveGroup(curves.BN254_G1), refalgebra.CurveGroup(refcurves.BN254_G1)
    scheme, rscheme = sig.Schnorr(group), refsig.Schnorr(rgroup)
    rng, rrng = random.Random(3), random.Random(3)
    sk, rsk = scheme.generate_key(rng), rscheme.generate_key(rrng)
    assert sk == rsk
    r = rng.randrange(1, group.curve.scalar.modulus)
    msg = [5, 6, 7]
    s, rs = scheme.sign(sk, r, msg), rscheme.sign(rsk, r, msg)
    assert (s.scalar, s.nonce_point) == (rs.scalar, rs.nonce_point)
    vk = scheme.derive(sk)
    for m, key in ((msg, vk), ([5, 6, 8], vk), (msg, scheme.derive(sk + 1))):
        assert scheme.verify(key, m, s) == rscheme.verify(key, m, rs) == (m == msg and key == vk)
    wrapped, rwrapped = convert.Converter(scheme, _fold), refconvert.Converter(rscheme, _fold)
    assert wrapped.into_inner() is scheme
    ws, rws = wrapped.sign(sk, r, msg), rwrapped.sign(rsk, r, msg)
    assert (ws.scalar, ws.nonce_point) == (rws.scalar, rws.nonce_point)
    assert wrapped.verify(vk, msg, ws) and rwrapped.verify(vk, msg, rws)
    assert algebra.window_correctness(group, random.Random(4), 4) == refalgebra.window_correctness(
        rgroup, random.Random(4), 4) == True  # noqa: E712
    table = algebra.PrecomputedBaseTable.build(group, group.generator(), 4)
    assert table.table == refalgebra.PrecomputedBaseTable.build(rgroup, rgroup.generator(), 4).table


def _signed(spec, seed):
    scheme = schnorr.EdSchnorr(spec)
    rng = random.Random(seed)
    sk = scheme.generate_key(rng)
    msg = rng.randrange(spec.base.modulus)
    return scheme.derive(sk), msg, scheme.sign(sk, rng.randrange(spec.order), msg)


@pytest.mark.parametrize("mode", ["setup", "prove"])
def test_verification_circuit_matches_reference(specs, mode):
    port, ref = specs
    if mode == "setup":
        com, rcom = R1CSCompiler.for_contexts(port.base), refcomp.R1CSCompiler.for_contexts(ref.base)
        args = rargs = (None, None, None)
    else:
        com, rcom = R1CSCompiler.for_proofs(port.base), refcomp.R1CSCompiler.for_proofs(ref.base)
        vk, msg, s = _signed(port, 5)
        args = (vk, msg, s)
        rargs = (vk, msg, refschnorr.EdSchnorrSignature(s.scalar, s.nonce_point))
    schnorr.verification_circuit(com, port, *args)
    refschnorr.verification_circuit(rcom, ref, *rargs)
    cs, rcs = com.cs, rcom.cs
    assert cs.num_constraints == rcs.num_constraints
    assert (cs.num_instance, cs.num_witness) == (rcs.num_instance, rcs.num_witness) == (3, cs.num_witness)
    for (pr, pc, pv), (rr, rc, rv) in zip(cs.matrices_coo(), rcs.matrices_coo()):
        assert np.array_equal(pr, rr) and np.array_equal(pc, rc) and list(pv) == list(rv)
    if mode == "prove":
        assert cs.assignment() == rcs.assignment()
        assert cs.instance_values == [vk[0], vk[1], msg]
        assert cs.is_satisfied()


def _tensor(spec, vals):
    return limb.tensor(limb.pack_mont(spec.base, vals))


def _ints(spec, t):
    return [int(v) for v in limb.unpack_mont(spec.base, t)]


def test_gadgets_under_torch_compiler_match_reference_native():
    """challenge_gadget, add_points and a 3-bit scalar_mul at batch 4 on the
    CPU (each inversion the plain chain of products)."""
    spec, rspec = ed.BABY_JUBJUB, refed.BABY_JUBJUB
    rng = random.Random(6)
    B = 4
    pts = [ed.scalar_mul(spec, rng.randrange(1, spec.order), spec.gen) for _ in range(2 * B)]
    pts[0] = ed.identity()
    msgs = [rng.randrange(spec.base.modulus) for _ in range(B)]
    ks = [0, 7, 5, 2]
    com = TorchCompiler(spec.base, (B,), device="cpu")
    P = ecg.PointVar(_tensor(spec, [p[0] for p in pts[:B]]), _tensor(spec, [p[1] for p in pts[:B]]))
    Q = ecg.PointVar(_tensor(spec, [p[0] for p in pts[B:]]), _tensor(spec, [p[1] for p in pts[B:]]))
    rnat = refcomp.NativeCompiler(rspec.base)

    c = schnorr.challenge_gadget(com, spec, P, Q, _tensor(spec, msgs))
    assert _ints(spec, c) == [
        refschnorr.challenge_gadget(rnat, rspec, refecg.PointVar(*pts[i]), refecg.PointVar(*pts[B + i]), msgs[i])
        for i in range(B)]

    S = ecg.add_points(com, spec, P, Q)
    want = [refecg.add_points(rnat, rspec, refecg.PointVar(*pts[i]), refecg.PointVar(*pts[B + i])).coords()
            for i in range(B)]
    assert list(zip(_ints(spec, S.x), _ints(spec, S.y))) == want

    bits = com.to_bits_le(_tensor(spec, ks), 3)
    M = ecg.scalar_mul(com, spec, bits, Q)
    want = [refecg.scalar_mul(rnat, rspec, rnat.to_bits_le(ks[i], 3), refecg.PointVar(*pts[B + i])).coords()
            for i in range(B)]
    assert list(zip(_ints(spec, M.x), _ints(spec, M.y))) == want
