"""Poseidon, optimized Poseidon and Poseidon2 of the port (plain versions of
K5, K6 and K7 on the CPU) against the JAX package, limb for limb (tolerance
0: the same Montgomery limbs).

The full-width instance is BN254 Fr, width 3 (arity 2), at batch 64: random
states from `np.random.default_rng` plus rows of 0, 1 and p - 1, held
against the reference's jnp `Poseidon.permute` and `Poseidon2.permute`
(each jitted once per module; `tests/test_kernels_tpu.py` holds the jnp path
equal to the Pallas kernels) and against the reference's Python-int oracles.
The reference's `permute_optimized` and `hash` entry points are compared on
the repository's 31-bit toy field (`toy_fp32`), where an XLA compile takes
seconds instead of the twenty a 16-limb Poseidon takes, with the same
round numbers and code. The BLS12-381 Fr permutation reproduces the sage
golden vector.
"""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openzl_tpu.crypto.poseidon.permutation import Poseidon as RefPoseidon
from openzl_tpu.crypto.poseidon2 import Poseidon2 as RefPoseidon2
from openzl_tpu.crypto.poseidon2 import permute_ints as ref_p2_ints
from openzl_tpu.curves.spec import toy_curve
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu.ref import poseidon as ref_oracle
from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
from openzl_tpu_torch.ops import poseidon2_kernel, poseidon_kernel
from openzl_tpu_torch.utils import build

# xdist workers share the machine's cores: one torch thread each
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

VECTORS = pathlib.Path(__file__).parent / "vectors"
BATCH = 64


def _states(spec, batch, seed, width=3):
    """(n_limbs, width, batch) Montgomery limbs (uint32, host): rows 0, 1
    and p - 1 in every element, then uniform values from a seeded numpy
    generator."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    vals = np.empty((width, batch), dtype=object)
    for j in range(width):
        vals[j, :3] = [0, 1, p - 1]
        for b in range(3, batch):
            vals[j, b] = int.from_bytes(rng.bytes(spec.n_bytes + 8), "little") % p
    return vals, ref_limb.pack_mont(spec, vals)


def _eq(got, want):
    """Exact equality of limb arrays across dtypes (port int32, JAX uint32)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _reference_run(ref, seed):
    """The reference's jnp permutation (one jit compile) of seeded states
    and of the same states with element 0 replaced by the hash domain tag."""
    vals, x = _states(REF_BN254_FR, BATCH, seed)
    tagged = x.copy()
    tagged[:, 0] = ref.domain_tag_mont()[:, None]
    permute = jax.jit(ref.permute)
    return vals, x, np.asarray(permute(jnp.asarray(x))), np.asarray(permute(jnp.asarray(tagged)))


@pytest.fixture(scope="module")
def bn254_classic():
    ref = RefPoseidon.create(REF_BN254_FR, 2)
    return (ref,) + _reference_run(ref, 1)


@pytest.fixture(scope="module")
def bn254_poseidon2():
    ref = RefPoseidon2.create(REF_BN254_FR, 2)
    return (ref,) + _reference_run(ref, 2)


def test_classic_bn254_matches_jnp_permute_and_oracles(bn254_classic):
    ref, vals, x, want, want_tagged = bn254_classic
    port = Poseidon.create(BN254_FR, 2, device="cpu")
    _eq(port.permute(x), want)
    _eq(port.permute_optimized(x), want)
    # the reference's hash is lane 0 of the permutation of [2^arity - 1, a, b]
    _eq(port.hash(x[:, 1:]), want_tagged[:, 0])
    # the reference's Python-int oracles on the edge rows and a random one
    params = ref_oracle.PoseidonParams.generate(REF_BN254_FR, 3, 8, 55)
    opt = ref_oracle.OptimizedPoseidonParams.derive(params)
    got = limb.unpack_mont(BN254_FR, port.permute_optimized(x[..., [0, 1, 2, 3]]))
    for b in range(4):
        state = [int(v) for v in vals[:, b]]
        assert [int(v) for v in got[:, b]] == ref_oracle.permute(params, state)
        assert ref_oracle.permute_optimized(opt, state) == ref_oracle.permute(params, state)
    h = limb.unpack_mont(BN254_FR, port.hash(x[:, 1:, :4]))
    assert [int(v) for v in h] == [ref_oracle.hash(params, [int(a), int(c)]) for a, c in vals[1:, :4].T]


def test_poseidon2_bn254_matches_jnp_permute_and_oracle(bn254_poseidon2):
    ref, vals, x, want, want_tagged = bn254_poseidon2
    port = Poseidon2.create(BN254_FR, 2, device="cpu")
    _eq(port.permute(x), want)
    _eq(port.hash(x[:, 1:]), want_tagged[:, 0])
    got = limb.unpack_mont(BN254_FR, port.permute(x[..., :4]))
    for b in range(4):
        state = [int(v) for v in vals[:, b]]
        want_b = ref_p2_ints(REF_BN254_FR, 3, 8, 56, ref.ext_keys_int, ref.int_keys_int, state)
        assert [int(v) for v in got[:, b]] == want_b


def test_toy_field_entry_points_match_jnp():
    """permute, permute_optimized and hash of both permutations against the
    reference's jnp entry points, and the squeezed (n_limbs, width) form."""
    spec = toy_curve().base
    _, x = _states(spec, BATCH, 3)
    jx = jnp.asarray(x)
    ref, port = RefPoseidon.create(spec, 2), Poseidon.create(spec, 2, device="cpu")
    _eq(port.permute(x), ref.permute(jx))
    _eq(port.permute_optimized(x), ref.permute_optimized(jx))
    _eq(port.hash(x[:, 1:]), ref.hash(jx[:, 1:]))
    _eq(port.permute(x[..., 5]), np.asarray(ref.permute(jx))[..., 5])
    ref2, port2 = RefPoseidon2.create(spec, 2), Poseidon2.create(spec, 2, device="cpu")
    _eq(port2.permute(x), ref2.permute(jx))
    _eq(port2.hash(x[:, 1:]), ref2.hash(jx[:, 1:]))


@pytest.mark.parametrize("arity", [2, 4])
def test_from_reference_equals_create(arity):
    ref = RefPoseidon.create(REF_BN254_FR, arity)
    port = Poseidon.create(BN254_FR, arity, device="cpu")
    carried = Poseidon.from_reference(ref, device="cpu")
    for name in ("round_keys", "mds", "opt_initial", "opt_full_keys", "opt_partial_keys",
                 "opt_pre_sparse", "opt_w_hat", "opt_v_rest"):
        _eq(getattr(port, name), getattr(ref, name))
        _eq(getattr(carried, name), getattr(ref, name))
    assert (carried.width, carried.full_rounds, carried.partial_rounds) == (
        port.width, port.full_rounds, port.partial_rounds)
    ref2 = RefPoseidon2.create(REF_BN254_FR, 2)
    for p2 in (Poseidon2.create(BN254_FR, 2, device="cpu"), Poseidon2.from_reference(ref2, device="cpu")):
        _eq(p2.ext_keys, ref2.ext_keys)
        _eq(p2.int_keys, ref2.int_keys)
        assert p2.diag == ref2.diag


def test_bls12_381_golden_vector():
    vec = json.loads((VECTORS / "poseidon_perm_width3_bls381.json").read_text())
    port = Poseidon.create(BLS12_381_FR, 2, device="cpu")
    state = limb.pack_mont(BLS12_381_FR, np.array([[int(v)] for v in vec["input"]], dtype=object))
    for out in (port.permute(state), port.permute_optimized(state)):
        assert [int(v) for v in limb.unpack_mont(BLS12_381_FR, out)[:, 0]] == [int(v) for v in vec["output"]]


def test_entry_points_default_to_cuda_and_wrappers_refuse_unbuilt_states(monkeypatch):
    """numpy inputs go to the instance's device, cuda unless asked; a CUDA
    state the kernels were not built for is refused before any launch
    (checked on CPU tensors through the wrappers, their device check
    patched to "cuda" and the library to one that fails if called): a
    width outside the built set (2 to 17 for K5 and K6; 2, 3, 4, 8 and 12
    for K7), K5's split variant at a width but 3, and an int64 state."""
    assert Poseidon.create(BN254_FR, 2).device == torch.device("cuda")
    assert Poseidon2.create(BN254_FR, 2).device == torch.device("cuda")

    def no_library():
        raise AssertionError("the library was called")

    monkeypatch.setattr(poseidon_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(poseidon2_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", no_library)
    perm = Poseidon.create(BN254_FR, 4, device="cpu")
    state = torch.zeros((BN254_FR.n_limbs, 5, 8), dtype=torch.int32)
    poseidon_kernel.check_state(perm, state)  # width 5 is built for K5 and K6
    with pytest.raises(ValueError, match="split variant is built for width 3 only, not width 5"):
        poseidon_kernel.permute(perm, state, "split")
    wide = dataclasses.replace(perm, width=18, _dev={})
    state18 = torch.zeros((BN254_FR.n_limbs, 18, 8), dtype=torch.int32)
    for fn in (poseidon_kernel.permute, poseidon_kernel.permute_optimized):
        with pytest.raises(ValueError, match="widths 2, 3, .*, 17 and 16 limbs, not width 18"):
            fn(wide, state18)
    p2 = dataclasses.replace(Poseidon2.create(BN254_FR, 2, device="cpu"), width=5, _dev={})
    with pytest.raises(ValueError, match="widths 2, 3, 4, 8, 12 and 16 limbs, not width 5"):
        poseidon2_kernel.permute(p2, state)
    with pytest.raises(ValueError, match="int32"):
        poseidon_kernel.permute(perm, state.long())
