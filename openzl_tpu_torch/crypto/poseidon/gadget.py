"""COM-generic Poseidon: one description for native, JAX, and R1CS backends.

The port's own copy of `openzl_tpu/crypto/poseidon/gadget.py` (host Python, no JAX).

This is the single-source-of-truth property at the heart of the reference
(docs/src/native_nonnative.md): the reference's `Specification<COM>` runs the
same round structure natively and in-circuit (openzl-crypto/src/poseidon/
mod.rs:156-283). Here the same Python function executes under any compiler
from :mod:`openzl_tpu_torch.eclair.compilers`.

R1CS cost (BN254 arity-2, R_F=8, R_P=55): 3 constraints per S-box
(square, square, mul) -> 8*3 + 55 = 79 S-boxes = 237 constraints per
permutation; linear layers are free (matching arkworks' FpVar semantics).
"""

from __future__ import annotations

from typing import List, Sequence

from ...ref.poseidon import PoseidonParams


def permute(com, params: PoseidonParams, state: Sequence) -> List:
    """Apply the Poseidon permutation to `state` under compiler `com`.

    Round structure bit-exact with the reference (poseidon/mod.rs:193-283):
    add round keys, S-box (all lanes in full rounds, lane 0 in partial),
    then the MDS linear layer.
    """
    w = params.width
    assert len(state) == w
    half = params.full_rounds // 2
    state = list(state)
    for r in range(params.rounds):
        keys = params.round_keys[r * w : (r + 1) * w]
        state = [com.add_const(x, k) for x, k in zip(state, keys)]
        if half <= r < half + params.partial_rounds:
            state[0] = com.pow5(state[0])
        else:
            state = [com.pow5(x) for x in state]
        state = _mds(com, params, state)
    return state


def _mds(com, params: PoseidonParams, state: Sequence) -> List:
    w = params.width
    out = []
    for i in range(w):
        acc = com.mul_const(state[0], params.mds[i * w])
        for j in range(1, w):
            acc = com.add(acc, com.mul_const(state[j], params.mds[i * w + j]))
        out.append(acc)
    return out


def hash_untruncated(com, params: PoseidonParams, inputs: Sequence) -> List:
    """state = [domain_tag, *inputs] -> full permuted state
    (openzl-crypto/src/poseidon/hash.rs:95-104; domain tag = 2^arity - 1,
    plugins/arkworks/src/poseidon/mod.rs:123-143)."""
    assert len(inputs) == params.width - 1
    domain_tag = com.constant((1 << (params.width - 1)) - 1)
    return permute(com, params, [domain_tag, *inputs])


def hash(com, params: PoseidonParams, inputs: Sequence):
    return hash_untruncated(com, params, inputs)[0]
