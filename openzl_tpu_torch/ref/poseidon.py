"""Pure-Python Poseidon oracle (test reference, not a compute path).

The port's own copy of `openzl_tpu/ref/poseidon.py` (host Python, no JAX).

Mirrors the reference's round structure exactly
(openzl-crypto/src/poseidon/mod.rs:156-283,601-612):
  round r in [0, R_F/2):            add keys, sbox all, MDS
  round r in [R_F/2, R_F/2 + R_P):  add keys, sbox state[0] only, MDS
  round r in [.., R_F + R_P):       add keys, sbox all, MDS

Hashing enters through the same rounds with state = [domain_tag, *inputs]
(openzl-crypto/src/poseidon/hash.rs:95-104), domain tag = 2^arity - 1
(plugins/arkworks/src/poseidon/mod.rs:135-143).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..fields.spec import FieldSpec
from ..crypto.poseidon.param_gen import generate_mds, generate_round_constants


@dataclasses.dataclass(frozen=True)
class PoseidonParams:
    spec: FieldSpec
    width: int
    full_rounds: int
    partial_rounds: int
    round_keys: tuple  # flat, length width * rounds
    mds: tuple  # flat row-major, length width * width

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    @classmethod
    def generate(
        cls, spec: FieldSpec, width: int, full_rounds: int, partial_rounds: int
    ) -> "PoseidonParams":
        keys = generate_round_constants(spec, width, full_rounds, partial_rounds)
        mds = [x for row in generate_mds(spec, width) for x in row]
        return cls(spec, width, full_rounds, partial_rounds, tuple(keys), tuple(mds))


def permute(params: PoseidonParams, state: Sequence[int]) -> List[int]:
    p = params.spec.modulus
    w = params.width
    half = params.full_rounds // 2
    state = [x % p for x in state]
    assert len(state) == w
    for r in range(params.rounds):
        keys = params.round_keys[r * w : (r + 1) * w]
        state = [(x + k) % p for x, k in zip(state, keys)]
        if half <= r < half + params.partial_rounds:
            state[0] = pow(state[0], 5, p)
        else:
            state = [pow(x, 5, p) for x in state]
        state = [
            sum(params.mds[i * w + j] * state[j] for j in range(w)) % p
            for i in range(w)
        ]
    return state


def hash_untruncated(params: PoseidonParams, inputs: Sequence[int]) -> List[int]:
    assert len(inputs) == params.width - 1
    domain_tag = (1 << (params.width - 1)) - 1
    return permute(params, [domain_tag, *inputs])


def hash(params: PoseidonParams, inputs: Sequence[int]) -> int:
    return hash_untruncated(params, inputs)[0]
