"""The prover slice's benchmark circuit: a Poseidon hash chain.

h_{i+1} = Poseidon(h_0 .. : h_i, w_i) over `chain` links, with the final
digest as the one public input (knowledge of the chain's preimages), as
`tools/bench_groth16.py` builds it: BN254 Fr, width 3, 8 full and 55
partial rounds. A link is 234 constraints. The gadget and the hash oracle
are the port's copies (`crypto.poseidon.gadget`, `ref.poseidon`), driven by
the port's `R1CSCompiler`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..crypto.poseidon import gadget
from ..fields.spec import FieldSpec
from ..ref import poseidon as refposeidon
from .compilers import R1CSCompiler
from .r1cs import R1CS

WIDTH, FULL_ROUNDS, PARTIAL_ROUNDS = 3, 8, 55


def poseidon_params(fr: FieldSpec) -> refposeidon.PoseidonParams:
    """The chain's Poseidon parameters over `fr`."""
    return refposeidon.PoseidonParams.generate(fr, WIDTH, FULL_ROUNDS, PARTIAL_ROUNDS)


def chain_inputs(params, chain: int, rng) -> Tuple[List[int], int]:
    """(leaf witness [h_0, w_0 .. w_{chain-1}] drawn from `rng`, digest)."""
    p = params.spec.modulus
    witness = [rng.randrange(p) for _ in range(chain + 1)]
    h = witness[0]
    for w in witness[1:]:
        h = refposeidon.hash(params, [h, w])
    return witness, h


def poseidon_chain(
    com: R1CSCompiler,
    params,
    chain: int,
    witness: Optional[Sequence[int]] = None,
    digest: Optional[int] = None,
) -> R1CS:
    """Synthesize the chain into `com` (a context compiler for setup, or a
    proof compiler with the witness and digest) and return its R1CS."""
    h_pub = com.public_input(digest)
    h = com.secret_witness(None if witness is None else witness[0])
    for i in range(chain):
        w = com.secret_witness(None if witness is None else witness[1 + i])
        h = gadget.hash(com, params, [h, w])
    com.assert_eq(h, h_pub)
    return com.cs
