"""Round-constant compression for optimized Poseidon.

The port's own copy of `openzl_tpu/crypto/poseidon/preprocessing.py` (host Python, no JAX).

Pushes the per-round pre-S-box constant additions backwards through the
linear layers (and through the identity part of partial layers) so that in
the optimized permutation constants are only added *after* each S-box —
partial rounds then add a single constant instead of ``width`` of them.

Output layout (consumed sequentially by the optimized permutation):

  [0, width)                          initial pre-add (round 0, unchanged)
  (half_full - 1) rows of ``width``   post-S-box adds, first-half full rounds
  1 row of ``width``                  post-S-box add of the boundary round
                                      (before the pre-sparse matrix product)
  ``partial_rounds`` single keys      post-S-box add per partial round
  (half_full - 1) rows of ``width``   post-S-box adds, last-half full rounds
                                      (the final round has no constant)

Total: width * full_rounds + partial_rounds constants, versus the naive
width * (full_rounds + partial_rounds).

Reference parity: openzl-crypto/src/poseidon/preprocessing.rs:13-82
(compress_round_constants, adapted there from filecoin-neptune).
Conformance: optimized == naive permutation property tests.
"""

from __future__ import annotations

from typing import List, Sequence

from . import matrix
from .mds import MdsMatrices


def compress_round_constants(
    p: int,
    width: int,
    full_rounds: int,
    partial_rounds: int,
    round_constants: Sequence[int],
    mds: MdsMatrices,
) -> List[int]:
    """Compress naive round constants (row-major by round) into post-S-box
    form (reference preprocessing.rs:13-82)."""
    m_inv = mds.m_inv

    def round_keys(r: int) -> List[int]:
        return list(round_constants[r * width : (r + 1) * width])

    half = full_rounds // 2
    res: List[int] = round_keys(0)

    # First-half full rounds: next round's pre-add, pulled back through M.
    for i in range(half - 1):
        res.extend(matrix.mul_row_vec_at_left(p, m_inv, round_keys(i + 1)))

    # Partial rounds, walked backwards from the first last-half full round:
    # invert through M, peel off the element-0 component (the only one that
    # must land right after that round's S-box), fold the rest into the
    # previous round's constants.
    partial_keys: List[int] = []
    final_round = half + partial_rounds
    acc = round_keys(final_round)
    for i in range(partial_rounds):
        inverted = matrix.mul_row_vec_at_left(p, m_inv, acc)
        partial_keys.append(inverted[0])
        inverted[0] = 0
        acc = matrix.vec_add(p, round_keys(final_round - i - 1), inverted)
    res.extend(matrix.mul_row_vec_at_left(p, m_inv, acc))
    res.extend(reversed(partial_keys))

    # Last-half full rounds (final round consumes no constant).
    for i in range(1, half):
        res.extend(
            matrix.mul_row_vec_at_left(p, m_inv, round_keys(i + half + partial_rounds))
        )
    return res
