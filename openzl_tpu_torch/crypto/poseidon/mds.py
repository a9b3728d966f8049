"""Derived MDS matrices and sparse factorization for optimized Poseidon.

The port's own copy of `openzl_tpu/crypto/poseidon/mds.py` (host Python, no JAX).

The optimized permutation replaces the dense width x width MDS product in
every partial round with a sparse product costing ``2*width - 1``
multiplications. This module derives the required matrices from the Cauchy
MDS matrix ``m``:

  * ``m_prime``:  block-diagonal [[1, 0], [0, m_hat]] — touches only the
    last width-1 state elements, so it commutes with the partial S-box.
  * ``m_double_prime``: sparse (dense first row + first column, identity
    elsewhere) with ``m = m_prime @ m_double_prime`` in the row-vector-at-
    left convention.
  * ``factor_to_sparse_matrices``: folds the factorization across all
    partial rounds, yielding one dense "pre-sparse" matrix applied at the
    full/partial boundary and one sparse matrix per partial round.

Reference parity: openzl-crypto/src/poseidon/mds.rs:15-181 (MdsMatrices,
factor_to_sparse_matrixes), which follows filecoin-neptune; see the hackmd
note referenced there for the derivation. Conformance: optimized == naive
permutation property tests (tests/test_poseidon_optimized.py).
"""

from __future__ import annotations

import dataclasses
from typing import List

from . import matrix
from .matrix import Matrix, SparseMatrix


@dataclasses.dataclass(frozen=True)
class MdsMatrices:
    """MDS matrix plus everything optimized Poseidon derives from it
    (reference mds.rs:15-31)."""

    m: Matrix
    m_inv: Matrix
    m_hat: Matrix
    m_hat_inv: Matrix
    m_prime: Matrix
    m_double_prime: Matrix


def _make_prime(m: Matrix) -> Matrix:
    """[[1, 0], [0, m_hat]] (reference mds.rs:48-67)."""
    n = len(m)
    out = matrix.zeros(n, n)
    out[0][0] = 1
    for i in range(1, n):
        out[i][1:] = list(m[i][1:])
    return out


def _make_double_prime(p: int, m: Matrix, m_hat_inv: Matrix) -> Matrix:
    """Sparse complement: first row [m00, v], first column below = w_hat =
    w^T @ m_hat_inv, identity elsewhere (reference mds.rs:103-131)."""
    n = len(m)
    v = m[0][1:]
    w = [m[i][0] for i in range(1, n)]
    w_hat = matrix.mul_row_vec_at_left(p, m_hat_inv, w)
    out = matrix.identity(n)
    out[0][0] = m[0][0]
    out[0][1:] = list(v)
    for i in range(1, n):
        out[i][0] = w_hat[i - 1]
    return out


def derive_mds_matrices(p: int, m: Matrix) -> MdsMatrices:
    """Derive all optimized-Poseidon matrices from ``m``
    (reference mds.rs:133-152)."""
    m_inv = matrix.inverse(p, m)
    assert m_inv is not None, "MDS matrix must be invertible"
    m_hat = matrix.minor(m, 0, 0)
    m_hat_inv = matrix.inverse(p, m_hat)
    assert m_hat_inv is not None, "MDS minor must be invertible"
    m_prime = _make_prime(m)
    m_double_prime = _make_double_prime(p, m, m_hat_inv)
    return MdsMatrices(m, m_inv, m_hat, m_hat_inv, m_prime, m_double_prime)


def factor_to_sparse_matrices(
    p: int, base: Matrix, n_rounds: int
) -> tuple[Matrix, List[SparseMatrix]]:
    """Fold the M = M' @ M'' factorization across ``n_rounds`` partial
    rounds (reference mds.rs:155-181).

    Returns ``(pre_sparse, sparse)``: apply ``pre_sparse`` (dense) after the
    last first-half full round, then ``sparse[i]`` after partial round i.
    """
    curr = base
    sparse: List[Matrix] = []
    for _ in range(n_rounds):
        derived = derive_mds_matrices(p, curr)
        sparse.append(derived.m_double_prime)
        curr = matrix.matmul(p, base, derived.m_prime)
    sparse.reverse()
    return curr, [SparseMatrix.from_dense(s) for s in sparse]
