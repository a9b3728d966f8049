"""Dense linear algebra over prime fields (host-side cold path).

The port's own copy of `openzl_tpu/crypto/poseidon/matrix.py` (host Python, no JAX).

Support layer for the optimized-Poseidon parameter derivation: matrix
inverse (Gaussian elimination), minors, triangularization — everything the
derived-MDS construction needs. Operates on Python-int matrices modulo
``spec.modulus``; this only runs during parameter generation, never in the
jitted compute path.

Reference parity: openzl-crypto/src/poseidon/matrix.rs:35-120 (Matrix /
SquareMatrix / MatrixOperations: matmul, inverse, minor, transpose,
upper_triangular, reduce_to_identity). Re-designed around plain list-of-list
Python ints — the reference's trait machinery dissolves.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

Matrix = List[List[int]]


def zeros(rows: int, cols: int) -> Matrix:
    return [[0] * cols for _ in range(rows)]


def identity(n: int) -> Matrix:
    m = zeros(n, n)
    for i in range(n):
        m[i][i] = 1
    return m


def is_square(m: Matrix) -> bool:
    return all(len(row) == len(m) for row in m)


def transpose(m: Matrix) -> Matrix:
    return [list(col) for col in zip(*m)]


def matmul(p: int, a: Matrix, b: Matrix) -> Matrix:
    """a @ b mod p; shapes (r,k) x (k,c)."""
    assert len(a[0]) == len(b), "inner dimensions must match"
    bt = transpose(b)
    return [[sum(x * y for x, y in zip(row, col)) % p for col in bt] for row in a]


def mul_row_vec_at_left(p: int, m: Matrix, v: Sequence[int]) -> List[int]:
    """v^T @ m mod p (v as a row vector on the left).

    The convention the round-constant compression is written in
    (reference matrix.rs:189-208).
    """
    assert len(m) == len(v)
    return [
        sum(v[i] * m[i][j] for i in range(len(v))) % p for j in range(len(m[0]))
    ]


def vec_add(p: int, a: Sequence[int], b: Sequence[int]) -> List[int]:
    assert len(a) == len(b)
    return [(x + y) % p for x, y in zip(a, b)]


def minor(m: Matrix, i: int, j: int) -> Matrix:
    """Delete row i and column j (reference matrix.rs:393-420)."""
    assert is_square(m) and len(m) > 1
    return [
        [v for cj, v in enumerate(row) if cj != j]
        for ri, row in enumerate(m)
        if ri != i
    ]


def inverse(p: int, m: Matrix) -> Optional[Matrix]:
    """Gauss-Jordan inverse mod p; None if singular (matrix.rs:372-391)."""
    assert is_square(m)
    n = len(m)
    aug = [list(row) + ident_row for row, ident_row in zip(m, identity(n))]
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r][col] % p != 0), None)
        if pivot is None:
            return None
        aug[col], aug[pivot] = aug[pivot], aug[col]
        inv = pow(aug[col][col] % p, -1, p)
        aug[col] = [x * inv % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] % p != 0:
                f = aug[r][col] % p
                aug[r] = [(x - f * y) % p for x, y in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


def upper_triangular(p: int, m: Matrix) -> Optional[Matrix]:
    """Row-echelon form via elimination; None if a pivot vanishes
    (matrix.rs:454-478)."""
    assert is_square(m)
    n = len(m)
    a = [list(row) for row in m]
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r][col] % p != 0), None)
        if pivot is None:
            return None
        a[col], a[pivot] = a[pivot], a[col]
        inv = pow(a[col][col] % p, -1, p)
        for r in range(col + 1, n):
            f = a[r][col] * inv % p
            a[r] = [(x - f * y) % p for x, y in zip(a[r], a[col])]
    return a


class SparseMatrix:
    """Sparse form of the optimized-Poseidon partial-round matrix.

    Shape invariant (reference matrix.rs `SparseMatrix` / neptune): dense
    first row, dense first column, identity elsewhere. Stored as
    ``w_hat`` = full first column (length n, includes [0][0]) and
    ``v_rest`` = first row without its first entry (length n-1).
    """

    __slots__ = ("w_hat", "v_rest")

    def __init__(self, w_hat: Sequence[int], v_rest: Sequence[int]):
        assert len(w_hat) == len(v_rest) + 1
        self.w_hat = list(w_hat)
        self.v_rest = list(v_rest)

    @classmethod
    def from_dense(cls, m: Matrix) -> "SparseMatrix":
        n = len(m)
        assert is_square(m)
        for i in range(1, n):
            for j in range(1, n):
                assert m[i][j] == (1 if i == j else 0), "matrix is not sparse-form"
        return cls([m[i][0] for i in range(n)], m[0][1:])

    def to_dense(self) -> Matrix:
        n = len(self.w_hat)
        m = identity(n)
        for i in range(n):
            m[i][0] = self.w_hat[i]
        m[0][1:] = list(self.v_rest)
        return m

    def mul_row_vec_at_left(self, p: int, v: Sequence[int]) -> List[int]:
        """v^T @ self mod p in 2n-1 multiplications — the partial-round
        product the kernels mirror."""
        n = len(self.w_hat)
        assert len(v) == n
        out0 = sum(v[i] * self.w_hat[i] for i in range(n)) % p
        return [out0] + [
            (v[j] + v[0] * self.v_rest[j - 1]) % p for j in range(1, n)
        ]
