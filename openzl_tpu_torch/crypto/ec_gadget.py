"""In-circuit elliptic-curve gadgets over embedded Edwards curves.

The port's own copy of `openzl_tpu/crypto/ec_gadget.py` (host Python, no JAX).

COM-generic (duck-typed over NativeCompiler / TorchCompiler / R1CSCompiler):
the same functions compute natively and synthesize constraints — the
reference achieves this with `Window::scalar_mul` generic over COM
(openzl-crypto/src/algebra/mod.rs:128-235) plus `ScalarVar`
(plugins/arkworks/src/algebra.rs:28-52); here the group is a complete
twisted Edwards curve (curves/edwards.py), so no incomplete-case handling
is needed in-circuit.

Gadget inventory:
  * PointVar          — affine point as a pair of compiler variables
  * alloc_point       — allocate with an on-curve assertion (witness mode)
  * add_points        — complete addition, 7 constraints under R1CS
  * scalar_bits       — ScalarVar-style embedded scalar: field element
                        decomposed to the curve's scalar bit-length (safe
                        because the embedded order < outer modulus)
  * scalar_mul        — variable-base double-and-add over selection bits
  * FixedBaseTable / fixed_base_scalar_mul — windowed fixed-base multiply
    via the log-depth `select_from_table` mux (eclair/src/bool.rs:150-186)
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..curves import edwards as ed
from ..curves.edwards import EdwardsSpec
from ..eclair.gadgets import select_from_table


@dataclasses.dataclass
class PointVar:
    x: object
    y: object

    def coords(self) -> Tuple[object, object]:
        return (self.x, self.y)


def constant_point(com, P: ed.Point) -> PointVar:
    return PointVar(com.constant(P[0]), com.constant(P[1]))


def identity_point(com) -> PointVar:
    return PointVar(com.constant(0), com.constant(1))


def alloc_point(com, spec: EdwardsSpec, P=None, *, public: bool = False) -> PointVar:
    """Allocate an (x, y) point variable and assert it lies on the curve."""
    alloc = com.public_input if public else com.secret_witness
    x = alloc(None if P is None else P[0])
    y = alloc(None if P is None else P[1])
    pt = PointVar(x, y)
    assert_on_curve(com, spec, pt)
    return pt


def assert_on_curve(com, spec: EdwardsSpec, P: PointVar) -> None:
    """a*x^2 + y^2 == 1 + d*x^2*y^2 (2 squares + 1 product)."""
    xx = com.square(P.x)
    yy = com.square(P.y)
    lhs = com.add(com.mul_const(xx, spec.a), yy)
    rhs = com.add_const(com.mul_const(com.mul(xx, yy), spec.d), 1)
    com.assert_eq(lhs, rhs)


def add_points(com, spec: EdwardsSpec, P: PointVar, Q: PointVar) -> PointVar:
    """Complete twisted Edwards addition.

    x3 = (x1 y2 + y1 x2) / (1 + d x1 x2 y1 y2)
    y3 = (y1 y2 - a x1 x2) / (1 - d x1 x2 y1 y2)

    Karatsuba trick for the cross term: x1 y2 + y1 x2 =
    (x1 + y1)(x2 + y2) - x1 x2 - y1 y2, saving one multiplication.
    """
    A = com.mul(P.x, Q.x)
    B = com.mul(P.y, Q.y)
    C = com.mul_const(com.mul(A, B), spec.d)  # d x1x2y1y2
    T = com.sub(com.mul(com.add(P.x, P.y), com.add(Q.x, Q.y)), com.add(A, B))
    x3 = com.mul(T, com.inv(com.add_const(C, 1)))
    y3 = com.mul(
        com.sub(B, com.mul_const(A, spec.a)),
        com.inv(com.add_const(com.neg(C), 1)),
    )
    return PointVar(x3, y3)


def double_point(com, spec: EdwardsSpec, P: PointVar) -> PointVar:
    return add_points(com, spec, P, P)


def select_point(com, bit, P: PointVar, Q: PointVar) -> PointVar:
    return PointVar(com.select(bit, P.x, Q.x), com.select(bit, P.y, Q.y))


def scalar_bits(com, spec: EdwardsSpec, k=None, *, public: bool = False) -> List:
    """Allocate an embedded-curve scalar and return its little-endian bits.

    The scalar is a single field element of the OUTER field (the curve's
    base field) decomposed into `spec.scalar_bits` bits — sound because
    2^scalar_bits < outer modulus (plugins/arkworks/src/algebra.rs
    `modulus_is_smaller` safety condition, asserted in edwards.validate).
    """
    alloc = com.public_input if public else com.secret_witness
    v = alloc(None if k is None else k % spec.order)
    return com.to_bits_le(v, spec.scalar_bits)


def scalar_mul(com, spec: EdwardsSpec, bits: Sequence, P: PointVar) -> PointVar:
    """Variable-base multiply: for each bit, add select(bit, cur, identity).

    Completeness of the Edwards law makes the identity a valid operand, so
    there is no branch structure to emulate."""
    acc = identity_point(com)
    cur = P
    ident = identity_point(com)
    for i, bit in enumerate(bits):
        acc = add_points(com, spec, acc, select_point(com, bit, cur, ident))
        if i + 1 < len(bits):
            cur = double_point(com, spec, cur)
    return acc


@dataclasses.dataclass(frozen=True)
class FixedBaseTable:
    """[[ (i * 2^(w*j)) * base ] for windows j] as host points.

    Mirrors PrecomputedBaseTable (crypto/algebra.py) / the reference's
    `Window` (algebra/mod.rs:128-235) for the embedded curve."""

    spec: EdwardsSpec
    window_bits: int
    rows: Tuple  # (n_windows, 2^w) host points

    @classmethod
    def build(
        cls, spec: EdwardsSpec, base: ed.Point, window_bits: int = 3
    ) -> "FixedBaseTable":
        n_windows = -(-spec.scalar_bits // window_bits)
        rows = []
        cur = base
        for _ in range(n_windows):
            row = [ed.identity()]
            for _ in range((1 << window_bits) - 1):
                row.append(ed.add(spec, row[-1], cur))
            rows.append(tuple(row))
            for _ in range(window_bits):
                cur = ed.double(spec, cur)
        return cls(spec, window_bits, tuple(rows))


def fixed_base_scalar_mul(
    com, table: FixedBaseTable, bits: Sequence
) -> PointVar:
    """k * base from the precomputed table: one select_from_table mux plus
    one complete addition per window — no in-circuit doublings
    (reference Window::scalar_mul loop, algebra/mod.rs:190-235)."""
    spec = table.spec
    w = table.window_bits
    acc = None
    for j, row in enumerate(table.rows):
        window = list(bits[j * w : (j + 1) * w])
        if not window:
            break
        row_vars = [
            (com.constant(x), com.constant(y))
            for (x, y) in row[: 1 << len(window)]
        ]
        sel = select_from_table(com, window, row_vars)
        pt = PointVar(sel[0], sel[1])
        acc = pt if acc is None else add_points(com, spec, acc, pt)
    return acc
