"""Algebraic abstractions: groups, rings, scalar multiplication, windowed
tables (reference openzl-crypto/src/algebra/mod.rs:18-235).

The port's own copy of `openzl_tpu/crypto/algebra.py` (host Python, no JAX).

`CurveGroup` adapts the curve oracle to the reference's `Group` /
`ScalarMulGroup` traits; `PrecomputedBaseTable` + `Window` mirror the
fixed-base windowed scalar-mul machinery (algebra/mod.rs:79-235) used for
in-circuit scalar multiplication — table entries are selected per window and
accumulated, identical structure to the reference's `Window::scalar_mul`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..curves.spec import CurveSpec
from ..ref import curve as refc


@dataclasses.dataclass(frozen=True)
class CurveGroup:
    """Native `Group`/`ScalarMulGroup` over affine host points."""

    curve: CurveSpec

    def generator(self):
        return refc.generator(self.curve)

    def add(self, a, b):
        return refc.add(self.curve, a, b)

    def double(self, a):
        return refc.add(self.curve, a, a)

    def neg(self, a):
        return refc.neg(self.curve, a)

    def scalar_mul(self, k: int, P):
        return refc.scalar_mul(self.curve, k, P)

    def sample_scalar(self, rng) -> int:
        return rng.randrange(1, self.curve.scalar.modulus)


@dataclasses.dataclass(frozen=True)
class PrecomputedBaseTable:
    """[[2^(w*j) * i * G for i in 0..2^w] for each window j]
    (reference algebra/mod.rs:79-122 FixedBaseScalarMul support)."""

    group: CurveGroup
    window_bits: int
    table: Tuple  # (n_windows, 2^w) affine points

    @classmethod
    def build(cls, group: CurveGroup, base, window_bits: int = 4):
        n_bits = group.curve.scalar.bits
        n_windows = -(-n_bits // window_bits)
        table = []
        cur = base
        for _ in range(n_windows):
            row = [None]
            acc = None
            for _ in range((1 << window_bits) - 1):
                acc = group.add(acc, cur)
                row.append(acc)
            table.append(tuple(row))
            for _ in range(window_bits):
                cur = group.double(cur)
        return cls(group, window_bits, tuple(table))

    def scalar_mul(self, k: int):
        """Fixed-base multiply by table lookups (no doublings at use time)."""
        k %= self.group.curve.scalar.modulus
        acc = None
        mask = (1 << self.window_bits) - 1
        for row in self.table:
            acc = self.group.add(acc, row[k & mask])
            k >>= self.window_bits
        return acc


def window_correctness(group: CurveGroup, rng, window_bits: int = 4) -> bool:
    """Reference test `algebra::test::window_correctness`
    (algebra/mod.rs:304-333)."""
    base = group.scalar_mul(group.sample_scalar(rng), group.generator())
    table = PrecomputedBaseTable.build(group, base, window_bits)
    k = group.sample_scalar(rng)
    return table.scalar_mul(k) == group.scalar_mul(k, base)
