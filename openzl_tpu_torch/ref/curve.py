"""Pure-Python elliptic-curve oracle (test reference, not a compute path).

The port's own copy of `openzl_tpu/ref/curve.py` (host Python, no JAX).

Affine arithmetic over Python ints (G1) or Fp2 tuples (G2), mirroring
arkworks' group law (SURVEY.md section 2.8 ark-ec row). Used to validate the
batched TPU path. Identity is represented as None (affine).
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..curves.spec import CurveSpec
from . import fields as tf

Affine = Optional[Tuple]


class _F:
    """Field-op dispatch for a curve's coordinate field (ext 1 or 2)."""

    def __init__(self, curve: CurveSpec):
        self.p = curve.base.modulus
        self.ext = curve.ext
        self.beta = curve.nr2

    def add(self, a, b):
        return (a + b) % self.p if self.ext == 1 else tf.f2_add(self.p, a, b)

    def sub(self, a, b):
        return (a - b) % self.p if self.ext == 1 else tf.f2_sub(self.p, a, b)

    def neg(self, a):
        return (-a) % self.p if self.ext == 1 else tf.f2_neg(self.p, a)

    def mul(self, a, b):
        return (
            a * b % self.p
            if self.ext == 1
            else tf.f2_mul(self.p, a, b, self.beta)
        )

    def inv(self, a):
        return (
            pow(a, -1, self.p)
            if self.ext == 1
            else tf.f2_inv(self.p, a, self.beta)
        )

    def scalar(self, a, k: int):
        return a * k % self.p if self.ext == 1 else tf.f2_scalar(self.p, a, k)

    def is_zero(self, a):
        return a % self.p == 0 if self.ext == 1 else tf.f2_is_zero(a)


def add(curve: CurveSpec, P: Affine, Q: Affine) -> Affine:
    F = _F(curve)
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if F.is_zero(F.add(y1, y2)):
            return None
        # double: lambda = (3 x^2 + a) / 2 y  (a = 0 for the pairing
        # curves; generic-a covers the MNT-family curve shapes)
        num = F.scalar(F.mul(x1, x1), 3)
        if curve.a != 0:
            a = (
                curve.a
                if curve.ext == 1
                else (curve.a if isinstance(curve.a, tuple) else (curve.a, 0))
            )
            num = F.add(num, a)
        lam = F.mul(num, F.inv(F.scalar(y1, 2)))
    else:
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def neg(curve: CurveSpec, P: Affine) -> Affine:
    if P is None:
        return None
    return (P[0], _F(curve).neg(P[1]))


def scalar_mul(curve: CurveSpec, k: int, P: Affine) -> Affine:
    k %= curve.scalar.modulus
    acc: Affine = None
    add_ = P
    while k:
        if k & 1:
            acc = add(curve, acc, add_)
        add_ = add(curve, add_, add_)
        k >>= 1
    return acc


def generator(curve: CurveSpec) -> Affine:
    return (curve.gen_x, curve.gen_y)


def is_on_curve(curve: CurveSpec, P: Affine) -> bool:
    if P is None:
        return True
    F = _F(curve)
    x, y = P
    lhs = F.mul(y, y)
    rhs = F.add(F.mul(F.mul(x, x), x), curve.b if curve.ext == 2 else curve.b % curve.base.modulus)
    if curve.a != 0:
        a = (
            curve.a % curve.base.modulus
            if curve.ext == 1
            else (curve.a if isinstance(curve.a, tuple) else (curve.a, 0))
        )
        rhs = F.add(rhs, F.mul(a, x))
    return lhs == rhs


def msm(curve: CurveSpec, scalars, points) -> Affine:
    acc: Affine = None
    for k, P in zip(scalars, points):
        acc = add(curve, acc, scalar_mul(curve, k, P))
    return acc
