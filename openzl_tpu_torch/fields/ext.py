"""Field-ops objects: base field Fq and quadratic extension Fq2.

Port of `openzl_tpu/fields/ext.py`. Values are int32 limb tensors, limb axis
first and batch last:

  * Fq:  (n_limbs, *batch)
  * Fq2: (n_limbs, 2, *batch), component axis 1 holding (c0, c1) of
    c0 + c1 u with u^2 = beta (-1 for BN254 / BLS12-381, -5 for BLS12-377).

Curve and MSM code runs over either field through the ops object; the
batch is always the trailing axes. Host conversions take an explicit
`device`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Union

import numpy as np
import torch

from .spec import FieldSpec
from . import limb


def _mont_mul(ops, a, b):
    """Montgomery product through K1 (limb.mont_mul), or through K1's plain
    torch version on any device when the ops object is `plain`."""
    if ops.plain:
        from ..ops.ntt_kernel import mont_mul_plain

        return mont_mul_plain(ops.spec, a, b)
    return limb.mont_mul(ops.spec, a, b)


@dataclasses.dataclass(frozen=True)
class FqOps:
    """Base-field ops over Montgomery limb tensors (n_limbs, *batch).
    `plain` keeps every product in plain torch (the kernels' plain
    versions use it)."""

    spec: FieldSpec
    plain: bool = False

    value_ndim = 1

    def from_ints(self, values, device=None) -> torch.Tensor:
        return limb.tensor(limb.pack_mont(self.spec, values), device)

    def to_ints(self, arr) -> np.ndarray:
        return limb.unpack_mont(self.spec, arr)

    def const(self, x: int, batch_ndim: int, device=None) -> torch.Tensor:
        v = self.from_ints(np.array(x % self.spec.modulus, dtype=object), device)
        return v.reshape(tuple(v.shape) + (1,) * batch_ndim)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return limb.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None) -> torch.Tensor:
        c = self.const(1, len(batch_shape), device)
        return c.expand((self.spec.n_limbs,) + tuple(batch_shape))

    def add(self, a, b):
        return limb.add(self.spec, a, b)

    def sub(self, a, b):
        return limb.sub(self.spec, a, b)

    def neg(self, a):
        return limb.neg(self.spec, a)

    def double(self, a):
        return limb.add(self.spec, a, a)

    def mul(self, a, b):
        return _mont_mul(self, a, b)

    def sqr(self, a):
        return _mont_mul(self, a, a)

    def inv(self, a):
        return limb.mont_inv(self.spec, a)

    def is_zero(self, a) -> torch.Tensor:
        return (a == 0).all(0)

    def eq(self, a, b) -> torch.Tensor:
        return (a == b).all(0)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)


@dataclasses.dataclass(frozen=True)
class Fq2Ops:
    """Quadratic extension c0 + c1 u, u^2 = beta; values (n_limbs, 2, *b)."""

    spec: FieldSpec
    beta: int = -1
    plain: bool = False

    value_ndim = 2

    def _nr(self, x):
        """|beta| x (beta is a small negative integer)."""
        acc = x
        for _ in range(-self.beta - 1):
            acc = limb.add(self.spec, acc, x)
        return acc

    @staticmethod
    def _c(v, i):
        return v[:, i]

    @staticmethod
    def _stack(c0, c1):
        return torch.stack([c0, c1], dim=1)

    def from_ints(self, pairs, device=None) -> torch.Tensor:
        """pairs: nested [..., (c0, c1)] ints, pair axis last ->
        (n_limbs, 2, *batch)."""
        arr = np.asarray(pairs, dtype=object)
        return limb.tensor(limb.pack_mont(self.spec, np.moveaxis(arr, -1, 0)), device)

    def to_ints(self, v) -> np.ndarray:
        """-> object array (*batch, 2) of canonical ints."""
        return np.moveaxis(limb.unpack_mont(self.spec, v), 0, -1)

    def const(self, x, batch_ndim: int, device=None) -> torch.Tensor:
        """x: an int or a (c0, c1) pair."""
        if isinstance(x, int):
            x = (x, 0)
        m = self.spec.modulus
        v = self.from_ints(np.array([x[0] % m, x[1] % m], dtype=object), device)
        return v.reshape(tuple(v.shape) + (1,) * batch_ndim)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(
            (self.spec.n_limbs, 2) + tuple(batch_shape), dtype=limb.DTYPE, device=device
        )

    def one(self, batch_shape=(), device=None) -> torch.Tensor:
        c = self.const(1, len(batch_shape), device)
        return c.expand((self.spec.n_limbs, 2) + tuple(batch_shape))

    # componentwise ring ops: the pair axis is a batch axis for limb ops
    def add(self, a, b):
        return limb.add(self.spec, a, b)

    def sub(self, a, b):
        return limb.sub(self.spec, a, b)

    def neg(self, a):
        return limb.neg(self.spec, a)

    def double(self, a):
        return limb.add(self.spec, a, a)

    def mul(self, a, b):
        """Karatsuba: (a0 + a1 u)(b0 + b1 u) = (a0 b0 + beta a1 b1) +
        ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u; the three products run as
        one batched Montgomery product."""
        s = self.spec
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = self._c(a, 0), self._c(a, 1)
        b0, b1 = self._c(b, 0), self._c(b, 1)
        lhs = torch.stack([a0, a1, limb.add(s, a0, a1)], dim=1)
        rhs = torch.stack([b0, b1, limb.add(s, b0, b1)], dim=1)
        m = _mont_mul(self, lhs, rhs)
        m0, m1, m2 = m[:, 0], m[:, 1], m[:, 2]
        return self._stack(limb.sub(s, m0, self._nr(m1)), limb.sub(s, m2, limb.add(s, m0, m1)))

    def sqr(self, a):
        """(a0 + a1 u)^2 = ((a0 + a1)(a0 + beta a1) - (beta + 1) a0 a1)
        + 2 a0 a1 u."""
        s = self.spec
        a0, a1 = self._c(a, 0), self._c(a, 1)
        lhs = torch.stack([limb.add(s, a0, a1), a0], dim=1)
        rhs = torch.stack([limb.sub(s, a0, self._nr(a1)), a1], dim=1)
        tm = _mont_mul(self, lhs, rhs)
        t, m = tm[:, 0], tm[:, 1]
        c0 = t
        for _ in range(-self.beta - 1):  # t + (|beta| - 1) m
            c0 = limb.add(s, c0, m)
        return self._stack(c0, limb.add(s, m, m))

    def inv(self, a):
        """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 - beta a1^2)."""
        s = self.spec
        a0, a1 = self._c(a, 0), self._c(a, 1)
        norm = limb.add(s, limb.mont_mul(s, a0, a0), self._nr(limb.mont_mul(s, a1, a1)))
        ninv = limb.mont_inv(s, norm)
        return self._stack(limb.mont_mul(s, a0, ninv), limb.neg(s, limb.mont_mul(s, a1, ninv)))

    def is_zero(self, a):
        return (a == 0).all(0).all(0)

    def eq(self, a, b):
        return (a == b).all(0).all(0)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0).unsqueeze(0), a, b)


FieldOps = Union[FqOps, Fq2Ops]


@functools.lru_cache(maxsize=None)
def fq_ops(spec: FieldSpec, plain: bool = False) -> FqOps:
    return FqOps(spec, plain)


@functools.lru_cache(maxsize=None)
def fq2_ops(spec: FieldSpec, beta: int = -1, plain: bool = False) -> Fq2Ops:
    return Fq2Ops(spec, beta, plain)
