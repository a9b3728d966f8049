"""Batched Jacobian point arithmetic over Fq (G1) or Fq2 (G2).

Port of `openzl_tpu/curves/jacobian.py`. A point batch is (X, Y, Z) of
Montgomery limb tensors shaped (n_limbs[, 2], *batch); identity is Z = 0.
`add`, `madd` and `double` go through kernels K3 and K4
(`openzl_tpu_torch.ops.ec_kernel`): CUDA tensors launch the CUDA kernels,
CPU tensors run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .spec import CurveSpec
from ..ops import ec_kernel
from ..ops.ec_kernel import field_ops

__all__ = [
    "JPoint", "field_ops", "identity", "from_affine_ints", "to_affine_ints",
    "select", "negate", "is_on_curve", "add", "madd", "double",
    "batch_inv", "normalize", "concat", "take",
]


class JPoint(NamedTuple):
    """Jacobian point batch; affine = (X / Z^2, Y / Z^3), identity Z = 0."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _batch_shape(curve: CurveSpec, P: JPoint):
    return tuple(P.z.shape[field_ops(curve).value_ndim :])


def identity(curve: CurveSpec, batch_shape=(), device=None) -> JPoint:
    F = field_ops(curve)
    one = F.one(batch_shape, device).contiguous()
    return JPoint(one, one.clone(), F.zeros(batch_shape, device))


def from_affine_ints(curve: CurveSpec, points, device=None) -> JPoint:
    """Host list of affine (x, y) | None -> batched Jacobian point with
    Z in {0, 1}. Coordinates are ints for G1 and (c0, c1) pairs for G2."""
    F = field_ops(curve)
    zero = 0 if curve.ext == 1 else (0, 0)
    one = 1 if curve.ext == 1 else (1, 0)
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(one)
            ys.append(one)
            zs.append(zero)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(one)
    if not xs:
        return identity(curve, (0,), device)

    def conv(vals):
        return F.from_ints(np.array(vals, dtype=object), device)

    return JPoint(conv(xs), conv(ys), conv(zs))


def _fmt(curve, c):
    return int(c) if curve.ext == 1 else (int(c[0]), int(c[1]))


def to_affine_ints(curve: CurveSpec, P: JPoint):
    """Device -> host: affine (x, y) | None for a single point, or a list of
    them for a 1-D batch. One batched inversion for the whole batch."""
    F = field_ops(curve)
    single = P.z.ndim == F.value_ndim
    if single:
        P = JPoint(*(v.unsqueeze(-1) for v in P))
    inf = F.is_zero(P.z)
    one = F.one(tuple(P.z.shape[F.value_ndim :]), P.z.device)
    zinv = batch_inv(F, F.select(inf, one, P.z))
    zinv2 = F.sqr(zinv)
    xs = F.to_ints(F.mul(P.x, zinv2))
    ys = F.to_ints(F.mul(P.y, F.mul(zinv2, zinv)))
    inf = inf.cpu().numpy()
    out = [None if inf[i] else (_fmt(curve, xs[i]), _fmt(curve, ys[i])) for i in range(len(inf))]
    return out[0] if single else out


def select(mask: torch.Tensor, a: JPoint, b: JPoint) -> JPoint:
    def sel(u, v):
        m = mask.reshape((1,) * (u.ndim - mask.ndim) + tuple(mask.shape))
        return torch.where(m, u, v)

    return JPoint(sel(a.x, b.x), sel(a.y, b.y), sel(a.z, b.z))


def negate(curve: CurveSpec, P: JPoint) -> JPoint:
    return JPoint(P.x, field_ops(curve).neg(P.y), P.z)


def double(curve: CurveSpec, P: JPoint) -> JPoint:
    """2P (K4): dbl-2009-l for a = 0, M = 3X^2 + a Z^4 otherwise."""
    return JPoint(*ec_kernel.ec_dbl(curve, tuple(P)))


def _same_shape(P: JPoint, Q: JPoint):
    xs = torch.broadcast_tensors(P.x, Q.x)
    ys = torch.broadcast_tensors(P.y, Q.y)
    zs = torch.broadcast_tensors(P.z, Q.z)
    return (xs[0], ys[0], zs[0]), (xs[1], ys[1], zs[1])


def add(curve: CurveSpec, P: JPoint, Q: JPoint) -> JPoint:
    """Complete batched addition (K3, add-2007-bl with masked special
    cases)."""
    p, q = _same_shape(P, Q)
    return JPoint(*ec_kernel.ec_add(curve, p, q, mixed=False))


def madd(curve: CurveSpec, P: JPoint, Q: JPoint) -> JPoint:
    """Mixed addition (K3, madd-2007-bl); Q normalized (Z in {0, 1})."""
    p, q = _same_shape(P, Q)
    return JPoint(*ec_kernel.ec_add(curve, p, q, mixed=True))


def batch_inv(F, x: torch.Tensor) -> torch.Tensor:
    """Inverses over the last axis by Montgomery's trick: prefix and suffix
    products (log-step scans) and one Fermat inversion of the total. All
    inputs must be non-zero."""
    from ..ops.scan_utils import inclusive_scan

    n = x.shape[-1]
    if n == 1:
        return F.inv(x)

    def combine(a, b):
        return (F.mul(a[0], b[0]),)

    def pad(k):
        return (F.one(tuple(x.shape[F.value_ndim : -1]) + (k,), x.device),)

    (ps,) = inclusive_scan(combine, (x,), pad)
    (ssr,) = inclusive_scan(combine, (torch.flip(x, (-1,)),), pad)
    ss = torch.flip(ssr, (-1,))
    tinv = F.inv(ps[..., n - 1 :])
    left = torch.cat([pad(1)[0], ps[..., : n - 1]], dim=-1)
    right = torch.cat([ss[..., 1:], pad(1)[0]], dim=-1)
    return F.mul(F.mul(left, right), tinv.expand(x.shape))


def normalize(curve: CurveSpec, P: JPoint) -> JPoint:
    """Scale every live point to Z = 1 (the identity keeps Z = 0 with
    X = Y = Montgomery one); one batched inversion."""
    F = field_ops(curve)
    batch = _batch_shape(curve, P)
    if not batch:
        raise ValueError("normalize expects a batched point")
    inf = F.is_zero(P.z)
    one = F.one(batch, P.z.device)
    zinv = batch_inv(F, F.select(inf, one, P.z))
    zi2 = F.sqr(zinv)
    x = F.mul(P.x, zi2)
    y = F.mul(P.y, F.mul(zi2, zinv))
    return JPoint(
        F.select(inf, one, x).contiguous(),
        F.select(inf, one, y).contiguous(),
        F.select(inf, F.zeros(batch, P.z.device), one).contiguous(),
    )


def is_on_curve(curve: CurveSpec, P: JPoint) -> torch.Tensor:
    """Y^2 = X^3 + a X Z^4 + b Z^6; the identity passes."""
    F = field_ops(curve)
    nb = len(_batch_shape(curve, P))
    dev = P.z.device
    y2 = F.sqr(P.y)
    x3 = F.mul(F.sqr(P.x), P.x)
    z2 = F.sqr(P.z)
    z6 = F.mul(F.sqr(z2), z2)
    rhs = F.add(x3, F.mul(F.const(curve.b, nb, dev), z6))
    if curve.a != 0:
        rhs = F.add(rhs, F.mul(F.const(curve.a, nb, dev), F.mul(P.x, F.sqr(z2))))
    return F.eq(y2, rhs) | F.is_zero(P.z)


def concat(points) -> JPoint:
    return JPoint(*(torch.cat([getattr(p, f) for p in points], dim=-1) for f in "xyz"))


def take(P: JPoint, idx) -> JPoint:
    """Gather along the (last) batch axis."""
    return JPoint(P.x[..., idx], P.y[..., idx], P.z[..., idx])
