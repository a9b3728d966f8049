"""Kernels K3 (Jacobian add / mixed add) and K4 (Jacobian double).

Port of `openzl_tpu/ops/ec_kernel.py` `ec_op`. CUDA sources:
`openzl_tpu_torch/csrc/ec_kernel.cu` and `ec.cuh` (design notes there);
this module holds the wrappers, launch counters and plain torch versions.

Coordinates are Montgomery limb tensors (n_limbs, *batch) over Fq (G1) or
(n_limbs, 2, *batch) over Fq2 (G2). Formulas and special-case masks follow
the reference kernels exactly (add-2007-bl, madd-2007-bl, dbl-2009-l or
the generic-a double; P = -Q gives X = Y = 1, Z = 0), so Jacobian limbs are
bit-equal to `ec_kernel.ec_op`. A CUDA tensor launches the kernel, a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.spec import CurveSpec
from ..fields.ext import fq2_ops, fq_ops
from ..utils import build
from .ntt_kernel import device_kind, word_consts

K3 = build.KernelInfo(
    name="ec_add",
    source="openzl_tpu_torch/csrc/ec_kernel.cu",
    replaces="openzl_tpu/ops/ec_kernel.py:288",
)
K4 = build.KernelInfo(
    name="ec_dbl",
    source="openzl_tpu_torch/csrc/ec_kernel.cu",
    replaces="openzl_tpu/ops/ec_kernel.py:314",
)


def field_ops(curve: CurveSpec, plain: bool = False):
    """Coordinate-field ops; `plain` keeps products in plain torch."""
    if curve.ext == 2:
        return fq2_ops(curve.base, curve.nr2, plain)
    return fq_ops(curve.base, plain)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def _raw_one_like(F, v):
    o = torch.zeros_like(v)
    if F.value_ndim == 1:
        o[0] = 1
    else:
        o[0, 0] = 1
    return o


def _a_const(curve: CurveSpec, F, like):
    return F.const(curve.a, like.ndim - F.value_ndim, like.device)


def ec_dbl_plain(curve: CurveSpec, X, Y, Z):
    """dbl-2009-l (a = 0) or M = 3X^2 + a Z^4 (generic a); Z3 = 2YZ keeps
    the identity. Plain torch on any device."""
    F = field_ops(curve, plain=True)
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.double(F.sub(F.sqr(F.add(X, B)), F.add(A, C)))
    E = F.add(F.double(A), A)
    if curve.a != 0:
        E = F.add(E, F.mul(_a_const(curve, F, Z), F.sqr(F.sqr(Z))))
    X3 = F.sub(F.sqr(E), F.double(D))
    C8 = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.double(F.mul(Y, Z))
    return X3, Y3, Z3


def ec_add_plain(curve: CurveSpec, P, Q, mixed: bool):
    """add-2007-bl, or madd-2007-bl when `mixed` (Q normalized, Z in {0,1}),
    with the reference kernels' masks. Plain torch on any device."""
    F = field_ops(curve, plain=True)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    if mixed:
        U1, S1 = X1, Y1
        U2 = F.mul(X2, Z1Z1)
        S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    else:
        Z2Z2 = F.sqr(Z2)
        U1 = F.mul(X1, Z2Z2)
        U2 = F.mul(X2, Z1Z1)
        S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
        S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    if mixed:
        HH = F.sqr(H)
        I = F.double(F.double(HH))
    else:
        I = F.sqr(F.double(H))
    J = F.mul(H, I)
    r = F.double(F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sqr(r), F.add(J, F.double(V)))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(S1, J)))
    if mixed:
        Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    else:
        Z3 = F.mul(F.sub(F.sqr(F.add(Z1, Z2)), F.add(Z1Z1, Z2Z2)), H)

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(r)
    both = ~p_inf & ~q_inf
    same = both & h_zero & r_zero
    opposite = both & h_zero & ~r_zero

    # the doubling is selected only where P = Q: skip computing it when no
    # element needs it (the selected values are the same either way)
    dbl = ec_dbl_plain(curve, X1, Y1, Z1) if bool(same.any()) else (None,) * 3
    one = _raw_one_like(F, X1)
    zero = torch.zeros_like(X1)
    out = []
    for v3, d, o, c1, c2 in ((X3, dbl[0], one, X1, X2), (Y3, dbl[1], one, Y1, Y2), (Z3, dbl[2], zero, Z1, Z2)):
        if d is not None:
            v3 = F.select(same, d, v3)
        v3 = F.select(opposite, o, v3)
        v3 = F.select(p_inf, c2, v3)
        v3 = F.select(q_inf, c1, v3)
        out.append(v3)
    return tuple(out)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _a_words(curve: CurveSpec) -> np.ndarray:
    """Montgomery form of the curve coefficient a as uint32 words
    (c0 words then c1 words over Fq2)."""
    spec = curve.base
    pair = (curve.a, 0) if curve.ext == 2 else (curve.a,)
    words = []
    for c in pair:
        m = spec.to_mont(c % spec.modulus)
        words += [(m >> (32 * i)) & 0xFFFFFFFF for i in range(spec.n_limbs // 2)]
    return np.array(words, dtype=np.uint32)


def _flat(curve: CurveSpec, coords):
    """Check and flatten coordinates to (n_limbs[, 2], N) contiguous int32."""
    lead = 1 + (curve.ext == 2)
    shape = coords[0].shape
    head = shape[:lead]
    if head != (curve.base.n_limbs,) + ((2,) if curve.ext == 2 else ()):
        raise ValueError(f"{curve.name}: coordinate shape {tuple(shape)}")
    flat = []
    for c in coords:
        if c.shape != shape or c.dtype != torch.int32:
            raise ValueError("EC kernel coordinates must share one int32 shape")
        flat.append(c.contiguous().reshape(head + (-1,)))
    return flat, shape


def _launch_args(curve: CurveSpec):
    words, n0 = word_consts(curve.base)
    has_a = int(curve.a != 0)
    return words, n0, curve.nr2, has_a, _a_words(curve)


def ec_add(curve: CurveSpec, P, Q, mixed: bool = False):
    """Batched P + Q (K3). P, Q: (X, Y, Z) tuples of one shape; with
    `mixed`, Q must be normalized (Z in {0, 1})."""
    coords = tuple(P) + tuple(Q)
    if device_kind(*coords) == "cpu":
        return ec_add_plain(curve, P, Q, mixed)
    flat, shape = _flat(curve, coords)
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    N = flat[0].shape[-1]
    words, n0, beta, has_a, a_words = _launch_args(curve)
    code = build.lib().ozl_ec_add(
        int(mixed), curve.ext, *(t.data_ptr() for t in flat + outs), N,
        curve.base.n_limbs, words.ctypes.data, n0, beta, has_a, a_words.ctypes.data,
        build.stream_ptr(flat[0]),
    )
    build.check(code, "K3 ec_add")
    K3.launches += 1
    return tuple(o.reshape(shape) for o in outs)


def ec_dbl(curve: CurveSpec, P):
    """Batched 2P (K4)."""
    if device_kind(*P) == "cpu":
        return ec_dbl_plain(curve, *P)
    flat, shape = _flat(curve, tuple(P))
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    N = flat[0].shape[-1]
    words, n0, beta, has_a, a_words = _launch_args(curve)
    code = build.lib().ozl_ec_dbl(
        curve.ext, *(t.data_ptr() for t in flat + outs), N, curve.base.n_limbs,
        words.ctypes.data, n0, beta, has_a, a_words.ctypes.data, build.stream_ptr(flat[0]),
    )
    build.check(code, "K4 ec_dbl")
    K4.launches += 1
    return tuple(o.reshape(shape) for o in outs)
