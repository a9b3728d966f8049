"""Ate pairing over BLS12-381 and BN254 (pure-Python, host-side O(1) path).

The port's own copy of `openzl_tpu/ref/pairing.py`, for the two pairings
the port proves over (no BLS12-377, no BW6-761).

Replaces the reference's pairing dependency (ark-ec PairingEngine, used by
Groth16 verify and the ratio proofs; SURVEY.md sections 2.5, 3.3). Verify is
O(1) work per proof, so a host implementation is the right cost tier; the
throughput-critical prove path never pairs.

Construction kept deliberately simple and auditable:
  * Q in E'(Fq2) is untwisted into E(Fp12) via the twist map
    (D-twist: (x w^2, y w^3) for BN254; M-twist: (x / w^2, y / w^3) for
    BLS12-381), then a generic affine Miller loop runs entirely in Fp12.
  * Loop count = t - 1 (the classic ate pairing): x for BLS12-381
    (t = x + 1, x < 0 handled by conjugation), 6x^2 for BN254. No Frobenius
    correction lines needed.
  * Final exponentiation is a direct power to (q^12 - 1) / r.

Any bilinear non-degenerate pairing verifies the same Groth16 equations
(both sides of the product equation transform identically under a fixed
power map), so proofs/keys interoperate with arkworks-generated artifacts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

from ..curves.spec import (
    BLS12_381_G1,
    BLS12_381_G2,
    BN254_G1,
    BN254_G2,
    CurveSpec,
)
from . import fields as tf
from .fields import Fp2, Fp12


@dataclasses.dataclass(frozen=True)
class PairingSpec:
    name: str
    g1: CurveSpec
    g2: CurveSpec
    xi: Fp2  # Fp6 non-residue (cubic, over Fp2)
    twist_type: str  # "D" or "M"
    ate_loop: int  # |t - 1|
    ate_negative: bool
    #: Fp2 non-residue (u^2 = beta): -1 for BN254/BLS12-381, -5 for BLS12-377
    beta: int = -1

    @property
    def p(self) -> int:
        return self.g1.base.modulus

    @property
    def r(self) -> int:
        return self.g1.scalar.modulus

    @functools.cached_property
    def final_exp(self) -> int:
        return (self.p**12 - 1) // self.r


_BLS_X = 0xD201000000010000  # |x|, x is negative for BLS12-381
_BN_X = 4965661367192848881

BLS12_381 = PairingSpec(
    name="bls12_381",
    g1=BLS12_381_G1,
    g2=BLS12_381_G2,
    xi=(1, 1),
    twist_type="M",
    ate_loop=_BLS_X,  # t - 1 = x
    ate_negative=True,
)

BN254 = PairingSpec(
    name="bn254",
    g1=BN254_G1,
    g2=BN254_G2,
    xi=(9, 1),
    twist_type="D",
    ate_loop=6 * _BN_X * _BN_X,  # t - 1 = 6 x^2
    ate_negative=False,
)

#: the pairings the port proves over, by `PairingSpec.name`
PAIRINGS = {spec.name: spec for spec in (BN254, BLS12_381)}


# ---------------------------------------------------------------------------
# Fp12 embedding helpers
# ---------------------------------------------------------------------------


def _f12_from_fp(x: int) -> Fp12:
    return (((x, 0), (0, 0), (0, 0)), tf.f6_zero())


def _f12_from_fp2_at(c: Fp2, six_idx: int, w_idx: int) -> Fp12:
    """c * v^six_idx * w^w_idx as an Fp12 element."""
    f6 = [(0, 0), (0, 0), (0, 0)]
    f6[six_idx] = c
    f6 = tuple(f6)
    if w_idx == 0:
        return (f6, tf.f6_zero())
    return (tf.f6_zero(), f6)


def _untwist(spec: PairingSpec, Q: Tuple[Fp2, Fp2]) -> Tuple[Fp12, Fp12]:
    """E'(Fq2) -> E(Fp12): D: (x w^2, y w^3); M: (x w^-2, y w^-3).

    w^2 = v, w^3 = v w; w^-2 = w^4/xi = v^2 / xi, w^-3 = w^3/xi = v w / xi.
    """
    p, xi, beta = spec.p, spec.xi, spec.beta
    xq, yq = Q
    if spec.twist_type == "D":
        X = _f12_from_fp2_at(xq, 1, 0)  # x * v
        Y = _f12_from_fp2_at(yq, 1, 1)  # y * v * w
    else:
        xi_inv = tf.f2_inv(p, xi, beta)
        X = _f12_from_fp2_at(tf.f2_mul(p, xq, xi_inv, beta), 2, 0)  # x v^2 / xi
        Y = _f12_from_fp2_at(tf.f2_mul(p, yq, xi_inv, beta), 1, 1)  # y v w / xi
    return X, Y


# ---------------------------------------------------------------------------
# generic affine Miller loop in E(Fp12)
# ---------------------------------------------------------------------------


def _line(spec: PairingSpec, A, B, xp: Fp12, yp: Fp12) -> Fp12:
    """Evaluate the line through A, B (affine Fp12 points) at (xp, yp)."""
    p, xi, beta = spec.p, spec.xi, spec.beta
    xa, ya = A
    xb, yb = B
    if xa == xb:
        if ya == yb:
            # tangent: lam = 3 xa^2 / (2 ya)
            num = tf.f12_mul(p, xi, _f12_from_fp(3), tf.f12_sqr(p, xi, xa, beta), beta)
            den = tf.f12_mul(p, xi, _f12_from_fp(2), ya, beta)
        else:
            # vertical: l = xp - xa
            return _f12_sub(p, xp, xa)
    else:
        num = _f12_sub(p, yb, ya)
        den = _f12_sub(p, xb, xa)
    lam = tf.f12_mul(p, xi, num, tf.f12_inv(p, xi, den, beta), beta)
    # l = yp - ya - lam (xp - xa)
    return _f12_sub(
        p, _f12_sub(p, yp, ya), tf.f12_mul(p, xi, lam, _f12_sub(p, xp, xa), beta)
    )


def _f12_sub(p: int, a: Fp12, b: Fp12) -> Fp12:
    return (tf.f6_sub(p, a[0], b[0]), tf.f6_sub(p, a[1], b[1]))


def _ec_add_f12(spec: PairingSpec, A, B):
    """Affine addition on E(Fp12) (a = 0); None = identity."""
    p, xi, beta = spec.p, spec.xi, spec.beta
    if A is None:
        return B
    if B is None:
        return A
    xa, ya = A
    xb, yb = B
    if xa == xb:
        if ya != yb:
            return None
        num = tf.f12_mul(p, xi, _f12_from_fp(3), tf.f12_sqr(p, xi, xa, beta), beta)
        den = tf.f12_mul(p, xi, _f12_from_fp(2), ya, beta)
    else:
        num = _f12_sub(p, yb, ya)
        den = _f12_sub(p, xb, xa)
    lam = tf.f12_mul(p, xi, num, tf.f12_inv(p, xi, den, beta), beta)
    x3 = _f12_sub(p, _f12_sub(p, tf.f12_sqr(p, xi, lam, beta), xa), xb)
    y3 = _f12_sub(p, tf.f12_mul(p, xi, lam, _f12_sub(p, xa, x3), beta), ya)
    return (x3, y3)


def miller_loop(spec: PairingSpec, P: Tuple[int, int], Q: Tuple[Fp2, Fp2]) -> Fp12:
    """f_{T,Q}(P) with T = ate_loop, computed in E(Fp12)."""
    p, xi, beta = spec.p, spec.xi, spec.beta
    xp = _f12_from_fp(P[0])
    yp = _f12_from_fp(P[1])
    Qt = _untwist(spec, Q)
    R = Qt
    f = tf.f12_one()
    bits = bin(spec.ate_loop)[3:]  # skip MSB
    for bit in bits:
        f = tf.f12_mul(
            p, xi, tf.f12_sqr(p, xi, f, beta), _line(spec, R, R, xp, yp), beta
        )
        R = _ec_add_f12(spec, R, R)
        if bit == "1":
            f = tf.f12_mul(p, xi, f, _line(spec, R, Qt, xp, yp), beta)
            R = _ec_add_f12(spec, R, Qt)
    if spec.ate_negative:
        f = tf.f12_conj(p, f)  # unitary inverse (final exp removes the rest)
    return f


def pairing(spec: PairingSpec, P, Q) -> Fp12:
    """e(P, Q): P affine G1 (int pair) | None; Q affine G2 (Fp2 pair) | None."""
    if P is None or Q is None:
        return tf.f12_one()
    f = miller_loop(spec, P, Q)
    return tf.f12_pow(spec.p, spec.xi, f, spec.final_exp, spec.beta)


def pairing_product_is_one(spec: PairingSpec, pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — the Groth16 verification shape.

    Routes through the native C++ engine (native/pairing.cpp: shared-lambda
    affine Miller steps + staged final exponentiation, ~10x this module)
    when the library is built; this pure-Python path is the oracle and
    fallback."""
    live = [(P, Q) for P, Q in pairs if P is not None and Q is not None]
    try:
        from .. import native

        got = native.pairing_product_is_one(spec, live)
        if got is not None:
            return got
    except Exception:
        pass
    p, xi, beta = spec.p, spec.xi, spec.beta
    acc = tf.f12_one()
    for P, Q in live:
        acc = tf.f12_mul(p, xi, acc, miller_loop(spec, P, Q), beta)
    return tf.f12_pow(p, xi, acc, spec.final_exp, beta) == tf.f12_one()
