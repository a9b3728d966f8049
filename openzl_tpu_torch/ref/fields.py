"""Pure-Python tower-field oracle: Fp, Fp2, Fp6, Fp12 (test/verify path).

The port's own copy of `openzl_tpu/ref/fields.py` (host Python, no JAX).

Mirrors the arkworks tower construction for BN254 / BLS12-381 / BLS12-377
(SURVEY.md section 2.8 ark-ff row):
  Fp2  = Fp[u]  / (u^2 - beta)      beta = -1 (default) or -5 (BLS12-377)
  Fp6  = Fp2[v] / (v^3 - xi)        xi = 1+u (BLS12-381), 9+u (BN254)
  Fp12 = Fp6[w] / (w^2 - v)

Elements are plain tuples of ints (Fp2: (c0, c1); Fp6: 3 Fp2; Fp12: 2 Fp6),
making this module dependency-free and obviously correct — it is the oracle
the TPU kernels and the pairing engine are checked against, and the
verification fallback for O(1) work (Groth16 verify pairings).
"""

from __future__ import annotations

from typing import Tuple

Fp2 = Tuple[int, int]
Fp6 = Tuple[Fp2, Fp2, Fp2]
Fp12 = Tuple[Fp6, Fp6]


# ---------------------------------------------------------------------------
# Fp2 (u^2 = beta, beta a small non-residue; -1 for BN254/BLS12-381)
# ---------------------------------------------------------------------------


def f2_add(p: int, a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)


def f2_sub(p: int, a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)


def f2_neg(p: int, a: Fp2) -> Fp2:
    return ((-a[0]) % p, (-a[1]) % p)


def f2_mul(p: int, a: Fp2, b: Fp2, beta: int = -1) -> Fp2:
    return (
        (a[0] * b[0] + beta * a[1] * b[1]) % p,
        (a[0] * b[1] + a[1] * b[0]) % p,
    )


def f2_sqr(p: int, a: Fp2, beta: int = -1) -> Fp2:
    return f2_mul(p, a, a, beta)


def f2_scalar(p: int, a: Fp2, k: int) -> Fp2:
    return (a[0] * k % p, a[1] * k % p)


def f2_conj(p: int, a: Fp2) -> Fp2:
    return (a[0], (-a[1]) % p)


def f2_inv(p: int, a: Fp2, beta: int = -1) -> Fp2:
    norm = (a[0] * a[0] - beta * a[1] * a[1]) % p
    ninv = pow(norm, -1, p)
    return (a[0] * ninv % p, (-a[1]) * ninv % p)


def f2_is_zero(a: Fp2) -> bool:
    return a[0] == 0 and a[1] == 0


# ---------------------------------------------------------------------------
# Fp6 over Fp2 (v^3 = xi)
# ---------------------------------------------------------------------------


def f6_zero() -> Fp6:
    return ((0, 0), (0, 0), (0, 0))


def f6_one() -> Fp6:
    return ((1, 0), (0, 0), (0, 0))


def f6_add(p: int, a: Fp6, b: Fp6) -> Fp6:
    return tuple(f2_add(p, x, y) for x, y in zip(a, b))  # type: ignore


def f6_sub(p: int, a: Fp6, b: Fp6) -> Fp6:
    return tuple(f2_sub(p, x, y) for x, y in zip(a, b))  # type: ignore


def f6_neg(p: int, a: Fp6) -> Fp6:
    return tuple(f2_neg(p, x) for x in a)  # type: ignore


def f6_mul(p: int, xi: Fp2, a: Fp6, b: Fp6, beta: int = -1) -> Fp6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(p, a0, b0, beta)
    t1 = f2_mul(p, a1, b1, beta)
    t2 = f2_mul(p, a2, b2, beta)
    # Karatsuba-like (Toom) combination
    c0 = f2_add(
        p,
        t0,
        f2_mul(
            p,
            xi,
            f2_sub(
                p,
                f2_mul(p, f2_add(p, a1, a2), f2_add(p, b1, b2), beta),
                f2_add(p, t1, t2),
            ),
            beta,
        ),
    )
    c1 = f2_add(
        p,
        f2_sub(
            p,
            f2_mul(p, f2_add(p, a0, a1), f2_add(p, b0, b1), beta),
            f2_add(p, t0, t1),
        ),
        f2_mul(p, xi, t2, beta),
    )
    c2 = f2_add(
        p,
        f2_sub(
            p,
            f2_mul(p, f2_add(p, a0, a2), f2_add(p, b0, b2), beta),
            f2_add(p, t0, t2),
        ),
        t1,
    )
    return (c0, c1, c2)


def f6_mul_by_v(p: int, xi: Fp2, a: Fp6, beta: int = -1) -> Fp6:
    """v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2."""
    return (f2_mul(p, xi, a[2], beta), a[0], a[1])


def f6_inv(p: int, xi: Fp2, a: Fp6, beta: int = -1) -> Fp6:
    a0, a1, a2 = a
    c0 = f2_sub(p, f2_sqr(p, a0, beta), f2_mul(p, xi, f2_mul(p, a1, a2, beta), beta))
    c1 = f2_sub(p, f2_mul(p, xi, f2_sqr(p, a2, beta), beta), f2_mul(p, a0, a1, beta))
    c2 = f2_sub(p, f2_sqr(p, a1, beta), f2_mul(p, a0, a2, beta))
    t = f2_add(
        p,
        f2_mul(p, xi, f2_add(p, f2_mul(p, a2, c1, beta), f2_mul(p, a1, c2, beta)), beta),
        f2_mul(p, a0, c0, beta),
    )
    tinv = f2_inv(p, t, beta)
    return (
        f2_mul(p, c0, tinv, beta),
        f2_mul(p, c1, tinv, beta),
        f2_mul(p, c2, tinv, beta),
    )


# ---------------------------------------------------------------------------
# Fp12 over Fp6 (w^2 = v)
# ---------------------------------------------------------------------------


def f12_one() -> Fp12:
    return (f6_one(), f6_zero())


def f12_mul(p: int, xi: Fp2, a: Fp12, b: Fp12, beta: int = -1) -> Fp12:
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(p, xi, a0, b0, beta)
    t1 = f6_mul(p, xi, a1, b1, beta)
    c0 = f6_add(p, t0, f6_mul_by_v(p, xi, t1, beta))
    c1 = f6_sub(
        p,
        f6_mul(p, xi, f6_add(p, a0, a1), f6_add(p, b0, b1), beta),
        f6_add(p, t0, t1),
    )
    return (c0, c1)


def f12_sqr(p: int, xi: Fp2, a: Fp12, beta: int = -1) -> Fp12:
    return f12_mul(p, xi, a, a, beta)


def f12_conj(p: int, a: Fp12) -> Fp12:
    """Conjugation = f^(q^6): negate the w component (unitary inverse)."""
    return (a[0], f6_neg(p, a[1]))


def f12_inv(p: int, xi: Fp2, a: Fp12, beta: int = -1) -> Fp12:
    a0, a1 = a
    t = f6_sub(
        p,
        f6_mul(p, xi, a0, a0, beta),
        f6_mul_by_v(p, xi, f6_mul(p, xi, a1, a1, beta), beta),
    )
    tinv = f6_inv(p, xi, t, beta)
    return (
        f6_mul(p, xi, a0, tinv, beta),
        f6_neg(p, f6_mul(p, xi, a1, tinv, beta)),
    )


def f12_pow(p: int, xi: Fp2, a: Fp12, e: int, beta: int = -1) -> Fp12:
    if e < 0:
        return f12_pow(p, xi, f12_inv(p, xi, a, beta), -e, beta)
    acc = f12_one()
    base = a
    while e:
        if e & 1:
            acc = f12_mul(p, xi, acc, base, beta)
        base = f12_mul(p, xi, base, base, beta)
        e >>= 1
    return acc
