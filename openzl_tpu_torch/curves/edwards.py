"""Embedded twisted Edwards curves (Baby Jubjub, Jubjub) — in-circuit EC.

The port's own copy of `openzl_tpu/curves/edwards.py` (host Python, no
JAX), without `ed_on_bls12_377`: the port has no BLS12-377 Fr spec and
runs over BN254 and BLS12-381 only.

These curves' BASE field equals a pairing curve's SCALAR field, so their
points can live inside circuits as ordinary field variables: Baby Jubjub
embeds in BN254 Fr, Jubjub in BLS12-381 Fr — the same pairs the reference
uses through arkworks' ed_on_bn254 / ed_on_bls12_381 features
(plugins/arkworks/Cargo.toml curve matrix; ScalarVar safety requirement
"embedded modulus < outer modulus" in plugins/arkworks/src/algebra.rs:28-52).

Twisted Edwards form a*x^2 + y^2 = 1 + d*x^2*y^2 with COMPLETE addition —
branch-free, which is what both the R1CS gadgets and batched TPU kernels
want (no incomplete-case masking like the Weierstrass Jacobian path).

Constants: Baby Jubjub follows EIP-2494 (a=168700, d=168696, the standard
prime-order base point). Jubjub follows the zcash construction
(a=-1, d=-10240/10241); its generator is DERIVED deterministically here
(smallest valid y, even x, cofactor-cleared) and validated by the subgroup
checks in `validate` — byte-level interop for Jubjub points is therefore
instance-specific, while the curve equation and order match zcash/arkworks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from ..fields.spec import BLS12_381_FR, BN254_FR, FieldSpec

Point = Tuple[int, int]  # affine (x, y); identity = (0, 1)


@dataclasses.dataclass(frozen=True)
class EdwardsSpec:
    """a*x^2 + y^2 = 1 + d*x^2*y^2 over `base`, prime subgroup `order`."""

    name: str
    base: FieldSpec  # coordinate field (= outer circuit scalar field)
    a: int
    d: int
    order: int  # prime subgroup order
    cofactor: int
    gen: Point

    @property
    def scalar_bits(self) -> int:
        return self.order.bit_length()


def identity() -> Point:
    return (0, 1)


def is_identity(P: Point) -> bool:
    return P == (0, 1)


def is_on_curve(spec: EdwardsSpec, P: Point) -> bool:
    p = spec.base.modulus
    x, y = P
    return (spec.a * x * x + y * y) % p == (1 + spec.d * x * x * y * y) % p


def add(spec: EdwardsSpec, P: Point, Q: Point) -> Point:
    """Complete twisted Edwards addition (no special cases)."""
    p = spec.base.modulus
    x1, y1 = P
    x2, y2 = Q
    x1x2 = x1 * x2 % p
    y1y2 = y1 * y2 % p
    dxy = spec.d * x1x2 % p * y1y2 % p
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, p) % p
    y3 = (y1y2 - spec.a * x1x2) * pow(1 - dxy, -1, p) % p
    return (x3, y3)


def double(spec: EdwardsSpec, P: Point) -> Point:
    return add(spec, P, P)


def neg(spec: EdwardsSpec, P: Point) -> Point:
    return ((-P[0]) % spec.base.modulus, P[1])


def scalar_mul(spec: EdwardsSpec, k: int, P: Point) -> Point:
    k %= spec.order
    acc = identity()
    while k:
        if k & 1:
            acc = add(spec, acc, P)
        P = double(spec, P)
        k >>= 1
    return acc


def _sqrt(p: int, n: int) -> Optional[int]:
    """Tonelli-Shanks square root mod p (None if n is a non-residue)."""
    n %= p
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(n, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(n, q, p), pow(n, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


def _x_for_y(spec: EdwardsSpec, y: int) -> Optional[int]:
    """Solve a*x^2 + y^2 = 1 + d*x^2*y^2 for x; smaller root or None."""
    p = spec.base.modulus
    num = (1 - y * y) % p
    den = (spec.a - spec.d * y * y) % p
    if den == 0:
        return None
    x = _sqrt(p, num * pow(den, -1, p) % p)
    if x is None:
        return None
    return min(x, p - x)


def _derive_generator(spec_no_gen: "EdwardsSpec") -> Point:
    """Deterministic generator: smallest y >= 2 giving a curve point, take
    the even-x root, clear the cofactor, require a nonzero result."""
    y = 2
    while True:
        x = _x_for_y(spec_no_gen, y)
        if x is not None and x != 0:
            if x % 2 != 0:
                x = spec_no_gen.base.modulus - x
            G = scalar_mul(
                dataclasses.replace(spec_no_gen, gen=(x, y)),
                spec_no_gen.cofactor,
                (x, y),
            )
            if not is_identity(G):
                return G
        y += 1


#: Baby Jubjub (EIP-2494): embedded in BN254 Fr. Base point = the standard
#: generator of the prime-order subgroup (EIP-2494 "Base point").
BABY_JUBJUB = EdwardsSpec(
    name="baby_jubjub",
    base=BN254_FR,
    a=168700,
    d=168696,
    order=2736030358979909402780800718157159386076813972158567259200215660948447373041,
    cofactor=8,
    gen=(
        5299619240641551281634865583518297030282874472190772894086521144482721001553,
        16950150798460657717958625567821834550301663161624707787222815936182638968203,
    ),
)


@functools.lru_cache(maxsize=None)
def _jubjub() -> EdwardsSpec:
    q = BLS12_381_FR.modulus
    base = EdwardsSpec(
        name="jubjub",
        base=BLS12_381_FR,
        a=q - 1,
        d=(-10240 * pow(10241, -1, q)) % q,
        order=6554484396890773809930967563523245729705921265872317281365359162392183254199,
        cofactor=8,
        gen=(0, 1),
    )
    return dataclasses.replace(base, gen=_derive_generator(base))


def jubjub() -> EdwardsSpec:
    """Jubjub (zcash; arkworks ed_on_bls12_381) with a derived generator."""
    return _jubjub()


def validate(spec: EdwardsSpec) -> None:
    """Structural checks: generator on curve, has the claimed prime order,
    and 8*order is a plausible group order (Hasse bound)."""
    import math

    p = spec.base.modulus
    assert is_on_curve(spec, spec.gen), "generator not on curve"
    assert not is_identity(spec.gen)
    assert is_identity(scalar_mul(spec, 0, spec.gen))
    # order * G = identity and order prime => G generates the subgroup
    acc = scalar_mul(spec, spec.order - 1, spec.gen)
    assert add(spec, acc, spec.gen) == identity(), "generator order mismatch"
    n = spec.cofactor * spec.order
    assert abs(n - (p + 1)) <= 2 * math.isqrt(p) + 1, "Hasse bound violated"
    assert spec.order < p, "embedded scalar field must fit in the base field"
