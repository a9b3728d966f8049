"""Canonical serialization (reference openzl-util/src/codec.rs and the ark
bridges in plugins/arkworks/src/serialize.rs:21-141).

The port's own copy of `openzl_tpu/utils/codec.py` (without its stream
wrappers, which the port does not use).

Byte layout follows arkworks v0.3 CanonicalSerialize so persistent objects
(proofs, keys, parameters) interoperate:
  * field elements: little-endian canonical bytes, padded to 64-bit limb
    granularity (32 bytes for 254/255-bit fields, 48 for BLS12-381 Fq)
  * short-Weierstrass points, compressed: x-coordinate bytes with flags in
    the top bits of the LAST byte — bit 6 = infinity, bit 7 = y is the
    lexicographically larger square root (ark-serialize SWFlags)
  * Fq2: c0 then c1 (flags on c1's last byte for G2 points)
  * Vec<T>: u64 little-endian length prefix, then elements
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

from ..curves.spec import CurveSpec
from ..fields.spec import FieldSpec

_INFINITY_FLAG = 1 << 6
_LARGEST_Y_FLAG = 1 << 7


class DecodeError(ValueError):
    """Malformed serialized input.

    The reference codec returns `Result`s on decode failures
    (openzl-util/src/codec.rs Read/Decode error channels); the Python
    analogue is a typed exception callers can catch — malformed bytes must
    never abort the process via bare asserts.
    """


# ---------------------------------------------------------------------------
# field elements
# ---------------------------------------------------------------------------


def field_to_bytes(spec: FieldSpec, x: int) -> bytes:
    return (x % spec.modulus).to_bytes(spec.n_bytes, "little")


def field_from_bytes(spec: FieldSpec, data: bytes) -> int:
    if len(data) != spec.n_bytes:
        raise DecodeError(
            f"expected {spec.n_bytes} bytes, got {len(data)}"
        )
    x = int.from_bytes(data, "little")
    if x >= spec.modulus:
        raise DecodeError("non-canonical field encoding")
    return x


def _is_largest_y(spec: FieldSpec, y: int) -> bool:
    return y > spec.modulus - y


# ---------------------------------------------------------------------------
# curve points (affine int coords for G1; (c0, c1) pairs for G2)
# ---------------------------------------------------------------------------


def _flag_extra(curve: CurveSpec) -> int:
    """1 when the modulus leaves fewer than the 2 SWFlags bits spare in the
    top serialized byte (e.g. exact-multiple-of-64 moduli like P-256): the
    flags then ride in one extra trailing byte. 0 for every arkworks-config
    curve the reference ships (their layouts are unchanged)."""
    spec = curve.base
    return 1 if spec.bits + 2 > 8 * spec.n_bytes else 0


def point_to_bytes(curve: CurveSpec, pt, compressed: bool = True) -> bytes:
    spec = curve.base
    extra = _flag_extra(curve)

    def coord_bytes(c) -> bytearray:
        if curve.ext == 1:
            return bytearray(field_to_bytes(spec, c))
        return bytearray(
            field_to_bytes(spec, c[0]) + field_to_bytes(spec, c[1])
        )

    if pt is None:
        zero = 0 if curve.ext == 1 else (0, 0)
        out = coord_bytes(zero)
        if not compressed:
            out += coord_bytes(zero)
        out += bytes(extra)
        out[-1] |= _INFINITY_FLAG
        return bytes(out)

    x, y = pt
    out = coord_bytes(x)
    if compressed:
        if curve.ext == 1:
            y_big = _is_largest_y(spec, y)
        else:  # Fq2 sign: c1 decides unless zero, then c0 (ark convention)
            y_big = (
                _is_largest_y(spec, y[1])
                if y[1] != 0
                else _is_largest_y(spec, y[0])
            )
        out += bytes(extra)
        if y_big:
            out[-1] |= _LARGEST_Y_FLAG
    else:
        out += coord_bytes(y)
        out += bytes(extra)
    return bytes(out)


def _sqrt_mod(spec: FieldSpec, a: int) -> Optional[int]:
    p = spec.modulus
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


def point_size(curve: CurveSpec, compressed: bool = True) -> int:
    """Serialized byte length of one point (ark CanonicalSerialize)."""
    nb = curve.base.n_bytes * curve.ext
    return (nb if compressed else 2 * nb) + _flag_extra(curve)


def subgroup_check(curve: CurveSpec, pt) -> bool:
    """Prime-order subgroup membership: r * P == identity.

    ark's CanonicalDeserialize validates subgroup membership by default
    (Validate::Yes); curves with cofactor 1 need only the on-curve check
    (the whole curve IS the prime-order group). Raw double-and-add —
    ref.curve.scalar_mul reduces its scalar mod r, which would make the
    order multiplication vacuous."""
    if pt is None or curve.cofactor == 1:
        return True
    from ..ref import curve as refc

    k = curve.scalar.modulus  # the prime subgroup order r
    acc, base = None, pt
    while k:
        if k & 1:
            acc = refc.add(curve, acc, base)
        k >>= 1
        if k:
            base = refc.add(curve, base, base)
    return acc is None


def point_from_bytes(
    curve: CurveSpec, data: bytes, compressed: bool = True, validate: bool = True
):
    """Point decoding with on-curve check. Compressed recovers y from an
    Fq (or Fq2) square root; uncompressed reads both coordinates and
    validates the curve equation (ark deserialize_uncompressed still
    checks). `validate` additionally enforces prime-order subgroup
    membership (ark Validate::Yes); pass False only for trusted inputs
    (ark's deserialize_unchecked analogue)."""
    pt = _point_from_bytes_on_curve(curve, data, compressed)
    if validate and not subgroup_check(curve, pt):
        raise DecodeError("point not in the prime-order subgroup")
    return pt


def _point_from_bytes_on_curve(curve: CurveSpec, data: bytes, compressed: bool):
    spec = curve.base
    extra = _flag_extra(curve)
    if not compressed:
        nb = spec.n_bytes * curve.ext
        raw = bytearray(data[: 2 * nb + extra])
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        if flags & _INFINITY_FLAG:
            return None
        raw = raw[: 2 * nb]  # drop the flag byte once consumed

        def coord(b: bytes):
            if curve.ext == 1:
                return field_from_bytes(spec, b)
            return (
                field_from_bytes(spec, b[: spec.n_bytes]),
                field_from_bytes(spec, b[spec.n_bytes :]),
            )

        x, y = coord(bytes(raw[:nb])), coord(bytes(raw[nb:]))
        p = spec.modulus
        if curve.ext == 1:
            on = (y * y - (x * x * x + curve.a * x + curve.b)) % p == 0
        else:
            from ..ref import fields as tf

            nr = curve.nr2
            rhs = tf.f2_add(
                p, tf.f2_mul(p, tf.f2_mul(p, x, x, nr), x, nr), curve.b
            )
            rhs = _f2_add_ax(curve, x, rhs)
            on = tf.f2_sub(p, tf.f2_mul(p, y, y, nr), rhs) == (0, 0)
        if not on:
            raise DecodeError("point not on curve (uncompressed)")
        return (x, y)
    nb = spec.n_bytes * curve.ext
    raw = bytearray(data[: nb + extra])
    flags = raw[-1] & 0xC0
    raw[-1] &= 0x3F
    if flags & _INFINITY_FLAG:
        return None
    raw = raw[:nb]
    if curve.ext == 1:
        x = field_from_bytes(spec, bytes(raw))
        y2 = (x * x * x + curve.a * x + curve.b) % spec.modulus
        y = _sqrt_mod(spec, y2)
        if y is None:
            raise DecodeError("x not on curve")
        if _is_largest_y(spec, y) != bool(flags & _LARGEST_Y_FLAG):
            y = spec.modulus - y
        return (x, y)
    # ext == 2
    from ..ref import fields as tf

    p = spec.modulus
    x = (
        field_from_bytes(spec, bytes(raw[: spec.n_bytes])),
        field_from_bytes(spec, bytes(raw[spec.n_bytes :])),
    )
    rhs = tf.f2_add(
        p, tf.f2_mul(p, tf.f2_mul(p, x, x, curve.nr2), x, curve.nr2), curve.b
    )
    rhs = _f2_add_ax(curve, x, rhs)
    y = _f2_sqrt(spec, rhs, curve.nr2)
    if y is None:
        raise DecodeError("x not on curve (G2)")
    flag_bit = bool(flags & _LARGEST_Y_FLAG)
    y_big = _is_largest_y(spec, y[1]) if y[1] != 0 else _is_largest_y(spec, y[0])
    if y_big != flag_bit:
        y = tf.f2_neg(p, y)
    return (x, y)


def _f2_add_ax(curve: CurveSpec, x, rhs):
    """rhs + a*x in Fq2 (a = 0 for the pairing towers; generic-a parity)."""
    if curve.a == 0:
        return rhs
    from ..ref import fields as tf

    p = curve.base.modulus
    a = curve.a if isinstance(curve.a, tuple) else (curve.a % p, 0)
    return tf.f2_add(p, rhs, tf.f2_mul(p, a, x, curve.nr2))


def _f2_sqrt(spec: FieldSpec, a, beta: int = -1) -> Optional[Tuple[int, int]]:
    """Square root in Fp2 = Fp[u]/(u^2 - beta) via norm descent.

    beta is the curve's quadratic non-residue (CurveSpec.nr2): -1 for
    BN254/BLS12-381, -5 for BLS12-377."""
    from ..ref import fields as tf

    p = spec.modulus
    if a == (0, 0):
        return (0, 0)
    a0, a1 = a
    if a1 == 0:
        r = _sqrt_mod(spec, a0)
        if r is not None:
            return (r, 0)
        # a0 = beta * b^2 -> sqrt = b*u  (works for any non-residue beta)
        r = _sqrt_mod(spec, a0 * pow(beta % p, -1, p) % p)
        return None if r is None else (0, r)
    # norm = a0^2 - beta a1^2 must be a QR in Fp for a square
    norm = (a0 * a0 - beta * a1 * a1) % p
    n = _sqrt_mod(spec, norm)
    if n is None:
        return None
    inv2 = pow(2, -1, p)
    for sign in (1, -1):
        c0 = (a0 + sign * n) % p * inv2 % p
        x0 = _sqrt_mod(spec, c0)
        if x0 is None or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0, -1, p) % p
        cand = (x0, x1)
        if tf.f2_mul(p, cand, cand, beta) == (a0 % p, a1 % p):
            return cand
    return None


# ---------------------------------------------------------------------------
# compound writers (Vec with u64 LE length prefix, ark convention)
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def bytes_(self, b: bytes):
        self.buf.write(b)

    def u64(self, n: int):
        self.buf.write(int(n).to_bytes(8, "little"))

    def field(self, spec: FieldSpec, x: int):
        self.buf.write(field_to_bytes(spec, x))

    def point(self, curve: CurveSpec, pt, compressed=True):
        self.buf.write(point_to_bytes(curve, pt, compressed))

    def vec(self, items, write_item):
        self.u64(len(items))
        for item in items:
            write_item(item)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    def bytes_(self, n: int) -> bytes:
        out = self.buf.read(n)
        if len(out) != n:
            raise DecodeError("unexpected end of input")
        return out

    def u64(self) -> int:
        return int.from_bytes(self.bytes_(8), "little")

    def field(self, spec: FieldSpec) -> int:
        return field_from_bytes(spec, self.bytes_(spec.n_bytes))

    def point(self, curve: CurveSpec, compressed: bool = True, validate: bool = True):
        return point_from_bytes(
            curve, self.bytes_(point_size(curve, compressed)), compressed, validate
        )

    def vec(self, read_item) -> List:
        return [read_item() for _ in range(self.u64())]
