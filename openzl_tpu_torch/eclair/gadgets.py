"""Generic eclair gadgets shared by all compilers (duck-typed over `com`).

The port's own copy of `openzl_tpu/eclair/gadgets.py` (host Python, no JAX):

  * select_from_table — log-depth table mux driven by selection bits
    (reference eclair/src/bool.rs:150-186 `ConditionalSelect::select_from_table`)
  * UnsignedInteger / U8..U256 — range-enforced integer wrapper
    (reference eclair/src/num.rs:115-395)
  * div_rem_mod_prime / rem_mod_prime — in-circuit Euclidean reduction by a
    smaller prime modulus (reference plugins/arkworks/src/constraint/mod.rs:
    432-499 `Rem<PrimeModulus<R>>` + `div_rem_mod_prime`)

Every function takes `com` first and works identically under
NativeCompiler, TorchCompiler and R1CSCompiler — one source of truth for
native and in-circuit semantics (SURVEY.md layer map L3).
"""

from __future__ import annotations

from typing import List, Sequence


def select_from_table(com, bits: Sequence, table: Sequence):
    """Mux `table[sum bits_i 2^i]` with a log-depth select tree.

    bits: little-endian selection bits; table length must be 2^len(bits).
    Each level pairs adjacent entries and selects by the next bit, so the
    constraint count is 2^k - 1 selects instead of k*2^k
    (reference bool.rs:150-186, which uses the same pairwise chunking via
    `chunk_by`). Entries may be tuples/lists (e.g. curve points); they are
    selected component-wise.
    """
    n = len(table)
    assert n == 1 << len(bits), "table size must be 2^bits"

    def sel(bit, a, b):
        if isinstance(a, (tuple, list)):
            return type(a)(com.select(bit, x, y) for x, y in zip(a, b))
        return com.select(bit, a, b)

    level = list(table)
    for bit in bits:
        level = [
            sel(bit, level[2 * i + 1], level[2 * i])
            for i in range(len(level) // 2)
        ]
    assert len(level) == 1
    return level[0]


class UnsignedInteger:
    """A field element constrained to [0, 2^BITS).

    Construction range-checks by bit decomposition; arithmetic re-asserts
    the range on the result (reference num.rs:115-167: `UnsignedInteger::new`
    asserts on new/mutate). The wrapper stores the variable and its bits so
    downstream gadgets (shifts, comparisons) reuse the decomposition.
    """

    __slots__ = ("var", "bits", "n_bits")

    def __init__(self, var, bits: List, n_bits: int):
        self.var = var
        self.bits = bits
        self.n_bits = n_bits

    @classmethod
    def new(cls, com, var, n_bits: int) -> "UnsignedInteger":
        """Wrap `var`, asserting it fits in `n_bits` (num.rs:129-141)."""
        bits = com.to_bits_le(var, n_bits)
        return cls(var, bits, n_bits)

    @classmethod
    def from_bits(cls, com, bits: Sequence) -> "UnsignedInteger":
        return cls(com.from_bits_le(list(bits)), list(bits), len(bits))

    # -- arithmetic (result re-constrained to the range) -------------------

    def add(self, com, other: "UnsignedInteger") -> "UnsignedInteger":
        """Addition mod 2^BITS: decompose the raw sum into BITS+1 bits and
        drop the carry (wrapping semantics, num.rs AddAssign)."""
        assert self.n_bits == other.n_bits
        raw = com.add(self.var, other.var)
        bits = com.to_bits_le(raw, self.n_bits + 1)
        return UnsignedInteger.from_bits(com, bits[: self.n_bits])

    def add_checked(self, com, other: "UnsignedInteger") -> "UnsignedInteger":
        """Addition that must not overflow: asserts the sum itself fits."""
        assert self.n_bits == other.n_bits
        raw = com.add(self.var, other.var)
        return UnsignedInteger.new(com, raw, self.n_bits)

    def mul(self, com, other: "UnsignedInteger") -> "UnsignedInteger":
        """Multiplication mod 2^BITS (requires 2*BITS < field bits)."""
        assert self.n_bits == other.n_bits
        raw = com.mul(self.var, other.var)
        bits = com.to_bits_le(raw, 2 * self.n_bits)
        return UnsignedInteger.from_bits(com, bits[: self.n_bits])

    def shr(self, com, k: int) -> "UnsignedInteger":
        """Logical right shift by a constant (free: reuses the bits)."""
        bits = self.bits[k:] + [com.bool_constant(False)] * min(k, self.n_bits)
        return UnsignedInteger.from_bits(com, bits[: self.n_bits])

    def shl(self, com, k: int) -> "UnsignedInteger":
        """Left shift by a constant, dropping overflow bits."""
        bits = [com.bool_constant(False)] * min(k, self.n_bits) + self.bits
        return UnsignedInteger.from_bits(com, bits[: self.n_bits])

    def is_eq(self, com, other: "UnsignedInteger"):
        return com.is_eq(self.var, other.var)

    def assert_eq(self, com, other: "UnsignedInteger") -> None:
        com.assert_eq(self.var, other.var)


def div_rem_mod_prime(com, x, modulus: int):
    """In-circuit Euclidean reduction: returns (q, r) with x = q*modulus + r
    and r < modulus enforced by constraints.

    Mirrors the reference's `Rem<PrimeModulus<R>> for FpVar` + host helper
    `div_rem_mod_prime` (plugins/arkworks/src/constraint/mod.rs:432-499),
    used to reduce an outer-field element to an embedded-curve scalar. One
    strengthening over the reference: the quotient is range-bounded too (the
    reference leaves q unconstrained beyond the Euclidean identity). As in
    the reference, a malicious prover retains one degree of slack — q*M + r
    can wrap the outer modulus once, yielding r = (x + p) mod M; callers
    needing exact canonical reduction must bound x themselves.

    Works under NativeCompiler (ints) and R1CSCompiler (FpVar; in setup mode
    the hint witnesses are unvalued). Not supported under TorchCompiler —
    bigint division has no batched limb form (and the reference gadget is
    likewise R1CS-only).
    """
    p = com.p
    assert 1 < modulus < p, "modulus must be a smaller prime than the field"
    q, r = com.divmod_hint(x, modulus)
    # Euclidean identity: x == q * modulus + r
    com.assert_eq(x, com.add(com.mul_const(q, modulus), r))
    m_bits = modulus.bit_length()
    assert m_bits + 1 < p.bit_length(), "modulus too close to the field width"
    # r < modulus: r and (modulus-1) - r both fit in m_bits bits. The second
    # check cannot wrap undetected: a negative difference lands in
    # (p - 2^m_bits, p), far above 2^m_bits since p > 2^(m_bits+1).
    com.assert_within_bit_range(r, m_bits)
    com.assert_within_bit_range(
        com.add_const(com.neg(r), modulus - 1), m_bits
    )
    com.assert_within_bit_range(q, p.bit_length() - m_bits + 1)
    return q, r


def rem_mod_prime(com, x, modulus: int):
    """`x mod modulus` in-circuit (the reference's `Rem` op surface)."""
    return div_rem_mod_prime(com, x, modulus)[1]


def _alias(n_bits: int):
    class _U(UnsignedInteger):
        BITS = n_bits

        @classmethod
        def new(cls, com, var):  # noqa: D102 - specialization
            return UnsignedInteger.new(com, var, n_bits)

    _U.__name__ = f"U{n_bits}"
    return _U


#: Type aliases matching the reference's U8..U256 (num.rs:357-366). U256
#: only exists for fields wider than 256 bits.
U8 = _alias(8)
U16 = _alias(16)
U32 = _alias(32)
U64 = _alias(64)
U128 = _alias(128)
U256 = _alias(256)
