"""The R1CS compiler behind the gadget API.

Carried from `openzl_tpu/eclair/compilers.py`: `FpVar` and `R1CSCompiler`,
which are pure Python. The reference's `NativeCompiler` is not needed by the
prover and its `JaxCompiler` waits for a torch counterpart (ROADMAP.md,
modules to port, item 5). The port's copy of the Poseidon gadget
(`crypto.poseidon.gadget`) runs unchanged under this compiler.

Constraint-count semantics mirror the arkworks R1CS compiler: add, sub,
neg and scale are free; mul, square and inv cost one constraint; is_eq two;
assert_eq one; a bit decomposition one booleanity constraint per bit plus
one packing constraint.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..fields.spec import FieldSpec
from .r1cs import R1CS, LinComb, SynthesisMode


# ---------------------------------------------------------------------------
# R1CS trace compiler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FpVar:
    """A symbolic field value: linear combination (+ assignment in prove mode).

    The analogue of arkworks' `FpVar` (SURVEY.md section 2.8): additions and
    constant scalings stay symbolic; multiplications allocate a witness.
    """

    lc: LinComb
    value: Optional[int]  # None in setup mode


def _key(v: "FpVar") -> int:
    """Variable key of a freshly allocated (single-term, coeff-1) FpVar."""
    ((k, c),) = v.lc.terms.items()
    assert c == 1
    return k


class R1CSCompiler:
    """Records constraints; in prove mode also computes the full assignment."""

    def __init__(self, spec: FieldSpec, mode: SynthesisMode = SynthesisMode.PROVE):
        self.spec = spec
        self.p = spec.modulus
        self.cs = R1CS(spec.modulus, mode)

    @classmethod
    def for_contexts(cls, spec: FieldSpec) -> "R1CSCompiler":
        """Setup-mode compiler (reference constraint/mod.rs:82-90)."""
        return cls(spec, SynthesisMode.SETUP)

    @classmethod
    def for_proofs(cls, spec: FieldSpec) -> "R1CSCompiler":
        """Prove-mode compiler (reference constraint/mod.rs:94-99)."""
        return cls(spec, SynthesisMode.PROVE)

    @property
    def is_setup(self) -> bool:
        return self.cs.is_setup

    def _val(self, x: Optional[int]) -> Optional[int]:
        if self.is_setup:
            return None
        assert x is not None
        return x % self.p

    # allocation
    def constant(self, x: int) -> FpVar:
        x %= self.p
        return FpVar(LinComb.constant(x), None if self.is_setup else x)

    def public_input(self, x: Optional[int]) -> FpVar:
        v = self._val(x)
        idx = self.cs.alloc_instance(v)
        return FpVar(LinComb.single(idx), v)

    def secret_witness(self, x: Optional[int]) -> FpVar:
        v = self._val(x)
        idx = self.cs.alloc_witness(v)
        return FpVar(LinComb.single(idx), v)

    def _new_derived(self, value: Optional[int]) -> FpVar:
        v = None if self.is_setup else value % self.p
        idx = self.cs.alloc_witness(v)
        return FpVar(LinComb.single(idx), v)

    # arithmetic
    def add(self, a: FpVar, b: FpVar) -> FpVar:
        return FpVar(
            a.lc.add(b.lc, self.p),
            None if self.is_setup else (a.value + b.value) % self.p,
        )

    def sub(self, a: FpVar, b: FpVar) -> FpVar:
        return FpVar(
            a.lc.sub(b.lc, self.p),
            None if self.is_setup else (a.value - b.value) % self.p,
        )

    def neg(self, a: FpVar) -> FpVar:
        return FpVar(
            a.lc.scale(-1, self.p),
            None if self.is_setup else (-a.value) % self.p,
        )

    def mul_const(self, a: FpVar, c: int) -> FpVar:
        return FpVar(
            a.lc.scale(c, self.p),
            None if self.is_setup else (a.value * c) % self.p,
        )

    def add_const(self, a: FpVar, c: int) -> FpVar:
        return FpVar(
            a.lc.add(LinComb.constant(c % self.p), self.p),
            None if self.is_setup else (a.value + c) % self.p,
        )

    def mul(self, a: FpVar, b: FpVar) -> FpVar:
        # constant folding keeps counts tight (arkworks FpVar does the same)
        ca, cb = a.lc.as_constant(), b.lc.as_constant()
        if ca is not None:
            return self.mul_const(b, ca)
        if cb is not None:
            return self.mul_const(a, cb)
        out = self._new_derived(None if self.is_setup else a.value * b.value)
        self.cs.enforce(a.lc, b.lc, out.lc)
        self.cs.hints.append(("mul", a.lc, b.lc, _key(out)))
        return out

    def square(self, a: FpVar) -> FpVar:
        return self.mul(a, a)

    def inv(self, a: FpVar) -> FpVar:
        out = self._new_derived(
            None if self.is_setup else pow(a.value, -1, self.p)
        )
        self.cs.enforce(a.lc, out.lc, LinComb.constant(1))
        self.cs.hints.append(("inv", a.lc, _key(out)))
        return out

    def pow5(self, a: FpVar) -> FpVar:
        """S-box: 3 constraints (square, square, mul), matching arkworks
        `pow_by_constant([5])` (plugins/arkworks/src/poseidon/mod.rs:287-298).
        """
        a2 = self.square(a)
        a4 = self.square(a2)
        return self.mul(a4, a)

    # boolean structure — booleans are FpVars constrained to {0,1}
    def bool_constant(self, b: bool) -> FpVar:
        return self.constant(1 if b else 0)

    def alloc_bit(self, b: Optional[bool], *, public: bool = False) -> FpVar:
        v = None if self.is_setup else int(bool(b))
        bit = self.public_input(v) if public else self.secret_witness(v)
        self._enforce_boolean(bit)
        return bit

    def _enforce_boolean(self, bit: FpVar) -> None:
        # b * (1 - b) = 0
        one_minus = LinComb.constant(1).sub(bit.lc, self.p)
        self.cs.enforce(bit.lc, one_minus, LinComb())

    def and_(self, a: FpVar, b: FpVar) -> FpVar:
        return self.mul(a, b)

    def or_(self, a: FpVar, b: FpVar) -> FpVar:
        # a + b - a*b
        ab = self.mul(a, b)
        return self.sub(self.add(a, b), ab)

    def xor_(self, a: FpVar, b: FpVar) -> FpVar:
        # a + b - 2ab
        ab = self.mul(a, b)
        return self.sub(self.add(a, b), self.mul_const(ab, 2))

    def not_(self, a: FpVar) -> FpVar:
        return self.sub(self.constant(1), a)

    def assert_true(self, b: FpVar) -> None:
        self.cs.enforce(b.lc, LinComb.constant(1), LinComb.constant(1))

    def assert_eq(self, a: FpVar, b: FpVar) -> None:
        """(a - b) * 1 = 0 — one constraint (reference assert_eq optimization
        path, eclair/src/cmp.rs:19-50)."""
        self.cs.enforce(a.lc.sub(b.lc, self.p), LinComb.constant(1), LinComb())

    def is_zero(self, a: FpVar) -> FpVar:
        """Boolean z with z=1 iff a=0; 2 constraints (standard eq gadget)."""
        if self.is_setup:
            z = self._new_derived(None)
            inv = self._new_derived(None)
        else:
            av = a.value % self.p
            z = self._new_derived(1 if av == 0 else 0)
            inv = self._new_derived(0 if av == 0 else pow(av, -1, self.p))
        # a * inv = 1 - z   and   a * z = 0
        self.cs.enforce(a.lc, inv.lc, LinComb.constant(1).sub(z.lc, self.p))
        self.cs.enforce(a.lc, z.lc, LinComb())
        self.cs.hints.append(("iszero", a.lc, _key(z), _key(inv)))
        return z

    def is_eq(self, a: FpVar, b: FpVar) -> FpVar:
        return self.is_zero(self.sub(a, b))

    def select(self, bit: FpVar, a: FpVar, b: FpVar) -> FpVar:
        """out = b + bit*(a-b): 1 constraint (arkworks CondSelectGadget)."""
        d = self.mul(bit, self.sub(a, b))
        return self.add(b, d)

    def swap(self, bit: FpVar, a: FpVar, b: FpVar) -> Tuple[FpVar, FpVar]:
        """1 multiplication for both outputs: d = bit*(b-a); (a+d, b-d)."""
        d = self.mul(bit, self.sub(b, a))
        return self.add(a, d), self.sub(b, d)

    # bits
    def to_bits_le(self, a: FpVar, n_bits: int) -> List[FpVar]:
        """n booleanity constraints + 1 packing constraint.

        Completeness caveat matches arkworks partial decomposition: for
        n_bits < field size the packing constraint plus booleanity force a
        unique decomposition iff a < 2^n_bits (used by range asserts,
        reference constraint/mod.rs:128-145).
        """
        bits = []
        for i in range(n_bits):
            v = None if self.is_setup else (a.value >> i) & 1
            bit = self._new_derived(v)
            self._enforce_boolean(bit)
            bits.append(bit)
        packed = self.from_bits_le(bits)
        self.assert_eq(packed, a)
        self.cs.hints.append(("bits", a.lc, [_key(b) for b in bits]))
        return bits

    def from_bits_le(self, bits: Sequence[FpVar]) -> FpVar:
        lc = LinComb()
        value = 0
        for i, b in enumerate(bits):
            lc = lc.scaled_add(b.lc, 1 << i, self.p)
            if not self.is_setup:
                value += b.value << i
        return FpVar(lc, None if self.is_setup else value % self.p)

    def assert_within_bit_range(self, a: FpVar, n_bits: int) -> None:
        """Decompose and implicitly force high bits to zero by only
        allocating n_bits bits (reference constraint/mod.rs:128-145)."""
        self.to_bits_le(a, n_bits)

    def divmod_hint(self, a: FpVar, modulus: int) -> Tuple[FpVar, FpVar]:
        """Allocate (q, r) = divmod(a, modulus) as UNCONSTRAINED witnesses
        with a replayable tape entry; callers enforce the Euclidean identity
        (gadgets.div_rem_mod_prime, reference constraint/mod.rs:481-499)."""
        if self.is_setup:
            q, r = self._new_derived(None), self._new_derived(None)
        else:
            qv, rv = divmod(a.value, modulus)
            q, r = self._new_derived(qv), self._new_derived(rv)
        self.cs.hints.append(("divmod", a.lc, modulus, _key(q), _key(r)))
        return q, r
