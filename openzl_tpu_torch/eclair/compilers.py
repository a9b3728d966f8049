"""The three compilers behind the gadget API (the ``COM`` abstraction).

Port of `openzl_tpu/eclair/compilers.py`. One gadget function runs in three
environments (eclair/src/lib.rs:27-84):

  * :class:`NativeCompiler`: host Python ints mod p, a plain copy of the
    reference's.
  * :class:`TorchCompiler`: batched Montgomery limb tensors; the
    counterpart of the reference's `JaxCompiler`. Products go through
    kernel K1 on a CUDA tensor, inversions through K1's exponentiation.
  * :class:`R1CSCompiler`: records constraints into an :class:`R1CS`.
    The port's copy of the Poseidon gadget (`crypto.poseidon.gadget`) and
    the EC and Schnorr gadgets run unchanged under it.

Constraint-count semantics mirror the arkworks R1CS compiler: add, sub,
neg and scale are free; mul, square and inv cost one constraint; is_eq two;
assert_eq one; a bit decomposition one booleanity constraint per bit plus
one packing constraint.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields import limb
from ..fields.spec import LIMB_BITS, FieldSpec
from .r1cs import R1CS, LinComb, SynthesisMode


# ---------------------------------------------------------------------------
# Native (host int) compiler
# ---------------------------------------------------------------------------


class NativeCompiler:
    """Field values are Python ints in [0, p); booleans are Python bools."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus

    # allocation: native execution passes values through
    # (eclair/src/alloc.rs Constant/Variable collapse to identity for COM=())
    def constant(self, x: int):
        return x % self.p

    def public_input(self, x: int):
        return x % self.p

    def secret_witness(self, x: int):
        return x % self.p

    # arithmetic
    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def square(self, a):
        return a * a % self.p

    def mul_const(self, a, c: int):
        return a * c % self.p

    def add_const(self, a, c: int):
        return (a + c) % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def pow5(self, a):
        return pow(a, 5, self.p)

    # boolean structure (eclair/src/bool.rs)
    def bool_constant(self, b: bool):
        return bool(b)

    def and_(self, a, b):
        return a and b

    def or_(self, a, b):
        return a or b

    def xor_(self, a, b):
        return a != b

    def not_(self, a):
        return not a

    def assert_true(self, b):
        assert b, "native assertion failed"

    def assert_eq(self, a, b):
        assert a % self.p == b % self.p, f"native assert_eq failed: {a} != {b}"

    def is_eq(self, a, b):
        return a % self.p == b % self.p

    def is_zero(self, a):
        return a % self.p == 0

    def select(self, bit, a, b):
        """bit ? a : b (eclair/src/bool.rs:137-160 ConditionalSelect)."""
        return a if bit else b

    def swap(self, bit, a, b):
        """(a, b) -> (b, a) when bit (eclair/src/bool.rs:209-216)."""
        return (b, a) if bit else (a, b)

    # bits (eclair/src/bool.rs:83-109 BitDecomposition, num.rs range assert)
    def to_bits_le(self, a, n_bits: int):
        # Semantic parity with the R1CS compiler: a partial decomposition
        # there is unsatisfiable when a >= 2^n_bits, so native execution
        # must fail too rather than silently truncate.
        assert 0 <= a < (1 << n_bits), f"{a} exceeds {n_bits} bits"
        return [bool((a >> i) & 1) for i in range(n_bits)]

    def from_bits_le(self, bits):
        return sum(1 << i for i, b in enumerate(bits) if b) % self.p

    def assert_within_bit_range(self, a, n_bits: int):
        assert 0 <= a < (1 << n_bits), f"{a} out of {n_bits}-bit range"

    def divmod_hint(self, a, modulus: int):
        """(a // modulus, a % modulus): hint pair for gadgets.div_rem_mod_prime."""
        return divmod(a, modulus)


# ---------------------------------------------------------------------------
# Batched torch compiler (the card's compute path)
# ---------------------------------------------------------------------------


class TorchCompiler:
    """Field values are Montgomery limb tensors (n_limbs, *batch) in
    `limb.DTYPE`; booleans are `torch.bool` tensors of the batch shape.
    Every op works on the whole batch at once, with no data-dependent
    Python control flow. Reference: `JaxCompiler`
    (`openzl_tpu/eclair/compilers.py:142`). Like it, this compiler has no
    `divmod_hint`: bigint division has no batched limb form.

    `device` defaults to "cuda", where products launch K1 and inversions
    K1's exponentiation; "cpu" runs their plain versions."""

    def __init__(self, spec: FieldSpec, batch_shape: Tuple[int, ...] = (), device="cuda"):
        self.spec = spec
        self.p = spec.modulus
        self.batch_shape = tuple(batch_shape)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchCompiler on cuda, but torch sees no CUDA device")
        self._consts: dict = {}

    def _const(self, x: int) -> torch.Tensor:
        """Montgomery limbs of x mod p, shaped (n_limbs, 1, ...) on the
        compiler's device (one host packing per distinct constant)."""
        x %= self.p
        t = self._consts.get(x)
        if t is None:
            shape = (self.spec.n_limbs,) + (1,) * len(self.batch_shape)
            t = limb.tensor(limb.pack_mont(self.spec, x), self.device).reshape(shape)
            self._consts[x] = t
        return t

    # allocation: ints lift to constant Montgomery tensors; tensors pass through
    def constant(self, x):
        if isinstance(x, int):
            return self._const(x).expand((self.spec.n_limbs,) + self.batch_shape)
        return x

    public_input = constant
    secret_witness = constant

    # arithmetic
    def add(self, a, b):
        return limb.add(self.spec, a, b)

    def sub(self, a, b):
        return limb.sub(self.spec, a, b)

    def neg(self, a):
        return limb.neg(self.spec, a)

    def mul(self, a, b):
        return limb.mont_mul(self.spec, a, b)

    def square(self, a):
        return limb.mont_sqr(self.spec, a)

    def mul_const(self, a, c: int):
        return limb.mont_mul(self.spec, a, self._const(c))

    def add_const(self, a, c: int):
        return limb.add(self.spec, a, self.constant(c))

    def inv(self, a):
        return limb.mont_inv(self.spec, a)

    def pow5(self, a):
        return limb.mont_pow5(self.spec, a)

    # boolean structure
    def bool_constant(self, b: bool):
        return torch.full(self.batch_shape, bool(b), dtype=torch.bool, device=self.device)

    def and_(self, a, b):
        return torch.logical_and(a, b)

    def or_(self, a, b):
        return torch.logical_or(a, b)

    def xor_(self, a, b):
        return torch.logical_xor(a, b)

    def not_(self, a):
        return torch.logical_not(a)

    def assert_true(self, b):
        # returns the mask for the caller to check after the batch ran
        return b

    def assert_eq(self, a, b):
        return limb.eq(a, b)

    def is_eq(self, a, b):
        return limb.eq(a, b)

    def is_zero(self, a):
        return limb.is_zero(a)

    def _mask(self, bit, a):
        return torch.as_tensor(bit, device=self.device).expand(a.shape[1:])

    def select(self, bit, a, b):
        return limb.select(self._mask(bit, a), a, b)

    def swap(self, bit, a, b):
        bit = self._mask(bit, a)
        return limb.select(bit, b, a), limb.select(bit, a, b)

    # bits: canonical-form little-endian booleans
    def to_bits_le(self, a, n_bits: int):
        canon = limb.from_mont(self.spec, a)
        return [((canon[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1).bool() for i in range(n_bits)]

    def from_bits_le(self, bits):
        out = torch.zeros((self.spec.n_limbs,) + tuple(bits[0].shape), dtype=limb.DTYPE, device=self.device)
        for i, b in enumerate(bits):
            out[i // LIMB_BITS] += b.to(limb.DTYPE) << (i % LIMB_BITS)
        return limb.to_mont(self.spec, out)

    def assert_within_bit_range(self, a, n_bits: int):
        canon = limb.from_mont(self.spec, a)
        mask_ok = torch.ones(canon.shape[1:], dtype=torch.bool, device=canon.device)
        for i in range(self.spec.n_limbs):
            lo = i * LIMB_BITS
            if lo >= n_bits:
                mask_ok &= canon[i] == 0
            elif lo + LIMB_BITS > n_bits:
                mask_ok &= (canon[i] >> (n_bits - lo)) == 0
        return mask_ok


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
