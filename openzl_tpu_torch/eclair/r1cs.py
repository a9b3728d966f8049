"""Rank-1 constraint system: sparse linear combinations over a prime field.

Carried unchanged from `openzl_tpu/eclair/r1cs.py`, which is pure Python
but cannot be imported without JAX: `openzl_tpu/eclair/__init__.py` imports
`compilers`, and `compilers` imports `jax.numpy`. This copy goes away when
`openzl_tpu/eclair/__init__.py` imports lazily (ROADMAP.md, modules to
port, item 5).

Variable indexing follows the Groth16 convention: column 0 is the constant
ONE, columns [1, 1+num_instance) are public inputs, the rest are witnesses.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np


class SynthesisMode(enum.Enum):
    """Setup records constraints only; Prove also carries the assignment.

    Mirrors `R1CS::for_contexts` / `R1CS::for_proofs`
    (plugins/arkworks/src/constraint/mod.rs:82-99).
    """

    SETUP = "setup"
    PROVE = "prove"


class LinComb:
    """Sparse linear combination {var_index: coefficient mod p}."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[int, int]] = None):
        self.terms = terms or {}

    @classmethod
    def constant(cls, c: int) -> "LinComb":
        return cls({0: c} if c else {})

    @classmethod
    def single(cls, index: int, coeff: int = 1) -> "LinComb":
        return cls({index: coeff} if coeff else {})

    def scaled_add(self, other: "LinComb", scale: int, p: int) -> "LinComb":
        terms = dict(self.terms)
        for idx, coeff in other.terms.items():
            v = (terms.get(idx, 0) + scale * coeff) % p
            if v:
                terms[idx] = v
            else:
                terms.pop(idx, None)
        return LinComb(terms)

    def add(self, other: "LinComb", p: int) -> "LinComb":
        return self.scaled_add(other, 1, p)

    def sub(self, other: "LinComb", p: int) -> "LinComb":
        return self.scaled_add(other, -1, p)

    def scale(self, c: int, p: int) -> "LinComb":
        c %= p
        if c == 0:
            return LinComb()
        return LinComb({i: (v * c) % p for i, v in self.terms.items()})

    def eval(self, assignment: List[int], p: int) -> int:
        return sum(c * assignment[i] for i, c in self.terms.items()) % p

    def as_constant(self) -> Optional[int]:
        """The constant value if this lc only touches column 0, else None."""
        if not self.terms:
            return 0
        if len(self.terms) == 1 and 0 in self.terms:
            return self.terms[0]
        return None

    def __repr__(self) -> str:
        return f"LinComb({self.terms})"


@dataclasses.dataclass
class R1CS:
    """Constraint collector: rows (a, b, c) enforcing <a,z> * <b,z> = <c,z>."""

    p: int
    mode: SynthesisMode = SynthesisMode.PROVE

    def __post_init__(self):
        self.num_instance = 0  # excluding the leading ONE
        self.num_witness = 0
        self.instance_values: List[int] = []
        self.witness_values: List[int] = []
        self.constraints: List[Tuple[LinComb, LinComb, LinComb]] = []
        # Hint tape: how each DERIVED witness is computed from earlier
        # columns — ("mul", lcA, lcB, key) / ("inv", lcA, key) /
        # ("iszero", lcA, z_key, inv_key) / ("bits", lcA, [keys]) /
        # ("divmod", lcA, modulus, q_key, r_key). Witness keys absent from
        # the tape are LEAF witnesses (user-provided). The tape lets a
        # WitnessCalculator re-derive the full assignment from leaf values
        # alone — the framework's analogue of re-running arkworks circuit
        # synthesis (reference groth16.rs:446-457), but replayable in
        # native code without re-tracing Python gadgets.
        self.hints: List[Tuple] = []

    # ------------------------------------------------------------------
    # allocation (reference alloc modes: eclair/src/alloc.rs:430-485)
    # ------------------------------------------------------------------

    @property
    def is_setup(self) -> bool:
        return self.mode is SynthesisMode.SETUP

    def alloc_instance(self, value: Optional[int]) -> int:
        """Public-input column; returns its key (1..num_instance).

        Instances and witnesses may be allocated in ANY order (matching the
        reference, which supports arbitrary interleaving): witness keys are
        provisional negative ints, mapped to their final global columns —
        after all instance columns — by `column`/`remap` at export time.
        """
        self.num_instance += 1
        if not self.is_setup:
            assert value is not None, "prove mode requires assigned values"
            self.instance_values.append(value % self.p)
        return self.num_instance  # columns 1..num_instance

    def alloc_witness(self, value: Optional[int]) -> int:
        """Witness column; returns a provisional key -(j+1) for witness j."""
        self.num_witness += 1
        if not self.is_setup:
            assert value is not None, "prove mode requires assigned values"
            self.witness_values.append(value % self.p)
        return -self.num_witness

    def column(self, key: int) -> int:
        """Final global column of a variable key: [ONE, instances, witnesses]."""
        return key if key >= 0 else self.num_instance_total + (-key - 1)

    def remap(self, lc: LinComb) -> LinComb:
        """LinComb with provisional keys resolved to global columns."""
        return LinComb({self.column(k): v for k, v in lc.terms.items()})

    def eval_lc(self, lc: LinComb, z: List[int]) -> int:
        return sum(c * z[self.column(i)] for i, c in lc.terms.items()) % self.p

    @property
    def num_instance_total(self) -> int:
        """Instance columns including the leading ONE."""
        return self.num_instance + 1

    @property
    def num_variables(self) -> int:
        return self.num_instance_total + self.num_witness

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------

    def enforce(self, a: LinComb, b: LinComb, c: LinComb) -> None:
        self.constraints.append((a, b, c))

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    # ------------------------------------------------------------------
    # evaluation / satisfiability (the circuit test oracle,
    # reference constraint/mod.rs:101-107)
    # ------------------------------------------------------------------

    def assignment(self) -> List[int]:
        assert not self.is_setup
        return [1] + self.instance_values + self.witness_values

    def is_satisfied(self) -> bool:
        z = self.assignment()
        p = self.p
        return all(
            (self.eval_lc(a, z) * self.eval_lc(b, z) - self.eval_lc(c, z)) % p
            == 0
            for a, b, c in self.constraints
        )

    def which_unsatisfied(self) -> Optional[int]:
        z = self.assignment()
        p = self.p
        for i, (a, b, c) in enumerate(self.constraints):
            if (
                self.eval_lc(a, z) * self.eval_lc(b, z) - self.eval_lc(c, z)
            ) % p != 0:
                return i
        return None

    # ------------------------------------------------------------------
    # export for the prover (sparse COO over constraint rows)
    # ------------------------------------------------------------------

    def matrices_coo(self):
        """(A, B, C) as (rows, cols, vals[int object]) numpy triples."""

        def mat(pick):
            rows, cols, vals = [], [], []
            for r, trip in enumerate(self.constraints):
                for col, coeff in pick(trip).terms.items():
                    rows.append(r)
                    cols.append(self.column(col))
                    vals.append(coeff)
            return (
                np.array(rows, dtype=np.int64),
                np.array(cols, dtype=np.int64),
                np.array(vals, dtype=object),
            )

        return mat(lambda t: t[0]), mat(lambda t: t[1]), mat(lambda t: t[2])
