"""Constraint-count instrumentation.

The port's own copy of `openzl_tpu/eclair/measure.py` (host Python, no JAX).

Re-creates the reference's `Measure`/`Size`/`Instrument` machinery
(openzl-crypto/src/constraint.rs:140-378) over the R1CS compiler's counters
(reference counter source: plugins/arkworks/src/constraint/mod.rs:147-177).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class Size:
    """A snapshot of compiler size counters (reference constraint.rs:205-283)."""

    constraints: int = 0
    instance_variables: int = 0
    witness_variables: int = 0

    def diff(self, earlier: "Size") -> "Size":
        return Size(
            self.constraints - earlier.constraints,
            self.instance_variables - earlier.instance_variables,
            self.witness_variables - earlier.witness_variables,
        )

    def __add__(self, other: "Size") -> "Size":
        return Size(
            self.constraints + other.constraints,
            self.instance_variables + other.instance_variables,
            self.witness_variables + other.witness_variables,
        )


def measure(compiler) -> Size:
    """Current counters of an :class:`R1CSCompiler`."""
    cs = compiler.cs
    return Size(cs.num_constraints, cs.num_instance, cs.num_witness)


def measure_constraints(compiler, fn, *args, **kwargs):
    """(result, Size consumed by fn) — reference `Measure::measure`."""
    before = measure(compiler)
    result = fn(*args, **kwargs)
    return result, measure(compiler).diff(before)


class Instrument:
    """Labeled measurement spans (reference constraint.rs:311-378)."""

    def __init__(self, compiler):
        self.compiler = compiler
        self.measurements: List[Tuple[str, Size]] = []

    @contextlib.contextmanager
    def span(self, label: str):
        before = measure(self.compiler)
        yield self
        self.measurements.append((label, measure(self.compiler).diff(before)))

    def report(self) -> str:
        lines = [
            f"{label}: constraints={s.constraints} "
            f"instance={s.instance_variables} witness={s.witness_variables}"
            for label, s in self.measurements
        ]
        return "\n".join(lines)
