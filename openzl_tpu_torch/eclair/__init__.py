"""Circuit layer of the port: one gadget description, three compilers.

Port of `openzl_tpu.eclair` (eclair/src/lib.rs:27-84, SURVEY.md section 1):
gadgets are plain Python functions taking a ``com`` object, and the same
function runs under

  * :class:`NativeCompiler`: host Python-int field arithmetic (the oracle);
  * :class:`TorchCompiler`: batched limb arithmetic on the card (the
    compute path; the reference's `JaxCompiler`);
  * :class:`R1CSCompiler`: records R1CS constraints (the proof path).

Also the R1CS constraint system, the witness calculator and constraint
measurement (`measure`).
"""

from .compilers import FpVar, NativeCompiler, R1CSCompiler, TorchCompiler
from .measure import Instrument, measure_constraints
from .r1cs import R1CS, LinComb, SynthesisMode
from .witness import WitnessCalculator

__all__ = [
    "R1CS", "LinComb", "SynthesisMode", "FpVar", "NativeCompiler", "TorchCompiler", "R1CSCompiler",
    "Instrument", "measure_constraints", "WitnessCalculator",
]
