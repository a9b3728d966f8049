"""Circuit layer of the port: R1CS constraint system, R1CS compiler, witness
calculator (carried from `openzl_tpu.eclair`, whose package imports JAX)."""

from .compilers import FpVar, R1CSCompiler
from .r1cs import R1CS, LinComb, SynthesisMode
from .witness import WitnessCalculator

__all__ = ["R1CS", "LinComb", "SynthesisMode", "FpVar", "R1CSCompiler", "WitnessCalculator"]
