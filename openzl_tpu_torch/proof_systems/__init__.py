"""Proof systems of the port."""

from .groth16 import BLS12_381, BN254, Groth16, PreparedCircuit, Proof, ProvingKey, VerifyingKey

__all__ = ["BLS12_381", "BN254", "Groth16", "PreparedCircuit", "Proof", "ProvingKey", "VerifyingKey"]
