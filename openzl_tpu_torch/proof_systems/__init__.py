"""Proof systems of the port."""

from .groth16 import BLS12_381, BN254, Groth16, PreparedCircuit, Proof, ProvingKey, VerifyingKey
from .kzg import KZG, KZGParams
from .ratio import HashToG2, RatioProof

__all__ = [
    "BLS12_381", "BN254", "Groth16", "HashToG2", "KZG", "KZGParams", "PreparedCircuit", "Proof", "ProvingKey",
    "RatioProof", "VerifyingKey",
]
