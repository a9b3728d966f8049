"""80-bit Grain LFSR for Poseidon parameter generation.

The port's own copy of `openzl_tpu/crypto/poseidon/lfsr.py` (host Python, no JAX).

Implements the bit stream from the Poseidon paper (GKRRS19, Appendix A), as
used by the reference for round-constant sampling
(reference: openzl-crypto/src/poseidon/lfsr.rs:14-102). Output must match the
sage-generated golden vectors bit-exactly (tests/vectors/poseidon_lfsr_*.json).

This is a host-side cold path (parameters are generated once per
configuration), so plain Python is the right tool — the TPU never sees it.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple


class GrainLFSR:
    """Feedback taps 62, 51, 38, 23, 13, 0 over an 80-bit circular state.

    The output discipline performs rejection filtering: a sampled bit is only
    emitted when the preceding update produced a 1 (pairs are consumed until
    the first bit of a pair is set).
    """

    SIZE = 80

    def __init__(self, seed_fields: Iterable[Tuple[int, int]]):
        self.state = [False] * self.SIZE
        self.head = 0
        for n_bits, value in seed_fields:
            for i in reversed(range(n_bits)):
                self._set_next(bool((value >> i) & 1))
        for _ in range(2 * self.SIZE):
            self._update()

    def _set_next(self, bit: bool) -> bool:
        self.state[self.head] = bit
        self.head = (self.head + 1) % self.SIZE
        return bit

    def _bit(self, index: int) -> bool:
        return self.state[(index + self.head) % self.SIZE]

    def _update(self) -> bool:
        return self._set_next(
            self._bit(62)
            ^ self._bit(51)
            ^ self._bit(38)
            ^ self._bit(23)
            ^ self._bit(13)
            ^ self._bit(0)
        )

    def __iter__(self) -> Iterator[bool]:
        return self

    def __next__(self) -> bool:
        bit = self._update()
        while not bit:
            self._update()
            bit = self._update()
        return self._update()
