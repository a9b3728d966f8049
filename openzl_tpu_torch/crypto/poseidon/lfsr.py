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
    """Feedback taps 62, 51, 38, 23, 13, 0 over an 80-bit state.

    The state is an int whose bit i is the register's bit i (bit 0 the
    oldest): an update appends the XOR of the tapped bits. The nearest tap
    is 18 bits back, so 18 updates are one step of shifts and XORs of the
    whole state; `_update` hands their bits out one at a time.

    The output discipline performs rejection filtering: a sampled bit is only
    emitted when the preceding update produced a 1 (pairs are consumed until
    the first bit of a pair is set).
    """

    SIZE = 80
    STEP = 18

    def __init__(self, seed_fields: Iterable[Tuple[int, int]]):
        state, n = 0, 0
        for n_bits, value in seed_fields:
            for i in reversed(range(n_bits)):
                state |= ((value >> i) & 1) << n
                n += 1
        if n < self.SIZE:  # the register's bits before the seed are zeros
            state <<= self.SIZE - n
        self.state = state >> max(0, n - self.SIZE)
        self._buf = 0
        self._left = 0
        for _ in range(2 * self.SIZE):
            self._update()

    def _update(self) -> int:
        if not self._left:
            s = self.state
            new = (s ^ (s >> 13) ^ (s >> 23) ^ (s >> 38) ^ (s >> 51) ^ (s >> 62)) & ((1 << self.STEP) - 1)
            self.state = (s >> self.STEP) | (new << (self.SIZE - self.STEP))
            self._buf, self._left = new, self.STEP
        bit = self._buf & 1
        self._buf >>= 1
        self._left -= 1
        return bit

    def __iter__(self) -> Iterator[bool]:
        return self

    def __next__(self) -> bool:
        bit = self._update()
        while not bit:
            self._update()
            bit = self._update()
        return bool(self._update())
