"""Security-driven Poseidon round-number search.

Implements the Poseidon-paper (eprint 2019/458, section 5) attack bounds and
the `from_arity` scan that minimizes S-box count subject to all bounds, with
the paper's recommended security margin (+2 full rounds, +7.5% partial
rounds) applied to every candidate.

Reference parity: openzl-crypto/src/poseidon/constants.rs:29-168 (search)
and 175-308 (attack bounds). The scan's control flow is mirrored exactly —
including its margin application inside the inner loop (the bumped
full-round count persists across the remaining partial-round candidates of
one outer pass) and its f32 arithmetic — because the known-values table
(constants.rs:318-358) is the conformance anchor and is sensitive to both.

Generalized over `modulus_bits` / `security_level` (the reference hardcodes
255 / 128); the known table applies at those defaults.

The port's own copy of `openzl_tpu/crypto/poseidon/constants.py` (host
Python, no JAX): `Poseidon.create` takes its round numbers from
`from_arity` for a width the reference pins none for.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

#: Known secure (arity -> partial_rounds) values at 128-bit security over
#: ~255-bit moduli, full_rounds = 8 throughout (constants.rs:318-358).
#: Kept as the test oracle for the search.
KNOWN_PARTIAL_ROUNDS = {
    1: 55, 2: 55, 3: 56, 4: 56, 5: 56, 6: 56, 7: 57, 8: 57, 9: 57, 10: 57,
    11: 57, 12: 57, 13: 57, 14: 57, 15: 59, 16: 59, 24: 59, 36: 60, 64: 61,
}

MODULUS_BITS = 255
SECURITY_LEVEL = 128


def _f32_ceil(x: float) -> int:
    """ceil over f32 arithmetic (the reference computes bounds in f32; the
    binary rounding of e.g. 1.075 differs between f32 and f64 and changes
    ceil results)."""
    return math.ceil(np.float32(x))


def statistical_full_rounds_bound(
    width: float, partial_rounds: float, n: float, m: float
) -> int:
    """Statistical attack (constants.rs:224-236): R_F >= 6 if the field is
    large enough relative to the security level, else 10."""
    del partial_rounds
    return 6 if m <= (n - 3.0) * (width + 1.0) else 10


def interpolation_full_rounds_bound(
    width: float, partial_rounds: float, n: float, m: float
) -> int:
    """Interpolation attack (constants.rs:239-250)."""
    del n
    return max(
        0,
        _f32_ceil(
            np.float32(0.43) * np.float32(m)
            + np.float32(math.log2(width))
            - np.float32(partial_rounds)
        ),
    )


def groebner_full_permutation_bound(
    width: float, partial_rounds: float, n: float, m: float
) -> int:
    """Groebner-basis attack on the full permutation (constants.rs:253-264)."""
    del width, m
    return max(0, _f32_ceil(np.float32(0.21) * np.float32(n) - np.float32(partial_rounds)))


def groebner_partial_sbox_bound(
    width: float, partial_rounds: float, n: float, m: float
) -> int:
    """Groebner-basis attack targeting the partial S-box
    (constants.rs:267-279)."""
    del m
    return max(
        0,
        _f32_ceil(
            (np.float32(0.14) * np.float32(n) - np.float32(1.0) - np.float32(partial_rounds))
            / (np.float32(width) - np.float32(1.0))
        ),
    )


_ALL_BOUNDS = (
    statistical_full_rounds_bound,
    interpolation_full_rounds_bound,
    groebner_full_permutation_bound,
    groebner_partial_sbox_bound,
)


def full_rounds_lower_bound(
    width: float, partial_rounds: float, n: float, m: float
) -> int:
    """Max over all known attacks (constants.rs:282-308)."""
    return max(b(width, partial_rounds, n, m) for b in _ALL_BOUNDS)


def are_secure(
    width: int,
    full_rounds: int,
    partial_rounds: int,
    modulus_bits: int = MODULUS_BITS,
    security_level: int = SECURITY_LEVEL,
) -> bool:
    """True if (width, R_F, R_P) resists all known attacks
    (constants.rs:157-166)."""
    return full_rounds >= full_rounds_lower_bound(
        float(width), float(partial_rounds), float(modulus_bits), float(security_level)
    )


@dataclasses.dataclass(frozen=True)
class Constants:
    width: int
    full_rounds: int
    partial_rounds: int


@functools.lru_cache(maxsize=None)
def from_arity(
    arity: int,
    modulus_bits: int = MODULUS_BITS,
    security_level: int = SECURITY_LEVEL,
) -> Constants:
    """Scan (R_F, R_P) minimizing S-box count subject to security, applying
    the paper's margin to each secure candidate (constants.rs:44-77).

    The inner-loop margin accumulation mirrors the reference exactly (the
    `rf += 2` bump persists across the rest of one outer pass) so the output
    matches its known-values table bit-for-bit.
    """
    width = arity + 1
    # are_secure(width, rf, rp) is rf >= this bound, which does not depend on rf
    lower = {
        rp: full_rounds_lower_bound(float(width), float(rp), float(modulus_bits), float(security_level))
        for rp in range(4, 200)
    }
    best_rf = 0
    best_rp = 0
    minimum_sbox_count = None
    for rf_outer in range(2, 1001, 2):
        rf = rf_outer
        for rp_cand in range(4, 200):
            if rf >= lower[rp_cand]:
                rf += 2
                rp = math.ceil(np.float32(1.075) * np.float32(rp_cand))
                sbox_count = width * rf + rp
                if minimum_sbox_count is None or sbox_count < minimum_sbox_count or (
                    sbox_count == minimum_sbox_count and rf < best_rf
                ):
                    best_rf = rf
                    best_rp = rp
                    minimum_sbox_count = sbox_count
    return Constants(width, best_rf, best_rp)


def strengthened(c: Constants) -> Constants:
    """+25% partial rounds, the preemptive hardening option
    (constants.rs:96-108)."""
    return Constants(c.width, c.full_rounds, math.ceil(c.partial_rounds * 1.25))
