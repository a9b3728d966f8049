"""Poseidon2 permutation (Grassi-Khovratovich-Schofnegger 2023) over 16-bit
limb tensors.

Port of `openzl_tpu/crypto/poseidon2/__init__.py`. Poseidon2 replaces both
linear layers of classic Poseidon with matrices of tiny integers, so the
only Montgomery products of the permutation are the S-boxes: 240 for width
3 against 804 for classic Poseidon. `permute` runs kernel K7 on a CUDA
tensor and its plain torch version on a CPU tensor
(`openzl_tpu_torch.ops.poseidon2_kernel`).

Structure (paper section 3): an initial external-matrix layer, then
external (full) rounds (add per-element constants, S-box all, M_E) and
internal (partial) rounds (add a constant to element 0, S-box element 0,
M_I). Matrices (paper sections 5.2-5.3): t=2 M_E = circ(2,1); t=3
M_E = circ(2,1,1); t=4k M_E = circ(2 M4, M4, ...); M_I = ones + diag(mu)
with the smallest small-integer mu that passes the invariant-subspace
check. The matrix search is host Python, copied from the reference. Round
constants come from the Grain LFSR with the classic Poseidon seeding;
external rounds take `width` constants each, internal rounds one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ...fields import limb
from ...fields.spec import FieldSpec
from ..poseidon import param_gen
from ..poseidon.matrix import matmul as _matmul
from ..poseidon.permutation import BatchedPermutation

__all__ = [
    "Poseidon2",
    "external_matrix",
    "internal_matrix",
]


_M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]

#: Poseidon2 round numbers at 128-bit security, alpha=5, ~254-bit moduli
#: (paper Table 1: R_F=8 throughout; R_P=56 for t in {2,3,4}, 57 for t in
#: {8,12,16}). Validated against crypto/poseidon/constants.py's search with
#: the paper's margin in tests/test_poseidon2.py.
ROUND_NUMBERS_128 = {2: (8, 56), 3: (8, 56), 4: (8, 56), 8: (8, 57), 12: (8, 57)}


def external_matrix(width: int) -> List[List[int]]:
    """M_E as small integers (paper §5.2)."""
    if width == 2:
        return [[2, 1], [1, 2]]
    if width == 3:
        return [[2, 1, 1], [1, 2, 1], [1, 1, 2]]
    assert width % 4 == 0, "Poseidon2 supports t in {2, 3} or multiples of 4"
    k = width // 4
    out = [[0] * width for _ in range(width)]
    for bi in range(k):
        for bj in range(k):
            scale = 2 if bi == bj else 1
            for r in range(4):
                for c in range(4):
                    out[4 * bi + r][4 * bj + c] = scale * _M4[r][c]
    return out


def _det(p: int, m: List[List[int]]) -> int:
    """Determinant mod p by Gaussian elimination with row swaps."""
    n = len(m)
    a = [list(row) for row in m]
    det = 1
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r][col] % p), None)
        if pivot is None:
            return 0
        if pivot != col:
            a[col], a[pivot] = a[pivot], a[col]
            det = -det
        det = det * a[col][col] % p
        inv = pow(a[col][col], -1, p)
        for r in range(col + 1, n):
            f = a[r][col] * inv % p
            if f:
                a[r] = [(x - f * y) % p for x, y in zip(a[r], a[col])]
    return det % p


def _char_poly(p: int, m: List[List[int]]) -> List[int]:
    """Characteristic polynomial det(xI - m) over F_p, coefficients
    low-to-high (monic), by evaluation at t+1 points + Lagrange
    interpolation — robust and cheap at the widths used here."""
    t = len(m)
    xs = list(range(t + 1))
    ys = []
    for x in xs:
        shifted = [[(x * (i == j) - m[i][j]) % p for j in range(t)] for i in range(t)]
        ys.append(_det(p, shifted))
    # Lagrange interpolation on the small integer points
    coeffs = [0] * (t + 1)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        # numerator polynomial prod_{j!=i} (x - xj), denominator scalar
        num = [1]
        denom = 1
        for j, xj in enumerate(xs):
            if j == i:
                continue
            num = [
                ((num[k - 1] if k else 0) - xj * (num[k] if k < len(num) else 0)) % p
                for k in range(len(num) + 1)
            ]
            denom = denom * (xi - xj) % p
        scale = yi * pow(denom, -1, p) % p
        for k in range(len(num)):
            coeffs[k] = (coeffs[k] + scale * num[k]) % p
    return coeffs


def _poly_mulmod(p: int, a: List[int], b: List[int], f: List[int]) -> List[int]:
    """(a*b) mod f over F_p; f monic degree t, a,b degree < t."""
    t = len(f) - 1
    out = [0] * (2 * t - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    for d in range(len(out) - 1, t - 1, -1):
        c = out[d]
        if c:
            out[d] = 0
            for j in range(t):
                out[d - t + j] = (out[d - t + j] - c * f[j]) % p
    return out[:t]


def _xp_pow(p: int, f: List[int]) -> List[int]:
    """x^p mod f by square-and-multiply on the binary expansion of p."""
    t = len(f) - 1
    base = [0, 1] + [0] * (t - 2)
    acc = [1] + [0] * (t - 1)
    e = p
    while e:
        if e & 1:
            acc = _poly_mulmod(p, acc, base, f)
        base = _poly_mulmod(p, base, base, f)
        e >>= 1
    return acc


def _frobenius_powers(p: int, f: List[int]) -> List[List[int]]:
    """[x^(p^k) mod f for k = 0 .. t]. g -> g^p mod f is linear over F_p
    (g^p = sum g_i x^(i p), as g_i^p = g_i), so after one exponentiation,
    x^p, each further power is the product of g with the matrix of rows
    x^(i p) mod f, i < t: t^2 products where the reference's `_xp_pow`
    exponentiates by p again. The powers, reduced mod f, are the same."""
    t = len(f) - 1
    rows = [[1] + [0] * (t - 1), _xp_pow(p, f)]
    while len(rows) < t:
        rows.append(_poly_mulmod(p, rows[-1], rows[1], f))
    powers = [[0, 1] + [0] * (t - 2)]
    for _ in range(t):
        out = [0] * t
        for gi, row in zip(powers[-1], rows):
            if gi:
                out = [o + gi * r for o, r in zip(out, row)]
        powers.append([o % p for o in out])
    return powers


def _poly_gcd_deg(p: int, a: List[int], b: List[int]) -> int:
    """Degree of gcd(a, b) over F_p (only the degree is needed)."""

    def deg(x):
        for i in range(len(x) - 1, -1, -1):
            if x[i] % p:
                return i
        return -1

    a, b = list(a), list(b)
    while deg(b) >= 0:
        da, db = deg(a), deg(b)
        if da < db:
            a, b = b, a
            continue
        inv = pow(b[deg(b)], -1, p)
        shift = da - db
        f = a[da] * inv % p
        for i in range(db + 1):
            a[i + shift] = (a[i + shift] - f * b[i]) % p
        if deg(a) < deg(b):
            a, b = b, a
    return deg(a)


def _is_irreducible(p: int, f: List[int]) -> bool:
    """Rabin's test for monic f over F_p."""
    t = len(f) - 1
    if t == 1:
        return True
    powers = _frobenius_powers(p, f)
    x = powers[0]
    diff = [(a - b) % p for a, b in zip(powers[t], x)]
    if any(diff):
        return False
    primes = {q for q in range(2, t + 1) if t % q == 0 and all(q % r for r in range(2, q))}
    for q in primes:
        diff = [(a - b) % p for a, b in zip(powers[t // q], x)]
        diff = diff + [0]  # degree < t; gcd with f
        if _poly_gcd_deg(p, f, diff) > 0:
            return False
    return True


def _internal_secure(p: int, m: List[List[int]], width: int) -> bool:
    """Invariant-subspace check (paper §5.3 / instance-generation scripts):
    the characteristic polynomials of M_I^k for k = 1..width must be
    irreducible over F_p."""
    mk = m
    for _ in range(width):
        if not _is_irreducible(p, _char_poly(p, mk)):
            return False
        mk = _matmul(p, mk, m)
    return True


@functools.lru_cache(maxsize=None)
def internal_matrix(p: int, width: int) -> tuple:
    """M_I = ones + diag(mu) with the smallest secure small-integer diagonal.

    For t in {2, 3} the paper's fixed matrices are tried first; all
    candidates pass through the invariant-subspace check for the concrete
    field, and the search walks small diagonals until one passes. Returns
    the diagonal (mu_i + 1 appears on the diagonal of the dense matrix).
    """
    # Distinct small diagonals: repeated mu_i always yield the eigenvector
    # e_i - e_j (sum 0, D v = mu v), i.e. a rational invariant subspace.
    # Candidates must also differ by more than a uniform shift — adding b to
    # every entry maps M to M + b*I, which only translates the
    # characteristic polynomial and preserves its factorization pattern.
    import itertools

    candidates = itertools.combinations(range(1, 48), width)
    for diag in candidates:
        m = [[1] * width for _ in range(width)]
        for i in range(width):
            m[i][i] = 1 + diag[i]
        if _internal_secure(p, m, width):
            return tuple(diag)
    raise ValueError(f"no secure small internal diagonal found for t={width}")


# ---------------------------------------------------------------------------
# the batched instance
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Poseidon2(BatchedPermutation):
    """One Poseidon2 configuration: host Montgomery limb arrays (uint32, the
    reference's shapes), the internal diagonal, and the device that numpy
    inputs go to. `permute` and `hash` come from `BatchedPermutation`."""

    spec: FieldSpec
    width: int
    full_rounds: int
    partial_rounds: int
    ext_keys: np.ndarray  # (R_F, n_limbs, width) Montgomery
    int_keys: np.ndarray  # (R_P, n_limbs) Montgomery
    diag: tuple  # internal diagonal mu (small ints)
    device: torch.device = torch.device("cuda")
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def create(cls, spec: FieldSpec, arity: int, full_rounds: int | None = None,
               partial_rounds: int | None = None, device="cuda") -> "Poseidon2":
        width = arity + 1
        if full_rounds is None or partial_rounds is None:
            full_rounds, partial_rounds = ROUND_NUMBERS_128[width]
        spec = FieldSpec(spec.name, spec.modulus)
        ext, ints, diag = _host_params(spec, width, full_rounds, partial_rounds)
        return cls(spec, width, full_rounds, partial_rounds, ext, ints, diag, torch.device(device))

    @classmethod
    def from_reference(cls, perm, device="cuda") -> "Poseidon2":
        """From a reference (JAX package) `Poseidon2`: its key arrays,
        diagonal, field name and modulus, and round numbers."""
        return cls(
            FieldSpec(perm.spec.name, perm.spec.modulus), int(perm.width), int(perm.full_rounds),
            int(perm.partial_rounds), np.asarray(perm.ext_keys, np.uint32),
            np.asarray(perm.int_keys, np.uint32), tuple(int(d) for d in perm.diag), torch.device(device),
        )

    def _permute_flat(self, state: torch.Tensor) -> torch.Tensor:
        from ...ops import poseidon2_kernel

        return poseidon2_kernel.permute(self, state)


@functools.lru_cache(maxsize=None)
def _host_params(spec: FieldSpec, width: int, full_rounds: int, partial_rounds: int):
    """(ext keys (R_F, n, w), int keys (R_P, n), diagonal), host, once per
    configuration."""
    lfsr = param_gen.generate_lfsr(spec.bits, width, full_rounds, partial_rounds)
    n_ext = full_rounds * width
    flat = [param_gen.sample_field_element(lfsr, spec) for _ in range(n_ext + partial_rounds)]
    ext = [flat[r * width : (r + 1) * width] for r in range(full_rounds)]
    ext_arr = np.moveaxis(limb.pack_mont(spec, np.array(ext, dtype=object)), 0, 1)
    int_arr = np.moveaxis(limb.pack_mont(spec, np.array(flat[n_ext:], dtype=object)), 0, 1)
    return ext_arr, int_arr, internal_matrix(spec.modulus, width)
