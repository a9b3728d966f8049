"""Radix-2 NTT / iNTT over prime scalar fields, bit-exact with ark-poly.

Port of `openzl_tpu/ops/ntt.py` (`ntt`, `intt`, `coset_ntt`, `coset_intt`,
`fourstep_transform`). Conventions (arkworks v0.3): the domain of size
N = 2^k uses group_gen = two_adic_root^(2^(TWO_ADICITY - k)); `ntt`
evaluates at w^0 .. w^(N-1) in natural order; `intt` scales by 1/N; the
coset is g H with g the field's multiplicative generator.

Two routes, split at the reference's `_FOURSTEP_MIN` = 2^13:

  * below it, the per-stage route `_ntt_core`: ONE launch of kernel K8
    runs every radix-2 stage of the transform on the column held in shared
    memory (split over a thread-block cluster at batch 1), with the
    bit-reversal gather and the inverse's 1/N scale in its store, over the
    16-limb fields it is built for; its plain version, the CPU route, and
    on the card the route of other fields, is log2(N) constant-geometry
    (Pease) decimation-in-frequency stages, each a K8 `stage` launch on
    the card (pairs x[k], x[k + N/2], writes lo to slot 2k and hi to slot
    2k + 1, twiddle w^(k & ~(2^s - 1)) read from the root table by index),
    then one bit-reversal gather;
  * from it on, `fourstep_transform`: a four-step (Bailey) decomposition
    N = n1 x n2 applied recursively, ONE launch of kernel K2 a level
    (`ntt_kernel.fourstep_level`): the level's n1-point DFT of every
    column, the level twiddle w_nt^(k1 j2), the bit reversal and the
    transpose into the next level's layout, read and written once. Level
    sizes are balanced powers of two of at most `ntt_kernel.M_MAX` = 64
    points (2^17 = 64 x 64 x 32: three launches). The forward coset's
    scales g^i ride in the first level's load, the inverse's 1/N (and the
    coset inverse's g^-i) in the last level's store.

Below 2^13 the 1/N scale outside the one launch (other fields) and the
coset scales are kernel K1 products.
"""

from __future__ import annotations

import functools

import torch

from ..fields.spec import FieldSpec
from ..fields import limb
from . import ntt_kernel

#: multiplicative generators of the arkworks v0.3 Fr configs (and the
#: BabyBear generator used by the kernel tests), as in the reference
GENERATORS = {
    "bn254_fr": 5,
    "bls12_381_fr": 7,
    "bls12_377_fr": 22,
    "babybear": 31,
    "bls12_377_fq": 5,
}


def two_adicity(spec: FieldSpec) -> int:
    n = spec.modulus - 1
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s


def group_gen(spec: FieldSpec, log_n: int) -> int:
    """Primitive 2^log_n-th root of unity, arkworks derivation."""
    adicity = two_adicity(spec)
    if log_n > adicity:
        raise ValueError(f"domain 2^{log_n} too large for {spec.name}")
    root = pow(GENERATORS[spec.name], (spec.modulus - 1) >> adicity, spec.modulus)
    return pow(root, 1 << (adicity - log_n), spec.modulus)


def _levels(log_n: int) -> list:
    """Balanced split of log_n into level sizes of at most log2(M_MAX)."""
    cap = ntt_kernel.M_MAX.bit_length() - 1
    k = -(-log_n // cap)
    base, extra = divmod(log_n, k)
    return [base + 1] * extra + [base] * (k - extra)


_bitrev = ntt_kernel.bitrev


def _root_powers(spec: FieldSpec, log_n: int, inverse: bool, dev) -> torch.Tensor:
    """(n_limbs, N) Montgomery limbs of w^j, j < N (w^-1 for the inverse)."""
    w = group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, spec.modulus)
    return limb.geom_series_mont(spec, 1, w, 1 << log_n, dev)


@functools.lru_cache(maxsize=32)
def _fourstep_plan(spec: FieldSpec, log_n: int, inverse: bool, levels: tuple, dev: torch.device):
    """((log2 M, nt) of each level of the split `levels`, the word-packed
    root table (N, NW) of w^j (w^-1 for the inverse), and for the inverse
    1/N as one word-packed element)."""
    n = 1 << log_n
    roots = ntt_kernel.to_words(spec, _root_powers(spec, log_n, inverse, dev))
    shape, nt = [], n
    for lm in levels:
        shape.append((lm, nt))
        nt >>= lm
    n_inv = None
    if inverse:
        n_inv = ntt_kernel.to_words(spec, limb.tensor(limb.pack_mont(spec, pow(n, -1, spec.modulus)), dev))
    return tuple(shape), roots, n_inv


def _fourstep(spec: FieldSpec, x: torch.Tensor, inverse: bool, coset: bool) -> torch.Tensor:
    """The four-step route along axis 1 of x (n_limbs, N, *batch): one
    `ntt_kernel.fourstep_level` (a K2 launch on the card) a level, the
    first level's load times g^i for the forward coset transform, the last
    level's store times 1/N (the inverse) or 1/N g^-i (the coset inverse)."""
    n_l, N = x.shape[0], x.shape[1]
    if N & (N - 1):
        raise ValueError("domain size must be a power of two")
    if N == 1:
        return x
    log_n = N.bit_length() - 1
    shape, roots, n_inv = _fourstep_plan(spec, log_n, inverse, tuple(_levels(log_n)), x.device)
    scales = _coset_scales(spec, N, inverse, x.device, words=True) if coset else None
    y = x.reshape(n_l, N, -1).contiguous()
    for k, (lm, nt) in enumerate(shape):
        pre = scales if k == 0 and coset and not inverse else None
        post = None
        if k == len(shape) - 1 and inverse:
            post = scales if coset else n_inv
        y = ntt_kernel.fourstep_level(spec, y, roots, lm, nt, pre, post)
    return y.reshape(x.shape)


def fourstep_transform(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The four-step route at any power-of-two size (n_limbs, N, *batch):
    balanced levels of at most `ntt_kernel.M_MAX` points (2^17 = 64 x 64 x
    32), one K2 launch a level on the card."""
    return _fourstep(spec, x, inverse, False)


#: below this size the per-stage route runs (the reference's threshold)
_FOURSTEP_MIN = 1 << 13


@functools.lru_cache(maxsize=32)
def _plan(spec: FieldSpec, log_n: int, inverse: bool, dev: torch.device):
    """(bit-reversal index, root table W[j] = w^j for j < N/2 as (n_limbs,
    N/2) Montgomery limbs, n^-1) of the per-stage route."""
    n = 1 << log_n
    rev = torch.as_tensor(_bitrev(n), device=dev)
    table = _root_powers(spec, log_n, inverse, dev)[:, : n // 2].contiguous()
    n_inv = limb.tensor(limb.pack_mont(spec, pow(n, -1, spec.modulus)), dev)
    return rev, table, n_inv


def _ntt_core(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Per-stage route: the whole transform in one K8 launch on the card
    (every stage in shared memory, the bit reversal and the 1/N scale in
    its store); on the CPU its plain version, log2(N) Pease DIF stages, one
    gather into natural order and the 1/N scale for the inverse. A field
    the one launch is not built for (BabyBear, BLS12-377 Fq) takes those
    stages on the card too: one K8 `stage` launch each, the gather, and
    for the inverse a K1 scale."""
    N = x.shape[1]
    if N == 1:
        return x
    rev, table, n_inv = _plan(spec, N.bit_length() - 1, inverse, x.device)
    if spec.n_limbs == ntt_kernel.TRANSFORM_LIMBS:
        return ntt_kernel.transform(spec, x, table, rev, n_inv, inverse)
    for s in range(N.bit_length() - 1):
        x = ntt_kernel.stage(spec, x, table, s)
    x = x[:, rev]
    if inverse:
        x = ntt_kernel.mont_scale(spec, x.contiguous(), n_inv)
    return x


def _transform(spec: FieldSpec, x: torch.Tensor, inverse: bool, coset: bool = False) -> torch.Tensor:
    N = x.shape[1]
    if N & (N - 1):
        raise ValueError("domain size must be a power of two")
    if N >= _FOURSTEP_MIN:
        return _fourstep(spec, x, inverse, coset)
    if coset and not inverse:
        x = _coset_mul(spec, x, False)
    x = _ntt_core(spec, x, inverse)
    return _coset_mul(spec, x, True) if coset and inverse else x


def ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Montgomery coefficients (n_limbs, N, *batch) -> evaluations on H."""
    return _transform(spec, coeffs, False)


def intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    return _transform(spec, evals, True)


@functools.lru_cache(maxsize=16)
def _coset_scales(spec: FieldSpec, n: int, inverse: bool, dev: torch.device, words: bool = False) -> torch.Tensor:
    """Montgomery g^i (g^-i for the inverse), i < n: (n_limbs, n) limbs, the
    per-stage route's K1 scales; with `words`, the four-step route's
    word-packed (n, NW) level scales, the inverse's times 1/N (its last
    level's store takes both)."""
    g, p = GENERATORS[spec.name], spec.modulus
    if inverse:
        g = pow(g, -1, p)
    series = limb.geom_series_mont(spec, pow(n, -1, p) if inverse and words else 1, g, n, dev)
    return ntt_kernel.to_words(spec, series) if words else series


def _coset_mul(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    sc = _coset_scales(spec, x.shape[1], inverse, x.device)
    return limb.mont_mul(spec, x, sc.reshape(tuple(sc.shape) + (1,) * (x.ndim - 2)))


def coset_ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate on the coset g H: scale coefficient i by g^i, then NTT (on
    the four-step route, inside its first level)."""
    return _transform(spec, coeffs, False, True)


def coset_intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    """iNTT, then scale coefficient i by g^-i (on the four-step route,
    inside its last level, with the 1/N)."""
    return _transform(spec, evals, True, True)
