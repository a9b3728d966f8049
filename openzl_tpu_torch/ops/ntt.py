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
    N = n1 x n2 applied recursively. Each level runs an n1-point transform
    over the columns in ONE launch of kernel K2 (all DIF stages in shared
    memory, with the level twiddle w_N^(j1 k2) fused as its post-multiply),
    un-reverses the rows with one gather, transposes, and recurses on the
    rows. Level sizes are balanced powers of two of at most K2's 64 points
    (2^17 = 64 x 64 x 32).

The 1/N scale outside the one launch and the coset scales are kernel K1
products.
"""

from __future__ import annotations

import functools

import numpy as np
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


def _bitrev(m: int) -> np.ndarray:
    log = m.bit_length() - 1
    idx = np.arange(m, dtype=np.int64)
    r = np.zeros(m, dtype=np.int64)
    for _ in range(log):
        r = (r << 1) | (idx & 1)
        idx >>= 1
    return r


def _root_powers(spec: FieldSpec, log_n: int, inverse: bool, dev) -> torch.Tensor:
    """(n_limbs, N) Montgomery limbs of w^j, j < N (w^-1 for the inverse)."""
    w = group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, spec.modulus)
    return limb.geom_series_mont(spec, 1, w, 1 << log_n, dev)


def _stage_twiddles(R: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(n_limbs, log2 m, m/2): entry j of stage s is w_m^(2^s j)."""
    log_m = m.bit_length() - 1
    j = torch.arange(m // 2, dtype=torch.int64, device=R.device)
    return torch.stack([R[:, ((n // m) << s) * j % n] for s in range(log_m)], dim=1)


def _build_node(R, n, levels, nt, c):
    """(stage_tw, br, level_tw, inner) for a length-nt transform carrying c
    lanes per element; level_tw rows are in K2's bit-reversed output order
    (level_tw[r, k2] = w_nt^(bitrev(r) k2)), tiled over the c lanes."""
    n1 = 1 << levels[0]
    br = torch.as_tensor(_bitrev(n1), device=R.device)
    stage_tw = _stage_twiddles(R, n, n1)
    if n1 == nt:
        return stage_tw, br, None, None
    n2 = nt // n1
    e = (n // nt) * br[:, None] * torch.arange(n2, device=R.device)[None, :] % n
    level_tw = R[:, e].unsqueeze(-1).expand(-1, -1, -1, c).reshape(R.shape[0], n1, n2 * c)
    return stage_tw, br, level_tw, _build_node(R, n, levels[1:], n2, n1 * c)


@functools.lru_cache(maxsize=32)
def _fourstep_plan(spec: FieldSpec, log_n: int, inverse: bool, batch: int, dev: torch.device):
    n = 1 << log_n
    R = _root_powers(spec, log_n, inverse, dev)
    node = _build_node(R, n, _levels(log_n), n, batch)
    n_inv = limb.tensor(limb.pack_mont(spec, pow(n, -1, spec.modulus)), dev) if inverse else None
    return node, n_inv


def _apply_node(spec, x, node):
    """x (n_limbs, nt, c): transform along axis 1, natural order out."""
    stage_tw, br, level_tw, inner = node
    n, nt, c = x.shape
    if inner is None:
        return ntt_kernel.small_ntt(spec, x.contiguous(), stage_tw)[:, br]
    n1 = 2 * stage_tw.shape[2]
    n2 = nt // n1
    y = ntt_kernel.small_ntt(spec, x.reshape(n, n1, n2 * c).contiguous(), stage_tw, level_tw)
    z = y[:, br]  # natural-order j1 rows
    w = z.reshape(n, n1, n2, c).permute(0, 2, 1, 3).reshape(n, n2, n1 * c)
    return _apply_node(spec, w, inner).reshape(n, nt, c)


def fourstep_transform(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The four-step route at any power-of-two size (n_limbs, N, *batch)."""
    n_l, N = x.shape[0], x.shape[1]
    if N & (N - 1):
        raise ValueError("domain size must be a power of two")
    if N == 1:
        return x
    batch = x.shape[2:]
    b = int(np.prod(batch)) if batch else 1
    node, n_inv = _fourstep_plan(spec, N.bit_length() - 1, inverse, b, x.device)
    out = _apply_node(spec, x.reshape(n_l, N, b), node)
    if inverse:
        out = ntt_kernel.mont_scale(spec, out.contiguous(), n_inv)
    return out.reshape(x.shape)


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


def _transform(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    N = x.shape[1]
    if N & (N - 1):
        raise ValueError("domain size must be a power of two")
    if N < _FOURSTEP_MIN:
        return _ntt_core(spec, x, inverse)
    return fourstep_transform(spec, x, inverse)


def ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Montgomery coefficients (n_limbs, N, *batch) -> evaluations on H."""
    return _transform(spec, coeffs, False)


def intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    return _transform(spec, evals, True)


@functools.lru_cache(maxsize=16)
def _coset_scales(spec: FieldSpec, n: int, inverse: bool, dev: torch.device) -> torch.Tensor:
    """(n_limbs, n) Montgomery limbs of g^i (g^-i for the inverse)."""
    g = GENERATORS[spec.name]
    if inverse:
        g = pow(g, -1, spec.modulus)
    return limb.geom_series_mont(spec, 1, g, n, dev)


def _coset_mul(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    sc = _coset_scales(spec, x.shape[1], inverse, x.device)
    return limb.mont_mul(spec, x, sc.reshape(tuple(sc.shape) + (1,) * (x.ndim - 2)))


def coset_ntt(spec: FieldSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate on the coset g H: scale coefficient i by g^i, then NTT."""
    return ntt(spec, _coset_mul(spec, coeffs, False))


def coset_intt(spec: FieldSpec, evals: torch.Tensor) -> torch.Tensor:
    return _coset_mul(spec, intt(spec, evals), True)
