"""Big-field arithmetic over 16-bit limbs in torch tensors.

Port of `openzl_tpu/fields/limb.py`. Elements are little-endian 16-bit limb
vectors with the limb axis first, shape ``(n_limbs, *batch)``, stored as
``torch.int32`` (values below 2^16, so the bits equal the reference's
uint32 limbs and ``np.asarray(jax_out) == port_out.cpu().numpy()`` is the
comparison). Work is computed in int64 internally: torch has no unsigned
32-bit arithmetic on the CPU.

Every function takes the device of its inputs. The Montgomery product and
the exponentiation go through kernel K1 (`openzl_tpu_torch.ops.ntt_kernel`
`mont_mul`, `mont_pow`): on a CUDA tensor they launch the CUDA kernel, on a
CPU tensor they run the plain torch version. Additions and subtractions
are plain torch on either device; their carry chains are resolved with a
carry-lookahead over limb bit masks rather than a limb-by-limb loop, so one
modular add is a few dozen elementwise ops whatever the limb count.

Montgomery form: ``x R mod p`` with ``R = 2^(16 n_limbs)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .spec import LIMB_BITS, LIMB_MASK, FieldSpec

DTYPE = torch.int32
_MASK = LIMB_MASK


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------


def _ints_to_limbs(values: np.ndarray, n_limbs: int) -> np.ndarray:
    """Object array of ints in [0, 2^(16 n)) -> (n_limbs, *shape) uint32."""
    flat = values.reshape(-1)
    width = 2 * n_limbs
    buf = b"".join(int(v).to_bytes(width, "little") for v in flat)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(flat.shape[0], n_limbs)
    return np.ascontiguousarray(u16.T).astype(np.uint32).reshape((n_limbs,) + values.shape)


def _limbs_to_ints(limbs: np.ndarray) -> np.ndarray:
    """(n_limbs, *shape) limbs -> object array of ints."""
    limbs = np.asarray(limbs).astype(np.uint16)
    shape = limbs.shape[1:]
    flat = np.ascontiguousarray(limbs.reshape(limbs.shape[0], -1).T)
    width = 2 * limbs.shape[0]
    raw = flat.astype("<u2").tobytes()
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = int.from_bytes(raw[i * width : (i + 1) * width], "little")
    if shape == ():
        return np.array(out[0], dtype=object)
    return out.reshape(shape)


def _native():
    from .. import native

    return native if native.available() else None


def pack(spec: FieldSpec, values) -> np.ndarray:
    """Python ints -> canonical (n_limbs, *batch) uint32 limbs (host)."""
    arr = np.asarray(values, dtype=object)
    reduced = np.vectorize(lambda v: int(v) % spec.modulus, otypes=[object])(arr)
    return _ints_to_limbs(reduced, spec.n_limbs)


def unpack(spec: FieldSpec, limbs) -> np.ndarray:
    """(n_limbs, *batch) limbs (numpy or tensor) -> object array of ints."""
    return _limbs_to_ints(_host(limbs))


def pack_mont(spec: FieldSpec, values) -> np.ndarray:
    """Python ints -> Montgomery-form limbs (host), through the native
    converter of `openzl_tpu_torch.native` when it is built."""
    arr = np.asarray(values, dtype=object)
    nat = _native()
    if nat is not None and arr.size:
        reduced = np.vectorize(lambda v: int(v) % spec.modulus, otypes=[object])(arr)
        out = nat.to_mont_limbs(spec, reduced)
        if out is not None:
            return out
    p, r = spec.modulus, spec.R
    mont = np.vectorize(lambda v: int(v) % p * r % p, otypes=[object])(arr)
    return _ints_to_limbs(mont, spec.n_limbs)


def unpack_mont(spec: FieldSpec, limbs) -> np.ndarray:
    """Montgomery-form limbs -> object array of canonical ints."""
    vals = unpack(spec, limbs)
    rinv = pow(spec.R, -1, spec.modulus)
    p = spec.modulus
    return np.vectorize(lambda v: v * rinv % p, otypes=[object])(vals)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor(limbs, device=None) -> torch.Tensor:
    """Host limb array -> int32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(limbs, dtype=np.int32), device=device)


def zeros(spec: FieldSpec, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((spec.n_limbs,) + tuple(batch_shape), dtype=DTYPE, device=device)


@functools.lru_cache(maxsize=None)
def _limb_const(spec: FieldSpec, which: str, device: torch.device) -> torch.Tensor:
    v = {"p": spec.p_limbs, "r": spec.r_limbs, "r2": spec.r2_limbs}[which]
    return torch.as_tensor(v.astype(np.int64), device=device)


def const(spec: FieldSpec, which: str, ndim: int, device) -> torch.Tensor:
    """p, R or R^2 as int64 limbs shaped to broadcast over ndim-1 batch axes."""
    v = _limb_const(spec, which, torch.device(device))
    return v.reshape(tuple(v.shape) + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# carry machinery (int64 limbs)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shifts(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _lookahead(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry into each limb from generate/propagate flags (0/1 int64,
    limb axis first): packs the flags into per-element bit masks G and P,
    then C = ((G << 1) + P) ^ P has bit i set iff a carry enters limb i.
    Bit n of C is the carry out. Returns (n + 1, *batch) 0/1 int64."""
    n = gen.shape[0]
    sh = _shifts(n, gen.device).reshape((n,) + (1,) * (gen.ndim - 1))
    G = (gen << sh).sum(0)
    P = (prop << sh).sum(0)
    C = ((G << 1) + P) ^ P
    sh1 = _shifts(n + 1, gen.device).reshape((n + 1,) + (1,) * (gen.ndim - 1))
    return (C.unsqueeze(0) >> sh1) & 1


def _add_raw(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a + b of normalized limbs -> (limbs, carry_out)."""
    s = a + b
    low = s & _MASK
    c = _lookahead(s >> LIMB_BITS, (low == _MASK).long())
    return (low + c[:-1]) & _MASK, c[-1]


def _sub_raw(a: torch.Tensor, b: torch.Tensor):
    """Limbwise a - b mod 2^(16n) -> (limbs, borrow_out)."""
    d = a - b
    c = _lookahead((d < 0).long(), (d == 0).long())
    return (d - c[:-1]) & _MASK, c[-1]


def _rounds(bound_bits: int) -> int:
    """Carry rounds that bring columns below 2^bound_bits to at most 2^16."""
    m, r = (1 << bound_bits) - 1, 0
    while m > 1 << LIMB_BITS:
        m = _MASK + (m >> LIMB_BITS)
        r += 1
    return r


def normalize(cols: torch.Tensor, n_out: int, bound_bits: int = 0) -> torch.Tensor:
    """Lazy non-negative int64 columns -> `n_out` normalized limbs (value
    mod 2^(16 n_out)). Rounds of limb-local carry moves shrink every
    column to at most 2^16 (so a limb that generates a carry has a zero low
    half), then one lookahead resolves the remaining 0/1 ripple. With
    `bound_bits` (every column below 2^bound_bits) the round count is fixed
    in advance instead of tested after each round."""
    x = cols
    if x.shape[0] < n_out:
        pad = torch.zeros((n_out - x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad])
    x = x[:n_out]

    def carry_round(x):
        hi = x >> LIMB_BITS
        x = x & _MASK
        x[1:] += hi[:-1]
        return x

    if bound_bits:
        for _ in range(_rounds(bound_bits)):
            x = carry_round(x)
    else:
        while bool((x > (1 << LIMB_BITS)).any()):
            x = carry_round(x)
    low = x & _MASK
    c = _lookahead(x >> LIMB_BITS, (low == _MASK).long())
    return (low + c[:-1]) & _MASK


def _cond_sub_p(spec: FieldSpec, x: torch.Tensor, carry=None) -> torch.Tensor:
    """x in [0, 2p) -> [0, p); `carry` is a bit above the top limb (2p may
    exceed 2^(16 n), as for P-256)."""
    d, borrow = _sub_raw(x, const(spec, "p", x.ndim, x.device))
    keep = borrow.bool() if carry is None else borrow.bool() & (carry == 0)
    return torch.where(keep.unsqueeze(0), x, d)


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


# ---------------------------------------------------------------------------
# modular ring ops (canonical inputs in [0, p), broadcasting batch)
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, carry = _add_raw(_i64(a), _i64(b))
    return _cond_sub_p(spec, s, carry).to(DTYPE)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _sub_raw(_i64(a), _i64(b))
    wrapped, _ = _add_raw(d, const(spec, "p", d.ndim, d.device))
    return torch.where(borrow.bool().unsqueeze(0), wrapped, d).to(DTYPE)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    a64 = _i64(a)
    d, _ = _sub_raw(const(spec, "p", a.ndim, a.device), a64)
    return torch.where(is_zero(a).unsqueeze(0), a64, d).to(DTYPE)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask over the batch (shape a.shape[1:])."""
    return (a == 0).all(0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise `mask ? a : b`; mask has the batch shape (no limb axis)."""
    return torch.where(mask.unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Montgomery multiplication (kernel K1)
# ---------------------------------------------------------------------------


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b R^-1 mod p, broadcasting over the batch axes (K1)."""
    from ..ops import ntt_kernel

    return ntt_kernel.mont_mul_bcast(spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def mont_pow5(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """x^5 (the Poseidon S-box) in Montgomery form: three K1 products."""
    a2 = mont_mul(spec, a, a)
    a4 = mont_mul(spec, a2, a2)
    return mont_mul(spec, a4, a)


def mont_pow(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent for a Python-int exponent, MSB-first square and multiply:
    one launch of K1's exponentiation on a CUDA tensor, the plain chain of
    products on a CPU tensor (`ntt_kernel.mont_pow`)."""
    from ..ops import ntt_kernel

    return ntt_kernel.mont_pow(spec, a, exponent)


def geom_series_mont(spec: FieldSpec, start: int, base: int, count: int, device=None) -> torch.Tensor:
    """(n_limbs, count) Montgomery limbs of start base^i, i < count, built on
    `device`: the array doubles with one product per step."""
    arr, step = (tensor(pack_mont(spec, v), device).reshape(spec.n_limbs, 1) for v in (start, base))
    while arr.shape[1] < count:
        arr = torch.cat([arr, mont_mul(spec, arr, step)], dim=1)
        step = mont_mul(spec, step, step)
    return arr[:, :count].contiguous()


def mont_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by Fermat, a^(p-2); maps 0 to 0."""
    return mont_pow(spec, a, spec.modulus - 2)


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, x, const(spec, "r2", x.ndim, x.device).to(DTYPE))


def from_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    one = torch.zeros((spec.n_limbs,) + (1,) * (x.ndim - 1), dtype=DTYPE, device=x.device)
    one[0] = 1
    return mont_mul(spec, x, one)
