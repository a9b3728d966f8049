"""Kernels K1 (elementwise Montgomery product, and the Montgomery
exponentiation through the same field code), K2 (batched small NTT) and
K8 (radix-2 butterflies: a whole transform below 2^13 in one launch, and
one stage).

Port of `openzl_tpu/ops/ntt_kernel.py`. The CUDA sources are
`openzl_tpu_torch/csrc/ntt_kernel.cu` (design notes there); this module
holds their wrappers, launch counters and plain torch versions.

Dispatch: a CUDA tensor launches the kernel (a failed build or launch
raises), a CPU tensor runs the plain version. Nothing moves between devices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..fields import limb
from ..utils import build

K1 = build.KernelInfo(
    name="mont_mul",
    source="openzl_tpu_torch/csrc/ntt_kernel.cu",
    replaces="openzl_tpu/ops/ntt_kernel.py:56",
)
K1P = build.KernelInfo(
    name="mont_pow",
    source="openzl_tpu_torch/csrc/ntt_kernel.cu",
    replaces="openzl_tpu/fields/limb.py:308",
)
K2 = build.KernelInfo(
    name="small_ntt",
    source="openzl_tpu_torch/csrc/ntt_kernel.cu",
    replaces="openzl_tpu/ops/ntt_kernel.py:160",
)
K8 = build.KernelInfo(
    name="butterfly",
    source="openzl_tpu_torch/csrc/ntt_kernel.cu",
    replaces="openzl_tpu/ops/ntt_kernel.py:44",
)

#: largest transform one K2 launch takes (the four-step NTT splits
#: longer ones); 64 points keep a block's tile and twiddles in 48 KB of
#: shared memory at 16 limbs
M_MAX = 64


@functools.lru_cache(maxsize=None)
def word_consts(spec: FieldSpec):
    """(p as little-endian uint32 words, -p^-1 mod 2^32): the 32-bit-word
    Montgomery constants the CUDA kernels use (R is unchanged)."""
    n_words = spec.n_limbs // 2
    if spec.n_limbs % 2:
        raise ValueError(f"{spec.name}: kernels need an even limb count")
    p = spec.modulus
    words = np.array([(p >> (32 * i)) & 0xFFFFFFFF for i in range(n_words)], dtype=np.uint32)
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return words, n0


def device_kind(*ts: torch.Tensor) -> str:
    """'cuda' or 'cpu' for a set of tensors on one device; raises otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_cuda(spec: FieldSpec, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.shape[0] != spec.n_limbs:
            raise ValueError(
                f"kernel operand must be contiguous int32 (n_limbs, ...): {t.dtype} {tuple(t.shape)}"
            )


# ---------------------------------------------------------------------------
# K1: elementwise Montgomery product
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _col_index(na: int, nb: int, device: torch.device) -> torch.Tensor:
    i = torch.arange(na, device=device)
    j = torch.arange(nb, device=device)
    return (i[:, None] + j[None, :]).reshape(-1)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns of two int64 limb vectors (limb axis
    first, same batch): (na + nb - 1, *batch), each column a lazy sum below
    min(na, nb) 2^32."""
    na, nb = a.shape[0], b.shape[0]
    prod = a.unsqueeze(1) * b.unsqueeze(0)
    cols = torch.zeros((na + nb - 1,) + a.shape[1:], dtype=torch.int64, device=a.device)
    return cols.index_add_(0, _col_index(na, nb, a.device), prod.reshape((na * nb,) + a.shape[1:]))


@functools.lru_cache(maxsize=None)
def _nprime(spec: FieldSpec, device: torch.device) -> torch.Tensor:
    """-p^-1 mod R as int64 limbs."""
    R = 1 << (16 * spec.n_limbs)
    v = limb._ints_to_limbs(np.array((-pow(spec.modulus, -1, R)) % R, dtype=object), spec.n_limbs)
    return torch.as_tensor(v.astype(np.int64), device=device)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch K1: a b R^-1 mod p (broadcasting), Montgomery reduction
    with the full-width N' = -p^-1 mod R: m = (T mod R) N' mod R, then
    (T + m p) / R, each product taken as one batched outer product."""
    n = spec.n_limbs
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    shape = (1,) * (a64.ndim - 1)
    p = limb.const(spec, "p", a64.ndim, a64.device).expand((n,) + a64.shape[1:])
    np_ = _nprime(spec, a64.device).reshape((n,) + shape).expand((n,) + a64.shape[1:])
    bound = 33 + n.bit_length()  # column sums of n products below 2^32, plus one
    t = _mul_cols(a64, b64)
    m = limb.normalize(_mul_cols(limb.normalize(t, n, bound), np_), n, bound)
    u = t + _mul_cols(m, p)
    full = limb.normalize(torch.cat([u, torch.zeros_like(u[:2])]), 2 * n + 1, bound)
    return limb._cond_sub_p(spec, full[n : 2 * n], full[2 * n]).to(limb.DTYPE)


def _launch_mul(spec: FieldSpec, a, b, b_limb_stride: int, b_elem_stride: int):
    _check_cuda(spec, a, b)
    words, n0 = word_consts(spec)
    out = torch.empty_like(a)
    N = a[0].numel()
    code = build.lib().ozl_mont_mul(
        out.data_ptr(), a.data_ptr(), b.data_ptr(), N, b_limb_stride, b_elem_stride,
        spec.n_limbs, words.ctypes.data, n0, build.stream_ptr(a),
    )
    build.check(code, "K1 mont_mul")
    K1.count(N)
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a b R^-1 mod p; a and b of one shape (n_limbs, *batch)."""
    if a.shape != b.shape:
        raise ValueError(f"mont_mul shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if device_kind(a, b) == "cuda":
        return _launch_mul(spec, a, b, a[0].numel(), 1)
    return mont_mul_plain(spec, a, b)


def mont_scale(spec: FieldSpec, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a s R^-1 mod p for one field element s, shaped (n_limbs,) or
    (n_limbs, 1, ...)."""
    if s.numel() != spec.n_limbs:
        raise ValueError("mont_scale takes a single field element")
    if device_kind(a, s) == "cuda":
        return _launch_mul(spec, a, s.reshape(spec.n_limbs).contiguous(), 1, 0)
    return mont_mul_plain(spec, a, s.reshape((spec.n_limbs,) + (1,) * (a.ndim - 1)))


def mont_mul_bcast(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcasting front end (fields.limb.mont_mul): a broadcast single
    element goes to the scale entry, anything else is expanded."""
    if device_kind(a, b) == "cpu":
        return mont_mul_plain(spec, a, b)
    n = spec.n_limbs
    if b.numel() == n and a.numel() >= n:
        return mont_scale(spec, a.contiguous(), b)
    if a.numel() == n:
        return mont_scale(spec, b.contiguous(), a)
    a, b = torch.broadcast_tensors(a, b)
    return mont_mul(spec, a.contiguous(), b.contiguous())


# ---------------------------------------------------------------------------
# K1's exponentiation: a^e in one launch
# ---------------------------------------------------------------------------


def mont_pow_plain(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """Plain torch a^exponent in Montgomery form: MSB-first square and
    multiply over `mont_mul_plain`, starting from the Montgomery one (the
    result for exponent 0)."""
    if exponent < 0:
        raise ValueError(f"mont_pow takes a non-negative exponent, not {exponent}")
    one = limb.const(spec, "r", a.ndim, a.device).to(limb.DTYPE).expand(a.shape).contiguous()
    acc = one
    for i in reversed(range(exponent.bit_length())):
        acc = mont_mul_plain(spec, acc, acc)
        if (exponent >> i) & 1:
            acc = mont_mul_plain(spec, acc, a)
    return acc


@functools.lru_cache(maxsize=64)
def _exponent_words(exponent: int, device: torch.device) -> torch.Tensor:
    """The exponent as little-endian 32-bit words (int32 bits) on `device`,
    at least one word."""
    n = max(1, -(-exponent.bit_length() // 32))
    w = np.array([(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(n)], dtype=np.uint32)
    return torch.as_tensor(w.view(np.int32).copy(), device=device)


@functools.lru_cache(maxsize=None)
def _one_words(spec: FieldSpec) -> np.ndarray:
    """The Montgomery one, R mod p, as little-endian uint32 words."""
    return np.array([(spec.R >> (32 * i)) & 0xFFFFFFFF for i in range(spec.n_limbs // 2)], dtype=np.uint32)


def mont_pow(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent in Montgomery form for a Python-int exponent, elementwise
    over a (n_limbs, *batch): one K1 launch for the whole chain on the
    card, the plain chain on the CPU. Exponent 0 gives the Montgomery one;
    0 maps to 0 for exponent > 0."""
    if exponent < 0:
        raise ValueError(f"mont_pow takes a non-negative exponent, not {exponent}")
    if device_kind(a) == "cpu":
        return mont_pow_plain(spec, a, exponent)
    a = a.contiguous()
    _check_cuda(spec, a)
    words, n0 = word_consts(spec)
    one = _one_words(spec)
    out = torch.empty_like(a)
    N = a[0].numel()
    code = build.lib().ozl_mont_pow(
        out.data_ptr(), a.data_ptr(), N, _exponent_words(exponent, a.device).data_ptr(),
        exponent.bit_length(), spec.n_limbs, words.ctypes.data, n0, one.ctypes.data, build.stream_ptr(a),
    )
    build.check(code, "K1 mont_pow")
    K1P.count(N, spec.n_limbs)
    return out


# ---------------------------------------------------------------------------
# K2: batched M-point DIF NTT, bit-reversed output, fused post-twiddle
# ---------------------------------------------------------------------------


def small_ntt_plain(spec, x, stage_tw, post_tw=None):
    """Plain torch K2. x (n_limbs, M, lanes); stage_tw (n_limbs, log2 M,
    M/2) with entry j of stage s the twiddle of butterfly j (half-width
    h = M >> (s+1), j < h); post_tw like x or None."""
    n, M, L = x.shape
    log_m = M.bit_length() - 1
    for s in range(log_m):
        h = M >> (s + 1)
        y = x.reshape(n, M // (2 * h), 2, h, L)
        u, t = y[:, :, 0], y[:, :, 1]
        tw = stage_tw[:, s, :h].reshape(n, 1, h, 1)
        lo = limb.add(spec, u, t)
        hi = mont_mul_plain(spec, limb.sub(spec, u, t), tw)
        x = torch.stack([lo, hi], dim=2).reshape(n, M, L)
    if post_tw is not None:
        x = mont_mul_plain(spec, x, post_tw)
    return x.to(limb.DTYPE)


def small_ntt(spec: FieldSpec, x, stage_tw, post_tw=None):
    """All log2(M) DIF stages of an M-point transform along axis 1 of
    x (n_limbs, M, lanes), M a power of two <= M_MAX; output in bit-reversed
    order along M, times post_tw elementwise when given."""
    n, M, lanes = x.shape
    if M & (M - 1) or not 2 <= M <= M_MAX:
        raise ValueError(f"small_ntt: M={M} must be a power of two in [2, {M_MAX}]")
    ops = (x, stage_tw) + ((post_tw,) if post_tw is not None else ())
    if device_kind(*ops) == "cpu":
        return small_ntt_plain(spec, x, stage_tw, post_tw)
    _check_cuda(spec, *ops)
    if stage_tw.shape != (n, M.bit_length() - 1, M // 2):
        raise ValueError(f"small_ntt: stage_tw shape {tuple(stage_tw.shape)}")
    if post_tw is not None and post_tw.shape != x.shape:
        raise ValueError("small_ntt: post_tw must match x")
    words, n0 = word_consts(spec)
    out = torch.empty_like(x)
    code = build.lib().ozl_small_ntt(
        out.data_ptr(), x.data_ptr(), stage_tw.data_ptr(),
        post_tw.data_ptr() if post_tw is not None else None,
        M, lanes, n, words.ctypes.data, n0, build.stream_ptr(x),
    )
    build.check(code, "K2 small_ntt")
    K2.count(M * lanes)
    return out



# ---------------------------------------------------------------------------
# K8: radix-2 butterfly, one whole Pease stage per launch
# ---------------------------------------------------------------------------


def butterfly_plain(spec: FieldSpec, u, t, tw):
    """Plain torch K8: (u + t, (u - t) tw), tw broadcasting."""
    return limb.add(spec, u, t), mont_mul_plain(spec, limb.sub(spec, u, t), tw)


def _launch_butterfly(spec, u_ptr, t_ptr, in_ls, tw, mask, lo_ptr, hi_ptr, out_ls, out_ks, H, B, like):
    words, n0 = word_consts(spec)
    code = build.lib().ozl_butterfly(
        u_ptr, t_ptr, in_ls, tw.data_ptr(), tw.shape[1], mask, lo_ptr, hi_ptr, out_ls, out_ks,
        H, B, spec.n_limbs, words.ctypes.data, n0, build.stream_ptr(like),
    )
    build.check(code, "K8 butterfly")
    K8.count(H * B)


def butterfly(spec: FieldSpec, u, t, tw):
    """(u + t, (u - t) tw) in Montgomery form, canonical in [0, p); u, t and
    tw of one shape (n_limbs, *batch)."""
    if not u.shape == t.shape == tw.shape:
        raise ValueError(f"butterfly shapes differ: {tuple(u.shape)}, {tuple(t.shape)}, {tuple(tw.shape)}")
    if device_kind(u, t, tw) == "cpu":
        return butterfly_plain(spec, u, t, tw)
    u, t, tw = (v.contiguous() for v in (u, t, tw))
    _check_cuda(spec, u, t, tw)
    lo, hi = torch.empty_like(u), torch.empty_like(u)
    H = u[0].numel()
    tw = tw.reshape(spec.n_limbs, H)
    _launch_butterfly(spec, u.data_ptr(), t.data_ptr(), H, tw, -1, lo.data_ptr(), hi.data_ptr(), H, 1, H, 1, u)
    return lo, hi


def _stage_mask(s: int) -> int:
    """Twiddle index mask of stage s: e = k & ~(2^s - 1)."""
    return ~((1 << s) - 1)


def stage_plain(spec: FieldSpec, x, table, s: int):
    """Plain torch K8 stage: x (n_limbs, N, *batch); pairs (x[k], x[k + N/2])
    with the twiddle table[k & ~(2^s - 1)] and interleaves lo to slot 2k,
    hi to slot 2k + 1."""
    n, N = x.shape[0], x.shape[1]
    H = N // 2
    e = torch.arange(H, device=x.device) & _stage_mask(s)
    tw = table[:, e].reshape((n, H) + (1,) * (x.ndim - 2))
    lo, hi = butterfly_plain(spec, x[:, :H], x[:, H:], tw)
    return torch.stack([lo, hi], dim=2).reshape(x.shape)


def stage(spec: FieldSpec, x, table, s: int):
    """One constant-geometry DIF stage s of an N-point transform along axis 1
    of x (n_limbs, N, *batch) with the root table (n_limbs, N/2) of
    W[j] = w^j: one K8 launch on the card."""
    if device_kind(x, table) == "cpu":
        return stage_plain(spec, x, table, s)
    x = x.contiguous()
    _check_cuda(spec, x, table)
    N = x.shape[1]
    H, B = N // 2, x[0, 0].numel()
    if N < 2 or N & (N - 1) or table.shape != (spec.n_limbs, H):
        raise ValueError(f"stage: x {tuple(x.shape)}, table {tuple(table.shape)}")
    out = torch.empty_like(x)
    ls, word = N * B, x.element_size()
    _launch_butterfly(
        spec, x.data_ptr(), x.data_ptr() + H * B * word, ls, table, _stage_mask(s),
        out.data_ptr(), out.data_ptr() + B * word, ls, 2 * B, H, B, x,
    )
    return out


# ---------------------------------------------------------------------------
# K8: a whole transform below 2^13 in one launch
# ---------------------------------------------------------------------------

#: largest transform one K8 launch takes: its 2^12 slots of 8 words and
#: 2^11 twiddles fill 192 KB of a block's 227 KB of shared memory
TRANSFORM_MAX = 1 << 12

#: the limb count K8's transform is built for (BN254 Fr, BLS12-381 Fr);
#: `ntt._ntt_core` runs other fields a `stage` launch a stage
TRANSFORM_LIMBS = 16

#: blocks a transform is split over (a thread-block cluster, its first
#: stages across blocks through distributed shared memory) by transform
#: size: the fastest at batch 1 and 3 on the H100 (PERF.md); halved while
#: the batch's blocks outnumber the card's SMs (`cluster_size`)
CLUSTER = {2: 1, 4: 1, 8: 1, 16: 1, 32: 1, 64: 1, 128: 1, 256: 1, 512: 2, 1024: 4, 2048: 8, 4096: 8}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_size(N: int, B: int, device: torch.device) -> int:
    """Blocks a K8 transform of N points takes at batch B: CLUSTER[N],
    halved while B of them outnumber the SMs."""
    C = CLUSTER[N]
    while C > 1 and B * C > _sm_count(device):
        C //= 2
    return C


def transform_plain(spec: FieldSpec, x, table, rev, n_inv, inverse: bool):
    """Plain torch K8 transform: the log2(N) Pease stages (`stage_plain`),
    the gather x[:, rev] into natural order, and for the inverse the 1/N
    scale n_inv."""
    N = x.shape[1]
    for s in range(N.bit_length() - 1):
        x = stage_plain(spec, x, table, s)
    x = x[:, rev]
    if inverse:
        x = mont_mul_plain(spec, x, n_inv.reshape((spec.n_limbs,) + (1,) * (x.ndim - 1)))
    return x


def check_transform(spec: FieldSpec, N: int) -> None:
    """Raise a ValueError for a transform one K8 launch does not take: a
    field of other than TRANSFORM_LIMBS limbs, or N not a power of two in
    [2, TRANSFORM_MAX]."""
    if spec.n_limbs != TRANSFORM_LIMBS:
        raise ValueError(f"K8 transform: {spec.name} has {spec.n_limbs} limbs; the kernel is built for "
                         f"{TRANSFORM_LIMBS}")
    if N & (N - 1) or not 2 <= N <= TRANSFORM_MAX:
        raise ValueError(f"K8 transform: N={N} must be a power of two in [2, {TRANSFORM_MAX}]")


def transform(spec: FieldSpec, x, table, rev, n_inv, inverse: bool):
    """The N-point transform along axis 1 of x (n_limbs, N, *batch),
    natural order in and out, with the root table (n_limbs, N/2) of W[j] =
    w^j, and for the inverse the 1/N scale n_inv: one K8 launch on the card
    (`cluster_size` blocks a transform), the plain version on the CPU.
    `rev` is the plain version's bit-reversal index."""
    if device_kind(x, table) == "cpu":
        return transform_plain(spec, x, table, rev, n_inv, inverse)
    N = x.shape[1]
    check_transform(spec, N)
    x = x.contiguous()
    _check_cuda(spec, x, table)
    if table.shape != (spec.n_limbs, N // 2):
        raise ValueError(f"transform: table {tuple(table.shape)} for N={N}")
    B = x[0, 0].numel()
    C = cluster_size(N, B, x.device)
    scale = n_inv.reshape(spec.n_limbs).contiguous() if inverse else None
    words, n0 = word_consts(spec)
    out = torch.empty_like(x)
    code = build.lib().ozl_ntt_transform(
        out.data_ptr(), x.data_ptr(), table.data_ptr(), scale.data_ptr() if inverse else None,
        N.bit_length() - 1, B, C, spec.n_limbs, words.ctypes.data, n0, build.stream_ptr(x),
    )
    build.check(code, "K8 transform")
    K8.count(N // 2 * B)
    return out
