"""Kernels K1 (elementwise Montgomery product, and the Montgomery
exponentiation through the same field code), K2 (one level of the
four-step NTT in one launch) and K8 (radix-2 butterflies: a whole
transform below 2^13 in one launch, and one stage).

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
# K2: one four-step level in one launch
# ---------------------------------------------------------------------------


def small_ntt_plain(spec, x, stage_tw, post_tw=None):
    """All log2(M) DIF stages of an M-point transform along axis 1 of x
    (n_limbs, M, lanes), output in bit-reversed order along M, times
    post_tw elementwise when given: the function of the JAX package's
    `small_ntt`. stage_tw (n_limbs, log2 M, M/2) holds at entry j of stage
    s the twiddle of butterfly j (half-width h = M >> (s+1), j < h)."""
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


def to_words(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """(n_limbs, n) limbs -> (n, n_limbs / 2) int32 words (word w = limb 2w
    | limb 2w+1 << 16, as bits): the word-packed layout K2 reads its tables
    in, one element's words contiguous."""
    t = t.reshape(spec.n_limbs, -1).to(torch.int64)
    w = t[0::2] | (t[1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).t().contiguous()


def from_words(spec: FieldSpec, w: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_words`: (n, n_limbs / 2) words -> (n_limbs, n) limbs."""
    w = w.to(torch.int64).t() & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(spec.n_limbs, -1).to(limb.DTYPE)


#: largest level one K2 launch takes (`ntt._levels` splits a transform into
#: balanced levels of at most M_MAX points)
M_MAX = 64

#: threads a K2 block runs (`kernel_probe k2` sweeps them, PERF.md), and
#: radix-2 stages a pass of the level's DIF runs in registers (kLevelPass
#: in ntt.cuh)
LEVEL_THREADS = 256
LEVEL_PASS = 2


def stage_twiddles(R: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """`small_ntt_plain`'s stage table of an m-point DIF from the (n_limbs,
    n) root table R of w_n^j: (n_limbs, log2 m, m/2), entry j of stage s
    w_m^(2^s j)."""
    log_m = m.bit_length() - 1
    j = torch.arange(m // 2, dtype=torch.int64, device=R.device)
    return torch.stack([R[:, ((n // m) << s) * j % n] for s in range(log_m)], dim=1)


def _level_shape(x, log_m: int, nt: int):
    """(N, B, M, S, c) of a level: x (n_limbs, N, B) read as (M, S, c)."""
    N, B = x.shape[1], x.shape[2]
    M = 1 << log_m
    if N & (N - 1) or nt & (nt - 1) or not M <= nt <= N:
        raise ValueError(f"four-step level: M={M}, nt={nt} and N={N} must be powers of two, M <= nt <= N")
    return N, B, M, nt // M, N * B // nt


def level_plain(spec: FieldSpec, x, roots, log_m: int, nt: int, pre=None, post=None):
    """Plain torch K2: one level of the four-step transform of x (n_limbs,
    N, B) read as (M, S, c) (M = 2^log_m, S = nt / M, c = N B / nt), into
    (S, M, c) as (n_limbs, N, B): x times pre[i] (i = row, where given),
    the M-point DIF of every (column, lane) (`small_ntt_plain`), the
    bit-reversal gather into natural order, the level twiddle w_nt^(k1 j2)
    (w_nt = w_N^(N / nt)), the transpose, and post[i] (or post[0] when it
    holds one element). roots: (N, NW) words of w_N^j; pre, post: words."""
    N, B, M, S, c = _level_shape(x, log_m, nt)
    n = spec.n_limbs
    R = from_words(spec, roots)
    if pre is not None:
        x = mont_mul_plain(spec, x, from_words(spec, pre).reshape(n, N, 1))
    y = small_ntt_plain(spec, x.reshape(n, M, S * c), stage_twiddles(R, N, M))
    rev = torch.as_tensor(bitrev(M), device=x.device)
    k1, j2 = torch.arange(M, device=x.device), torch.arange(S, device=x.device)
    tw = R[:, (N // nt) * k1[:, None] * j2[None, :]].reshape(n, M, S, 1)
    y = mont_mul_plain(spec, y[:, rev].reshape(n, M, S, c), tw)
    y = y.permute(0, 2, 1, 3).reshape(n, N, B)
    if post is not None:
        scale = from_words(spec, post)
        y = mont_mul_plain(spec, y, scale.reshape(n, -1, 1))
    return y.to(limb.DTYPE)


def level_smem(spec: FieldSpec, log_m: int, tile: int) -> int:
    """Shared memory bytes of a K2 block: the tile's M (tile + 1) words
    and the M/2 stage twiddles, NW words each."""
    M = 1 << log_m
    return 4 * spec.n_limbs // 2 * (M * (tile + 1) + M // 2)


#: shared memory a block can have on the H100 (227 KB)
SMEM_MAX = 232448

#: the largest level and tile the kernel takes (kLevelMaxLog and
#: kLevelMaxTile in ntt_kernel.cu)
LEVEL_MAX_LOG = 9
LEVEL_MAX_TILE = 256


def level_tile(spec: FieldSpec, log_m: int) -> int:
    """Lanes a K2 block takes at a level of 2^log_m points: those that give
    its largest pass (the level's stages split into passes of at most
    LEVEL_PASS, balanced, as the kernel splits them) one item a thread of
    LEVEL_THREADS, halved while the tile does not fit shared memory."""
    passes = -(-log_m // LEVEL_PASS)
    a = -(-log_m // passes)
    tile = max(1, min(LEVEL_MAX_TILE, (LEVEL_THREADS << a) >> log_m))
    while tile > 1 and level_smem(spec, log_m, tile) > SMEM_MAX:
        tile //= 2
    return tile


def fourstep_level(spec: FieldSpec, x, roots, log_m: int, nt: int, pre=None, post=None):
    """One level of the four-step transform: x (n_limbs, N, B) read as (M,
    S, c) -> (S, M, c), the M-point DFT of each (column, lane) times w_nt^(k1
    j2), times pre[i] before and post[i] (or post[0]) after where given
    (`level_plain`). One K2 launch on the card, the plain version on the
    CPU. roots (N, NW), pre (N, NW) and post (N, NW) or (1, NW): word-packed
    tables (`to_words`) on x's device."""
    N, B, M, S, c = _level_shape(x, log_m, nt)
    tables = [t for t in (roots, pre, post) if t is not None]
    if device_kind(x, *tables) == "cpu":
        return level_plain(spec, x, roots, log_m, nt, pre, post)
    _check_cuda(spec, x)
    nw = spec.n_limbs // 2
    for t, rows in ((roots, (N,)), (pre, (N,)), (post, (N, 1))):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous() or t.shape[1:] != (nw,)
                              or t.shape[0] not in rows):
            raise ValueError(f"four-step level: table {t.dtype} {tuple(t.shape)} for N={N}, {nw} words")
    if log_m > LEVEL_MAX_LOG or N * B >= 1 << 31:
        raise ValueError(f"four-step level: M={M} past 2^{LEVEL_MAX_LOG}, or N B = {N * B} past 32-bit indices")
    tile = level_tile(spec, log_m)
    words, n0 = word_consts(spec)
    out = torch.empty_like(x)
    code = build.lib().ozl_fourstep_level(
        out.data_ptr(), x.data_ptr(), roots.data_ptr(), pre.data_ptr() if pre is not None else None,
        post.data_ptr() if post is not None else None, int(post is not None and post.shape[0] == 1),
        N.bit_length() - 1, log_m, S, c, B, tile, spec.n_limbs, words.ctypes.data, n0,
        build.stream_ptr(x),
    )
    build.check(code, "K2 fourstep_level")
    K2.count(N * B, spec.n_limbs)
    return out


def bitrev(m: int) -> np.ndarray:
    """The bit-reversal permutation of range(m), m a power of two."""
    log = m.bit_length() - 1
    idx = np.arange(m, dtype=np.int64)
    r = np.zeros(m, dtype=np.int64)
    for _ in range(log):
        r = (r << 1) | (idx & 1)
        idx >>= 1
    return r


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
