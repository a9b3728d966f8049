"""Kernels K3 (Jacobian add / mixed add), K4 (Jacobian double), K9 (the
MSM's sorted-chunk mixed-add fold) and K3's lifted scan variant (the
exclusive prefixes of the fold's chunk totals).

Port of `openzl_tpu/ops/ec_kernel.py` `ec_op` and `fold_madd`, and of the
reference's scan of the chunk totals (`openzl_tpu/ops/scan_utils.py`
`inclusive_scan` with the lifted combine of `openzl_tpu/ops/msm.py:352`).
CUDA sources: `openzl_tpu_torch/csrc/ec_kernel.cu`, `fold_kernel.cu`,
`ec.cuh` (design notes there), their templates `ec_kernel.cuh` and
`fold.cuh`, and the BLS12-381 (24-limb) instantiations
`ec_kernel_w12_g1.cu`, `ec_kernel_w12_g2.cu` and `fold_kernel_w12.cu`;
this module holds the wrappers, launch counters and plain torch versions.

Coordinates are Montgomery limb tensors (n_limbs, *batch) over Fq (G1) or
(n_limbs, 2, *batch) over Fq2 (G2). Formulas and special-case masks follow
the reference kernels exactly (add-2007-bl, madd-2007-bl, dbl-2009-l or
the generic-a double; P = -Q gives X = Y = 1, Z = 0), so Jacobian limbs are
bit-equal to `ec_kernel.ec_op`. A CUDA tensor launches the kernel (or
raises, for a field with no built instantiation: `check_built`), a CPU
tensor runs the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.spec import CurveSpec
from ..fields.ext import fq2_ops, fq_ops
from ..utils import build
from .ntt_kernel import device_kind, word_consts

K3 = build.KernelInfo(
    name="ec_add",
    source="openzl_tpu_torch/csrc/ec_kernel.cu",
    replaces="openzl_tpu/ops/ec_kernel.py:288",
)
K4 = build.KernelInfo(
    name="ec_dbl",
    source="openzl_tpu_torch/csrc/ec_kernel.cu",
    replaces="openzl_tpu/ops/ec_kernel.py:314",
)
K9 = build.KernelInfo(
    name="fold_madd",
    source="openzl_tpu_torch/csrc/fold_kernel.cu",
    replaces="openzl_tpu/ops/ec_kernel.py:430",
)
K3S = build.KernelInfo(
    name="ec_lifted_scan",
    source="openzl_tpu_torch/csrc/ec_kernel.cu",
    replaces="openzl_tpu/ops/scan_utils.py:71 (inclusive_scan at openzl_tpu/ops/msm.py:362); "
    "openzl_tpu/ops/ec_kernel.py:288",
)

#: elements per chunk of the lifted scan (`kChunk` in ec_kernel.cu): each
#: wide level folds chunks of SCAN_R serially, so the scan takes about 2 l
#: adds over log_SCAN_R l levels
SCAN_R = 4
#: a level of at most SCAN_NARROW elements runs Hillis-Steele steps instead
#: (one add of latency per doubling, where a level of chunks costs SCAN_R + 1)
SCAN_NARROW = 16384
#: base-field limb counts the CUDA kernels of this module are built for:
#: 16 (BN254 Fq, 8 words: csrc/ec_kernel.cu, fold_kernel.cu) and 24
#: (BLS12-381 Fq, 12 words: csrc/ec_kernel_w12_g1.cu, ec_kernel_w12_g2.cu,
#: fold_kernel_w12.cu)
BUILT_LIMBS = (16, 24)


def field_ops(curve: CurveSpec, plain: bool = False):
    """Coordinate-field ops; `plain` keeps products in plain torch."""
    if curve.ext == 2:
        return fq2_ops(curve.base, curve.nr2, plain)
    return fq_ops(curve.base, plain)


# ---------------------------------------------------------------------------
# plain torch versions
# ---------------------------------------------------------------------------


def _raw_one_like(F, v):
    o = torch.zeros_like(v)
    if F.value_ndim == 1:
        o[0] = 1
    else:
        o[0, 0] = 1
    return o


def _a_const(curve: CurveSpec, F, like):
    return F.const(curve.a, like.ndim - F.value_ndim, like.device)


def _products(F, *pairs):
    """The products a b of several (a, b) operand pairs as ONE batched field
    product over a new trailing axis: the plain versions pay per torch
    call, and each formula step's products are independent."""
    ops = torch.broadcast_tensors(*(t for pair in pairs for t in pair))
    return F.mul(torch.stack(ops[0::2], dim=-1), torch.stack(ops[1::2], dim=-1)).unbind(-1)


def ec_dbl_plain(curve: CurveSpec, X, Y, Z):
    """dbl-2009-l (a = 0) or M = 3X^2 + a Z^4 (generic a); Z3 = 2YZ keeps
    the identity. Plain torch on any device."""
    F = field_ops(curve, plain=True)
    A, B = _products(F, (X, X), (Y, Y))
    XB = F.add(X, B)
    C, T = _products(F, (B, B), (XB, XB))
    D = F.double(F.sub(T, F.add(A, C)))
    E = F.add(F.double(A), A)
    if curve.a != 0:
        E = F.add(E, F.mul(_a_const(curve, F, Z), F.sqr(F.sqr(Z))))
    EE, YZ = _products(F, (E, E), (Y, Z))
    X3 = F.sub(EE, F.double(D))
    C8 = F.double(F.double(F.double(C)))
    (EDX,) = _products(F, (E, F.sub(D, X3)))
    return X3, F.sub(EDX, C8), F.double(YZ)


def ec_add_plain(curve: CurveSpec, P, Q, mixed: bool):
    """add-2007-bl, or madd-2007-bl when `mixed` (Q normalized, Z in {0,1}),
    with the reference kernels' masks. Plain torch on any device."""
    F = field_ops(curve, plain=True)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    if mixed:
        (Z1Z1,) = _products(F, (Z1, Z1))
        U1, S1 = X1, Y1
        U2, Z1c = _products(F, (X2, Z1Z1), (Z1, Z1Z1))
        (S2,) = _products(F, (Y2, Z1c))
    else:
        Z1Z1, Z2Z2 = _products(F, (Z1, Z1), (Z2, Z2))
        U1, U2, Z2c, Z1c = _products(F, (X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1))
        S1, S2 = _products(F, (Y1, Z2c), (Y2, Z1c))
    H = F.sub(U2, U1)
    r = F.double(F.sub(S2, S1))
    if mixed:
        HH, rr = _products(F, (H, H), (r, r))
        I = F.double(F.double(HH))
        ZH = F.add(Z1, H)
        J, V, ZH2 = _products(F, (H, I), (U1, I), (ZH, ZH))
        Z3 = F.sub(F.sub(ZH2, Z1Z1), HH)
    else:
        H2, Z12 = F.double(H), F.add(Z1, Z2)
        I, rr, Z12s = _products(F, (H2, H2), (r, r), (Z12, Z12))
        J, V, Z3 = _products(F, (H, I), (U1, I), (F.sub(Z12s, F.add(Z1Z1, Z2Z2)), H))
    X3 = F.sub(rr, F.add(J, F.double(V)))
    rVX, S1J = _products(F, (r, F.sub(V, X3)), (S1, J))
    Y3 = F.sub(rVX, F.double(S1J))

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    h_zero = F.is_zero(H)
    r_zero = F.is_zero(r)
    both = ~p_inf & ~q_inf
    same = both & h_zero & r_zero
    opposite = both & h_zero & ~r_zero

    # the doubling is selected only where P = Q: skip computing it when no
    # element needs it (the selected values are the same either way)
    dbl = ec_dbl_plain(curve, X1, Y1, Z1) if bool(same.any()) else (None,) * 3
    one = _raw_one_like(F, X1)
    zero = torch.zeros_like(X1)
    out = []
    for v3, d, o, c1, c2 in ((X3, dbl[0], one, X1, X2), (Y3, dbl[1], one, Y1, Y2), (Z3, dbl[2], zero, Z1, Z2)):
        if d is not None:
            v3 = F.select(same, d, v3)
        v3 = F.select(opposite, o, v3)
        v3 = F.select(p_inf, c2, v3)
        v3 = F.select(q_inf, c1, v3)
        out.append(v3)
    return tuple(out)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _const_words(curve: CurveSpec, value: int) -> np.ndarray:
    """Montgomery form of a base-field constant (value + 0 u over Fq2) as
    uint32 words (c0 words then c1 words over Fq2)."""
    spec = curve.base
    pair = (value, 0) if curve.ext == 2 else (value,)
    words = []
    for c in pair:
        m = spec.to_mont(c % spec.modulus)
        words += [(m >> (32 * i)) & 0xFFFFFFFF for i in range(spec.n_limbs // 2)]
    return np.array(words, dtype=np.uint32)


def check_built(curve: CurveSpec) -> None:
    """Raise, before any launch, for a curve whose field has no built
    instantiation of K3, K4, K9 and the scan: 16 or 24 limbs (`BUILT_LIMBS`)
    and the top 32-bit word of p below 0x7FFFFFFF (`F1c`'s bound)."""
    n = curve.base.n_limbs
    if n not in BUILT_LIMBS:
        raise ValueError(f"{curve.name}: the EC kernels are built for base fields of "
                         f"{' or '.join(map(str, BUILT_LIMBS))} limbs, not {n}")
    top = curve.base.modulus >> (16 * n - 32)
    if top >= 0x7FFFFFFF:
        raise ValueError(f"{curve.name}: the EC kernels need the top word of p below 0x7FFFFFFF "
                         f"({n} limbs, top word {top:#x})")


def _flat(curve: CurveSpec, coords):
    """Check the curve (`check_built`) and flatten coordinates to
    (n_limbs[, 2], N) contiguous int32."""
    check_built(curve)
    lead = 1 + (curve.ext == 2)
    shape = coords[0].shape
    head = shape[:lead]
    if head != (curve.base.n_limbs,) + ((2,) if curve.ext == 2 else ()):
        raise ValueError(f"{curve.name}: coordinate shape {tuple(shape)}")
    flat = []
    for c in coords:
        if c.shape != shape or c.dtype != torch.int32:
            raise ValueError("EC kernel coordinates must share one int32 shape")
        flat.append(c.contiguous().reshape(head + (-1,)))
    return flat, shape


def _launch_args(curve: CurveSpec):
    words, n0 = word_consts(curve.base)
    has_a = int(curve.a != 0)
    return words, n0, curve.nr2, has_a, _const_words(curve, curve.a)


def ec_add(curve: CurveSpec, P, Q, mixed: bool = False):
    """Batched P + Q (K3). P, Q: (X, Y, Z) tuples of one shape; with
    `mixed`, Q must be normalized (Z in {0, 1})."""
    coords = tuple(P) + tuple(Q)
    if device_kind(*coords) == "cpu":
        return ec_add_plain(curve, P, Q, mixed)
    flat, shape = _flat(curve, coords)
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    N = flat[0].shape[-1]
    words, n0, beta, has_a, a_words = _launch_args(curve)
    code = build.lib().ozl_ec_add(
        int(mixed), curve.ext, *(t.data_ptr() for t in flat + outs), N,
        curve.base.n_limbs, words.ctypes.data, n0, beta, has_a, a_words.ctypes.data,
        build.stream_ptr(flat[0]),
    )
    build.check(code, "K3 ec_add")
    K3.count(N, curve.base.n_limbs)
    return tuple(o.reshape(shape) for o in outs)


def ec_dbl(curve: CurveSpec, P):
    """Batched 2P (K4)."""
    if device_kind(*P) == "cpu":
        return ec_dbl_plain(curve, *P)
    flat, shape = _flat(curve, tuple(P))
    outs = [torch.empty_like(flat[0]) for _ in range(3)]
    N = flat[0].shape[-1]
    words, n0, beta, has_a, a_words = _launch_args(curve)
    code = build.lib().ozl_ec_dbl(
        curve.ext, *(t.data_ptr() for t in flat + outs), N, curve.base.n_limbs,
        words.ctypes.data, n0, beta, has_a, a_words.ctypes.data, build.stream_ptr(flat[0]),
    )
    build.check(code, "K4 ec_dbl")
    K4.count(N, curve.base.n_limbs)
    return tuple(o.reshape(shape) for o in outs)


# ---------------------------------------------------------------------------
# K9: sorted-chunk mixed-add fold (the MSM bucket step)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mont_one(curve: CurveSpec, device) -> torch.Tensor:
    """Montgomery one of the coordinate field, (n_limbs[, 2], 1), built once
    per device (a copy from the host on every fold call would wait for the
    device's queue)."""
    return field_ops(curve).one((1,), device).contiguous()


def _fold_outputs(curve: CurveSpec, l: int, width: int, device):
    """The fold's outputs as the kernel starts them: chunk totals (l,) and
    their start flags, which it writes in full (left uninitialised), and the
    bucket slots (width,) that segment tails overwrite, initialised to the
    identity (X = Y = Montgomery one, Z = 0), flag True and chunk 0, so an
    untouched slot combines to the identity."""
    F = field_ops(curve)
    head = (curve.base.n_limbs,) + ((2,) if curve.ext == 2 else ())
    totals = tuple(torch.empty(head + (l,), dtype=torch.int32, device=device) for _ in range(3))
    tflag = torch.empty(l, dtype=torch.bool, device=device)
    one = _mont_one(curve, torch.device(device))
    buckets = tuple(one.expand(one.shape[:-1] + (width,)).contiguous() for _ in range(2))
    buckets += (F.zeros((width,), device),)
    bflag = torch.ones(width, dtype=torch.bool, device=device)
    bchunk = torch.zeros(width, dtype=torch.int64, device=device)
    return totals, tflag, buckets, bflag, bchunk


def fold_madd_plain(curve: CurveSpec, pts, keys, pidx, r: int, width: int):
    """Plain torch K9: the reference's `_fold_columns` loop (r mixed adds and
    selects over the l = len(keys) / r chunks, entry j of chunk c being
    element c r + j) and then the pick of each segment tail's prefix into
    bucket slot `key`. Returns the same tensors as `fold_madd`."""
    F = field_ops(curve, plain=True)
    n = keys.shape[0]
    l = n // r
    dev = keys.device
    _, _, buckets, bflag, bchunk = _fold_outputs(curve, l, width, dev)
    tflag = torch.zeros(l, dtype=torch.bool, device=dev)
    none = keys.new_full((1,), -1)
    starts = (keys != torch.cat([none, keys[:-1]])).reshape(l, r)
    tails = (keys != torch.cat([keys[1:], none])).reshape(l, r)
    key_cols, idx_cols = keys.reshape(l, r), pidx.reshape(l, r)
    chunk = torch.arange(l, device=dev)
    one = F.one((l,), dev)
    acc = (one, one, F.zeros((l,), dev))
    for j in range(r):
        i = idx_cols[:, j]
        q = (pts[0][..., i], pts[1][..., i], one)
        s = starts[:, j]
        summed = ec_add_plain(curve, acc, q, mixed=True)
        acc = tuple(F.select(s, a, b) for a, b in zip(q, summed))
        tflag = tflag | s
        t = tails[:, j]
        slot = key_cols[t, j]
        for b, a in zip(buckets, acc):
            b[..., slot] = a[..., t]
        bflag[slot] = tflag[t]
        bchunk[slot] = chunk[t]
    return acc, tflag, buckets, bflag, bchunk


def point_words(curve: CurveSpec, pts) -> torch.Tensor:
    """K9's point-major copy of the points: (n_pts, 2 ext n_limbs / 2) int32,
    row i holding X then Y of point i as 32-bit little-endian words (c0's
    words, then c1's, over Fq2), from the limb-planar (n_limbs[, 2], n_pts)
    coordinates. One point is 64 contiguous bytes over Fq, 128 over Fq2.
    Each 16-bit limb is cut to int16 in one converting copy per coordinate,
    and each pair of limbs is then read as one 32-bit word."""
    n, N = curve.base.n_limbs, pts[0].shape[-1]
    inner = (2, n) if curve.ext == 2 else (n,)
    out = torch.empty((N, 2) + inner, dtype=torch.int16, device=pts[0].device)
    for k in range(2):
        out[:, k].copy_(pts[k].permute(*range(pts[k].ndim - 1, -1, -1)))
    return out.view(torch.int32).reshape(N, -1)


def fold_madd(curve: CurveSpec, pts, keys, pidx, r: int, width: int):
    """Fold the sorted MSM entries in chunks of r (K9).

    pts: the normalized points (X, Y, Z), batch (n_pts,), every entry's
    point live (Z = 1); keys: sorted int64 bucket keys in [0, width), length
    a multiple of r; pidx: each entry's point index. On the card the kernel
    reads the points through their point-major copy (`point_words`, made
    per call). Returns ((X, Y, Z) chunk totals, chunk-holds-a-start flags,
    (X, Y, Z) bucket slots with each segment tail's chunk-local prefix,
    bflag (the segment started in the tail's chunk; True where no tail),
    the tail's chunk index)."""
    if keys.shape != pidx.shape or keys.ndim != 1 or keys.shape[0] % r:
        raise ValueError(f"fold_madd: keys {tuple(keys.shape)}, pidx {tuple(pidx.shape)}, r={r}")
    if device_kind(keys, pidx, *pts) == "cpu":
        return fold_madd_plain(curve, pts, keys, pidx, r, width)
    _flat(curve, tuple(pts[:2]))
    if keys.dtype != torch.int64 or pidx.dtype != torch.int64:
        raise ValueError("fold_madd: keys and pidx must be int64")
    keys, pidx = keys.contiguous(), pidx.contiguous()
    packed = point_words(curve, pts)
    l = keys.shape[0] // r
    totals, tflag, buckets, bflag, bchunk = _fold_outputs(curve, l, width, keys.device)
    words, n0, beta, has_a, a_words = _launch_args(curve)
    code = build.lib().ozl_fold_madd(
        curve.ext, keys.data_ptr(), pidx.data_ptr(), l, r, packed.data_ptr(),
        *(t.data_ptr() for t in totals), tflag.data_ptr(),
        *(b.data_ptr() for b in buckets), bflag.data_ptr(), bchunk.data_ptr(), width,
        curve.base.n_limbs, words.ctypes.data, n0, beta, has_a, a_words.ctypes.data,
        _const_words(curve, 1).ctypes.data, build.stream_ptr(keys),
    )
    build.check(code, "K9 fold_madd")
    K9.count(keys.shape[0], curve.base.n_limbs)
    return totals, tflag, buckets, bflag, bchunk


# ---------------------------------------------------------------------------
# K3's lifted scan variant: the MSM's scan of the chunk totals
# ---------------------------------------------------------------------------


def _lifted_add_plain(curve: CurveSpec, F, a, b, bf):
    """Values of the lifted monoid (ec.cuh `lifted_add`): b where bf, else
    a + b (K3's full add)."""
    s = ec_add_plain(curve, a, b, mixed=False)
    return tuple(F.select(bf, u, v) for u, v in zip(b, s))


def scan_fold_plain(curve: CurveSpec, values, flags):
    """Phase 1 of `lifted_scan_plain`: chunks of SCAN_R consecutive elements (a
    ragged last chunk padded with identities flagged False), each folded
    serially from the identity. Returns (each element's exclusive prefix
    within its chunk (X, Y, Z), their flags, the chunk totals (X, Y, Z),
    their flags)."""
    F = field_ops(curve, plain=True)
    n, dev = flags.shape[0], flags.device
    m = -(-n // SCAN_R)
    cols = SCAN_R if m > 1 else n
    pad = m * cols - n
    one = F.one((pad,), dev)
    grid = [torch.cat([v, p], dim=-1).reshape(v.shape[:-1] + (m, cols))
            for v, p in zip(values, (one, one, F.zeros((pad,), dev)))]
    fgrid = torch.cat([flags, flags.new_zeros(pad)]).reshape(m, cols)
    one = F.one((m,), dev)
    acc, accf = (one, one, F.zeros((m,), dev)), torch.zeros(m, dtype=torch.bool, device=dev)
    pre, pre_f = [], []
    for j in range(cols):
        pre.append(acc)
        pre_f.append(accf)
        acc = _lifted_add_plain(curve, F, acc, tuple(v[..., j] for v in grid), fgrid[:, j])
        accf = accf | fgrid[:, j]
    pre = tuple(torch.stack(vs, dim=-1).reshape(vs[0].shape[:-1] + (m * cols,))[..., :n] for vs in zip(*pre))
    return pre, torch.stack(pre_f, dim=-1).reshape(m * cols)[:n], acc, accf


def scan_offsets_plain(curve: CurveSpec, offsets, pre, pre_f):
    """Phase 3 of `lifted_scan_plain`: element i's prefix within its chunk
    under its chunk's offset, the lifted sum of offsets[i // SCAN_R] and
    pre[i]."""
    chunk = torch.arange(pre_f.shape[0], device=pre_f.device) // SCAN_R
    return _lifted_add_plain(curve, field_ops(curve, plain=True), tuple(v[..., chunk] for v in offsets), pre, pre_f)


def scan_step_plain(curve: CurveSpec, values, flags, d: int):
    """A narrow level's Hillis-Steele step: element i becomes the lifted sum
    of elements i - d and i where i >= d. The last step (2 d >= n) returns
    the exclusive prefixes: each inclusive one moved one element on, the
    identity at element 0. Returns (values, flags)."""
    F = field_ops(curve, plain=True)
    n = flags.shape[0]
    s = _lifted_add_plain(curve, F, tuple(v[..., : n - d] for v in values), tuple(v[..., d:] for v in values),
                          flags[d:])
    values = tuple(torch.cat([v[..., :d], u], dim=-1) for v, u in zip(values, s))
    flags = torch.cat([flags[:d], flags[: n - d] | flags[d:]])
    if 2 * d < n:
        return values, flags
    one = F.one((1,), flags.device)
    ident = (one, one, F.zeros((1,), flags.device))
    return (tuple(torch.cat([o, v[..., : n - 1]], dim=-1) for o, v in zip(ident, values)),
            torch.cat([flags.new_zeros(1), flags[: n - 1]]))


def lifted_scan_plain(curve: CurveSpec, totals, tflag):
    """Plain torch version of `lifted_scan`, in the kernel's association
    order: a level of 2 to SCAN_NARROW elements by Hillis-Steele steps
    (`scan_step_plain`); a wider one by phase 1 (`scan_fold_plain`), the
    chunk totals' exclusive prefixes by the same scan (none past a single
    chunk), and phase 3 (`scan_offsets_plain`)."""
    n = tflag.shape[0]
    if n == 0:
        return tuple(totals)
    if 2 <= n <= SCAN_NARROW:
        values, flags, d = tuple(totals), tflag, 1
        while d < n:
            values, flags = scan_step_plain(curve, values, flags, d)
            d *= 2
        return values
    pre, pre_f, tot, tot_f = scan_fold_plain(curve, totals, tflag)
    if tot_f.shape[0] == 1:
        return pre
    return scan_offsets_plain(curve, lifted_scan_plain(curve, tot, tot_f), pre, pre_f)


def _scan_level(curve: CurveSpec, xs, flags, args):
    """Exclusive lifted prefixes of one level (flat coordinates (.., n) and
    flags (n,)): Hillis-Steele steps, or phase 1, the totals' prefixes by
    recursion and phase 3."""
    n = flags.shape[0]
    lib = build.lib()
    if 2 <= n <= SCAN_NARROW:
        d = 1
        while d < n:
            out = [torch.empty_like(v) for v in xs]
            out_f = torch.empty_like(flags)
            ptrs = [t.data_ptr() for t in (*xs, flags, *out, out_f)] + [0] * 4
            build.check(lib.ozl_ec_lifted_scan(2, curve.ext, *ptrs, n, d, *args), "K3 lifted scan (step)")
            K3S.count(n, curve.base.n_limbs)
            xs, flags, d = out, out_f, 2 * d
        return xs
    m = -(-n // SCAN_R)
    pre = [torch.empty_like(v) for v in xs]
    pre_f = torch.empty_like(flags)
    tot = [torch.empty(v.shape[:-1] + (m,), dtype=v.dtype, device=v.device) for v in xs]
    tot_f = torch.empty(m, dtype=flags.dtype, device=flags.device)
    ptrs = [t.data_ptr() for t in (*xs, flags, *pre, pre_f, *tot, tot_f)]
    build.check(lib.ozl_ec_lifted_scan(1, curve.ext, *ptrs, n, 0, *args), "K3 lifted scan (phase 1)")
    K3S.count(n, curve.base.n_limbs)
    if m > 1:
        off = _scan_level(curve, tot, tot_f, args)
        ptrs = [t.data_ptr() for t in off] + [0] + [t.data_ptr() for t in (*pre, pre_f)] + [0] * 4
        build.check(lib.ozl_ec_lifted_scan(3, curve.ext, *ptrs, n, 0, *args), "K3 lifted scan (phase 3)")
        K3S.count(n, curve.base.n_limbs)
    return pre


def lifted_scan(curve: CurveSpec, totals, tflag):
    """Exclusive prefixes of the chunk totals (X, Y, Z) (batch (l,)) under
    the lifted monoid (value, flag): b's value alone once b's flag is set,
    else a + b. Element i gets the lifted sum of elements 0 .. i - 1 (the
    identity at i = 0). On the card: K3's scan variant, a fold launch and an
    offset launch per level of ceil(l / SCAN_R^k) elements above
    SCAN_NARROW, and ceil(log2 n) Hillis-Steele launches for the first
    level of 2 to SCAN_NARROW elements. Returns (X, Y, Z) with batch (l,)."""
    if tflag.ndim != 1 or tflag.dtype != torch.bool or tuple(totals[0].shape[-1:]) != tuple(tflag.shape):
        raise ValueError(f"lifted_scan: totals {tuple(totals[0].shape)}, flags {tuple(tflag.shape)}")
    if device_kind(*totals, tflag) == "cpu":
        return lifted_scan_plain(curve, totals, tflag)
    flat, shape = _flat(curve, tuple(totals))
    words, n0, beta, has_a, a_words = _launch_args(curve)
    args = (curve.base.n_limbs, words.ctypes.data, n0, beta, has_a, a_words.ctypes.data,
            _const_words(curve, 1).ctypes.data, build.stream_ptr(tflag))
    out = _scan_level(curve, flat, tflag.contiguous(), args)
    return tuple(o.reshape(shape) for o in out)
