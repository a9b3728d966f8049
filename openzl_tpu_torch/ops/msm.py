"""Multi-scalar multiplication: bucket method on sorted digit keys.

Port of `openzl_tpu/ops/msm.py` (`msm`, `msm_multi`, `fixed_base_msm`).
Only the group element is bit-exact with the reference. The bucket totals
follow the reference's segment-total pipeline (`_bucket_totals_fast`,
msm.py:205-407), and every group operation goes through kernels K3 (add,
mixed add), K4 (double) and K9 (the sorted-chunk fold):

  1. normalize the points (Z in {0, 1}); one batched inversion;
  2. c-bit digits of every window; each (set, window, nonzero digit,
     live point) becomes one entry keyed (set, window, digit), and one
     `torch.sort` on the int64 keys groups each bucket's points. The keys
     are int64, so the reference's PARTS split of an over-long 32-bit
     packed key (msm.py:253-265) is not needed;
  3. bucket totals: K9 folds chunks of r consecutive sorted entries (r up
     to 32, as the reference picks it; the tail is padded with a dump key)
     with mixed adds, gathering each entry's point by index, and writes the
     prefix of every segment tail into its bucket slot; a lifted segmented
     scan over the chunk totals (K3's scan variant, work-efficient as the
     reference's chunked scan) gives each chunk's exclusive offset, and one
     bucket-width gather and lifted K3 combine add the offsets of buckets
     whose segment started in an earlier chunk, into a dense (S W 2^c)
     bucket array. Nothing between the sort and step 4 reads a value back
     to the host;
  4. window sums sum_d d B_d by binary decomposition: for each bit k the
     buckets whose digit has bit k set are tree-reduced, then
     sum_k 2^k T_k by doubling;
  5. Horner over the windows (c doublings per window).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..curves.spec import CurveSpec
from ..fields.spec import LIMB_BITS
from ..curves import jacobian as jac
from ..curves.jacobian import JPoint
from . import ec_kernel


def default_window_bits(n: int, total_bits: int = 254) -> int:
    """c minimizing the modeled adds over all windows: about n per window
    for the bucket sums plus c 2^(c-1) for the bit-decomposed weighting
    (step 4). torch.sort takes int64 keys, so unlike the TPU reference no
    key-packing limit constrains c. At n = 2^17 this picks c = 11; at 2^20,
    c = 15 (the modeled cost is within 0.5% from 13 to 15)."""
    best, best_cost = 2, None
    for c in range(2, 17):
        cost = -(-total_bits // c) * (n + c * (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def _digits(scalars: torch.Tensor, c: int, n_windows: int) -> torch.Tensor:
    """(n_limbs, n) canonical limbs -> (n_windows, n) int64 c-bit digits."""
    s = scalars.to(torch.int64)
    n_l = s.shape[0]
    zero = torch.zeros_like(s[0])
    out = []
    for w in range(n_windows):
        lo = w * c
        li, sh = divmod(lo, LIMB_BITS)
        d = zero.clone()
        for k in range(3):  # c <= 16 spans at most three limbs
            if li + k < n_l:
                part = s[li + k] << (LIMB_BITS * k)
                d = d | (part >> sh)
        out.append(d & ((1 << c) - 1))
    return torch.stack(out)


def _chunk_len(n_entries: int) -> int:
    """Entries per fold chunk, as the reference picks r (msm.py:277-280):
    32, halved while that leaves fewer than 8 chunks."""
    r = 32
    while r > 1 and -(-n_entries // r) < 8:
        r //= 2
    return r


def fold_inputs(curve: CurveSpec, jobs, window_bits: Optional[int] = None, n_bits: Optional[int] = None):
    """Steps 1-2 of `msm_sets`: (normalized points, sorted keys and point
    indices padded to a multiple of r with the dump key S W 2^c, r, c, W)."""
    F = jac.field_ops(curve)
    dev = jobs[0][0].device
    total_bits = n_bits or curve.scalar.bits
    c = window_bits or default_window_bits(max(1, max(s.shape[1] for s, _ in jobs)), total_bits)
    W = -(-total_bits // c)

    pts = jac.normalize(curve, jac.concat([p for _, p in jobs]))
    live = ~F.is_zero(pts.z)
    keys, pidx = [], []
    off = 0
    for s, (scalars, _) in enumerate(jobs):
        n = scalars.shape[1]
        digits = _digits(scalars, c, W)  # (W, n)
        grp = torch.arange(s * W, (s + 1) * W, device=dev).reshape(W, 1)
        idx = torch.arange(off, off + n, device=dev).expand(W, n)
        sel = (digits != 0) & live[off : off + n]
        keys.append(((grp << c) + digits)[sel])
        pidx.append(idx[sel])
        off += n
    keys, order = torch.sort(torch.cat(keys))
    pidx = torch.cat(pidx)[order]
    r = _chunk_len(keys.shape[0])
    pad = -keys.shape[0] % r
    keys = torch.cat([keys, keys.new_full((pad,), len(jobs) * W << c)])
    pidx = torch.cat([pidx, pidx.new_zeros(pad)])
    return pts, keys, pidx, r, c, W


def _bucket_totals(curve: CurveSpec, pts: JPoint, keys, pidx, r: int, n_buckets: int) -> JPoint:
    """Step 3: the (n_buckets,) bucket sums of the sorted, padded entries."""
    dev = keys.device
    if keys.shape[0] == 0:
        return jac.identity(curve, (n_buckets,), dev)
    totals, tflag, bv, bflag, bchunk = ec_kernel.fold_madd(curve, pts, keys, pidx, r, n_buckets + 1)
    excl = ec_kernel.lifted_scan(curve, totals, tflag)
    offsets = JPoint(*(v[..., bchunk] for v in excl))
    # lifted: a bucket whose segment started in its tail's chunk is complete
    total = jac.select(bflag, JPoint(*bv), jac.add(curve, offsets, JPoint(*bv)))
    return JPoint(*(v[..., :n_buckets] for v in total))


def _tree_sum(curve: CurveSpec, P: JPoint) -> JPoint:
    """Sum over the last axis (a power of two) by pairwise halving."""
    while P.z.shape[-1] > 1:
        h = P.z.shape[-1] // 2
        P = jac.add(curve, JPoint(*(v[..., :h] for v in P)), JPoint(*(v[..., h:] for v in P)))
    return JPoint(*(v[..., 0] for v in P))


def _weighted_sums(curve: CurveSpec, buckets: JPoint, c: int) -> JPoint:
    """buckets (..., G, 2^c) -> (..., G): sum_d d B_d = sum_k 2^k T_k with
    T_k the sum of the buckets whose digit has bit k set."""
    d = np.arange(1 << c)
    idx = np.stack([d[(d >> k) & 1 == 1] for k in range(c)])  # (c, 2^(c-1))
    idx_t = torch.as_tensor(idx, device=buckets.z.device)
    T = _tree_sum(curve, jac.take(buckets, idx_t))  # (..., G, c)
    acc = JPoint(*(v[..., c - 1] for v in T))
    for k in range(c - 2, -1, -1):
        acc = jac.add(curve, jac.double(curve, acc), JPoint(*(v[..., k] for v in T)))
    return acc


def msm_sets(
    curve: CurveSpec,
    jobs,
    window_bits: Optional[int] = None,
    n_bits: Optional[int] = None,
) -> JPoint:
    """Several MSMs in one bucket pipeline: jobs is a list of
    (scalars (n_limbs, n_s) canonical limbs, points JPoint with batch
    (n_s,)). Returns a JPoint with batch (len(jobs),): one sort, one set of
    kernel launches and one Horner chain serve every job."""
    F = jac.field_ops(curve)
    S = len(jobs)
    pts, keys, pidx, r, c, W = fold_inputs(curve, jobs, window_bits, n_bits)
    dense = _bucket_totals(curve, pts, keys, pidx, r, S * W << c)
    head = tuple(dense.z.shape[: F.value_ndim])
    buckets = JPoint(*(v.reshape(head + (S * W, 1 << c)) for v in dense))
    win = _weighted_sums(curve, buckets, c)  # (..., S W)
    win = JPoint(*(v.reshape(head + (S, W)) for v in win))

    acc = JPoint(*(v[..., W - 1] for v in win))
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = jac.double(curve, acc)
        acc = jac.add(curve, acc, JPoint(*(v[..., w] for v in win)))
    return acc


def msm(curve, scalars, points: JPoint, window_bits=None, n_bits=None) -> JPoint:
    """sum_i scalars[i] * points[i]; scalars (n_limbs, N) canonical limbs,
    points a JPoint with batch (N,). Returns a single point."""
    out = msm_sets(curve, [(scalars, points)], window_bits, n_bits)
    return JPoint(*(v[..., 0] for v in out))


def msm_multi(curve, scalars, points_list, window_bits=None, n_bits=None):
    """One MSM per point set against shared scalars. Returns a list of
    single points."""
    out = msm_sets(curve, [(scalars, p) for p in points_list], window_bits, n_bits)
    return [JPoint(*(v[..., s] for v in out)) for s in range(len(points_list))]


# ---------------------------------------------------------------------------
# fixed-base MSM (Groth16 setup query encodings)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _fixed_base_table(curve: CurveSpec, c: int, n_bits: int, device: torch.device) -> JPoint:
    """T[w 2^c + d] = d 2^(c w) G, affine (Z in {0, 1}), batch
    (windows 2^c,). Built once on the host from the affine oracle."""
    from ..ref import curve as refc

    windows = -(-n_bits // c)
    flat = []
    base = refc.generator(curve)
    for w in range(windows):
        acc = None
        flat.append(None)  # d = 0
        for _ in range(1, 1 << c):
            acc = refc.add(curve, acc, base)
            flat.append(acc)
        if w + 1 < windows:
            for _ in range(c):
                base = refc.add(curve, base, base)
    return jac.from_affine_ints(curve, flat, device)


def _fixed_base_eval(curve: CurveSpec, scalars, table: JPoint, c: int, n_bits: int) -> JPoint:
    """acc = sum_w T[w, digit_w]: one mixed add per window."""
    n = scalars.shape[1]
    W = -(-n_bits // c)
    digits = _digits(scalars, c, W)
    acc = jac.identity(curve, (n,), scalars.device)
    for w in range(W):
        acc = jac.madd(curve, acc, jac.take(table, digits[w] + (w << c)))
    return acc


def fixed_base_msm(curve, scalars, window_bits: int = 8, n_bits: Optional[int] = None) -> JPoint:
    """[k_i G] for the generator G; scalars (n_limbs, N) canonical."""
    nb = n_bits or curve.scalar.bits
    table = _fixed_base_table(curve, window_bits, nb, scalars.device)
    return _fixed_base_eval(curve, scalars, table, window_bits, nb)
