"""Inclusive and segmented scans over a combine function.

Port of `openzl_tpu/ops/scan_utils.py`, written as plain torch log-step
(Hillis-Steele) scans: ceil(log2 N) full-width combines, each one batched
call of the combine function (which may launch a kernel), N log2 N
combines of work. The MSM's scan of its chunk totals, where that work is
what costs on the card, runs the reference's work-efficient chunked shape
instead, as K3's scan variant (`ops/ec_kernel.lifted_scan`); this module
serves the prefix products of `curves/jacobian.batch_inv`.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def inclusive_scan(combine: Callable, xs: Tuple, pad: Callable[[int], Tuple]):
    """Inclusive scan over the last axis of every leaf of `xs`.

    combine(a, b): b is the later operand; must be associative.
    pad(k): identity-element leaves of batch length k.
    """
    n = xs[0].shape[-1]
    d = 1
    while d < n:
        earlier = tuple(
            torch.cat([p, x[..., : n - d]], dim=-1) for x, p in zip(xs, pad(d))
        )
        xs = tuple(combine(earlier, xs))
        d *= 2
    return xs


def segmented_scan(
    combine_values: Callable,
    values: Tuple,
    starts: torch.Tensor,
    pad: Callable[[int], Tuple],
):
    """Segmented inclusive scan, restarting at every True in `starts`.

    The standard lift: carry (value, flag); combine keeps b once b's segment
    has started. Returns the scanned values."""

    def seg_combine(a, b):
        va, fa = a[:-1], a[-1]
        vb, fb = b[:-1], b[-1]
        merged = combine_values(va, vb)
        out = tuple(
            torch.where(fb.reshape((1,) * (m.ndim - fb.ndim) + tuple(fb.shape)), bb, m)
            for m, bb in zip(merged, vb)
        )
        return (*out, fa | fb)

    def seg_pad(k):
        return (*pad(k), torch.zeros(starts.shape[:-1] + (k,), dtype=torch.bool, device=starts.device))

    out = inclusive_scan(seg_combine, (*values, starts), seg_pad)
    return out[:-1]
