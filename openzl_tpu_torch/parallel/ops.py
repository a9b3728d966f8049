"""Sharded kernels: Poseidon, MSM and NTT over a mesh of ranks.

Port of `openzl_tpu/parallel/ops.py`. Every function takes the reference's
global arguments on every rank; each rank takes its own shard (what the
reference's `device_put(NamedSharding(...))` does), runs the single-device
code of the port on its device (the kernels K1-K9 through their wrappers),
and meets the other ranks in the mesh's collectives. Each returns the
replicated result on every rank, on the rank's device.

  * Poseidon hash batches shard data-parallel: no collective, the digests
    gathered at the end;
  * MSM points shard per rank: each rank runs the whole bucket pipeline on
    its points, then the partial sums are all-gathered and added in a
    log2 tree (a sequential fold in rank order on a mesh that is not a
    power of two);
  * the NTT is a four-step transform of N = R C with R the mesh size,
    whose only exchange between ranks is one all-to-all between two
    batches of local sub-transforms.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..curves import jacobian as jac
from ..curves.jacobian import JPoint
from ..curves.spec import CurveSpec
from ..fields import limb
from ..fields.spec import FieldSpec
from ..ops import msm as msmmod
from ..ops import ntt as nttmod
from .mesh import Mesh


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def _local(x) -> torch.Tensor:
    """A global argument as a tensor: numpy limbs are lifted onto the host,
    and a rank copies only its shard onto its device."""
    return x if isinstance(x, torch.Tensor) else limb.tensor(x)


def sharded_poseidon_hash(perm, mesh: Mesh, inputs, axis: str = "data") -> torch.Tensor:
    """Batched Poseidon hash with the batch axis sharded over `mesh`.

    inputs: (n_limbs, arity, batch) Montgomery limbs, batch divisible by
    the mesh size. Each rank hashes its slice of the batch (K5 or K6 on
    the card) with no collective; the digests (n_limbs, batch) are
    gathered at the end."""
    _check_axis(mesh, axis)
    x = _local(inputs)
    b = x.shape[2]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not split over {mesh.size} ranks")
    m = b // mesh.size
    out = perm.hash(x[:, :, mesh.rank * m : (mesh.rank + 1) * m].to(mesh.device).contiguous())
    g = mesh.all_gather(out)  # (n_limbs, m, size)
    return g.movedim(-1, 1).reshape(out.shape[0], b)


def _pad_msm_inputs(curve: CurveSpec, scalars: torch.Tensor, points_list, pad: int):
    """Append `pad` zero scalars times identity points (doubly inert: zero
    digits make no bucket entry, and the identity is dropped as a live
    point). The reference pads the global arrays up to a multiple of the
    mesh size; here each rank pads its own shard up to its share."""
    if pad == 0:
        return scalars, points_list
    scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0], pad))], dim=1)
    ident = jac.identity(curve, (pad,), scalars.device)
    return scalars, [jac.concat([p, ident]) for p in points_list]


def _msm_shard(curve: CurveSpec, mesh: Mesh, scalars, points_list):
    """This rank's share of N padded to a multiple of the mesh size (the
    reference pads the global arrays, then shards them): entries
    [rank m, rank m + m) with m = ceil(N / size), padded with identities
    where they run past N (a rank whose share lies wholly past N gets m
    of them). Only the shard is copied, onto the rank's device."""
    scalars = _local(scalars)
    n = scalars.shape[1]
    m = -(-n // mesh.size)
    lo, hi = min(n, mesh.rank * m), min(n, (mesh.rank + 1) * m)
    scal = scalars[:, lo:hi].to(mesh.device)
    pts = [JPoint(*(v[..., lo:hi].to(mesh.device) for v in p)) for p in points_list]
    scal, pts = _pad_msm_inputs(curve, scal, pts, m - (hi - lo))
    return scal.contiguous(), pts


def _reduce_partials(curve: CurveSpec, part: JPoint, mesh: Mesh) -> JPoint:
    """All-gather the per-rank partial MSMs and add them in a log2 tree
    (K3). The rank axis is gathered onto the trailing (batch) axis, so the
    limb layout `jac.add` expects (value dims leading) stays."""
    n_dev = mesh.size
    gathered = [mesh.all_gather(v) for v in part]  # (n_limbs[, 2], *batch, n_dev)
    if n_dev & (n_dev - 1):  # not a power of two: sequential fold in rank order
        acc = JPoint(*(v[..., 0] for v in gathered))
        for i in range(1, n_dev):
            acc = jac.add(curve, acc, JPoint(*(v[..., i] for v in gathered)))
        return acc
    live, cur = n_dev, gathered
    while live > 1:
        half = live // 2
        a = JPoint(*(v[..., :half] for v in cur))
        b = JPoint(*(v[..., half:live] for v in cur))
        cur = list(jac.add(curve, a, b))
        live = half
    return JPoint(*(v[..., 0] for v in cur))


def sharded_msm(
    curve: CurveSpec,
    mesh: Mesh,
    scalars,
    points: JPoint,
    window_bits: Optional[int] = None,
    n_bits: Optional[int] = None,
    axis: str = "data",
) -> JPoint:
    """MSM with the points and scalars sharded per rank.

    scalars (n_limbs, N) canonical limbs, points a JPoint with batch (N,).
    Each rank runs the whole bucket pipeline (`ops.msm.msm`) on its shard,
    then the partials are combined with log2(size) additions after one
    all-gather. N is padded to a multiple of the mesh size (zero scalars
    times identities)."""
    _check_axis(mesh, axis)
    scal, (pts,) = _msm_shard(curve, mesh, scalars, [points])
    part = msmmod.msm(curve, scal, pts, window_bits, n_bits)
    return _reduce_partials(curve, part, mesh)


def sharded_msm_multi(
    curve: CurveSpec,
    mesh: Mesh,
    scalars,
    points_list,
    window_bits: Optional[int] = None,
    n_bits: Optional[int] = None,
    axis: str = "data",
):
    """Shared-scalar multi-set MSM (`ops.msm.msm_multi`) with the point axis
    sharded per rank: each rank runs the multi-set pipeline (one sort, one
    Horner chain) on its shard, then the (S,)-batched partials are reduced
    after one all-gather: the mesh form of the Groth16 prover's a/b1/l
    MSMs. Returns a list of single points, one per set (replicated)."""
    _check_axis(mesh, axis)
    scal, sets = _msm_shard(curve, mesh, scalars, points_list)
    outs = msmmod.msm_multi(curve, scal, sets, window_bits, n_bits)
    part = JPoint(*(torch.stack([getattr(o, f) for o in outs], dim=-1) for f in ("x", "y", "z")))
    out = _reduce_partials(curve, part, mesh)
    return [JPoint(*(v[..., s] for v in out)) for s in range(len(points_list))]


@functools.lru_cache(maxsize=32)
def _transform_tables(
    spec: FieldSpec, log_n: int, n_dev: int, rank: int, inverse: bool, coset: bool, device: torch.device
):
    """This rank's (twiddle, pre, post) for the sharded four-step transform,
    as Montgomery limbs built on `device` (`limb.geom_series_mont`): row
    i = rank of tw[i, j] = w^(i j) (w inverted for the iNTT) and of
    pre[i, j] = g^(j R + i) (the forward coset's input scale), each
    (n_limbs, C); and columns [rank C / R, (rank + 1) C / R) of
    post[i', j'] = g^-(i' C + j') (the inverse coset's output scale),
    (n_limbs, R, C / R). The reference builds the whole matrices on the
    host and shards them."""
    n = 1 << log_n
    R, C = n_dev, n // n_dev
    p = spec.modulus
    w = nttmod.group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, p)
    tw = limb.geom_series_mont(spec, 1, pow(w, rank, p), C, device)
    pre = post = None
    if coset:
        g = nttmod.GENERATORS[spec.name]
        if inverse:
            gi, cols = pow(g, -1, p), C // R
            post = torch.stack([limb.geom_series_mont(spec, pow(gi, i * C + rank * cols, p), gi, cols, device)
                                for i in range(R)], dim=1)
        else:
            pre = limb.geom_series_mont(spec, pow(g, rank, p), pow(g, R, p), C, device)
    return tw, pre, post


def sharded_transform(
    spec: FieldSpec,
    mesh: Mesh,
    coeffs,
    inverse: bool = False,
    coset: bool = False,
    axis: str = "data",
) -> torch.Tensor:
    """Four-step (Bailey) NTT of size N = R C sharded over `mesh`, R the
    mesh size (a power of two dividing N).

    With the input matrix X[i, j] = a[j R + i], rank i holds row i and
      1. runs the length-C NTT along j                          (local)
      2. twiddles it by w^(i j)                                 (local)
      3. the global transpose: one all-to-all
      4. runs length-R NTTs along i, batched over its C / R columns (local)
    Output A[i' C + j'] = Z[i', j']: natural order, bit-exact with
    `ops.ntt.ntt`. The sub-transforms are the port's own `ntt` / `intt`
    (K2 from 2^13 points, K8 below), the twiddle and coset scales K1
    products; the sub-iNTTs' 1/C and 1/R compose to the iNTT's 1/N.

    coset: evaluate on g H (forward: a_m pre-scaled by g^m) or
    interpolate from g H (inverse: post-scaled by g^-m), bit-exact with
    `ops.ntt.coset_ntt` / `coset_intt`. coeffs: (n_limbs, N) Montgomery
    limbs; returns (n_limbs, N) on every rank."""
    _check_axis(mesh, axis)
    x = _local(coeffs)
    n_dev, n = mesh.size, x.shape[1]
    if n & (n - 1) or n_dev & (n_dev - 1) or n % n_dev:
        raise ValueError(f"a sharded transform of {n} points needs a power-of-two mesh dividing it, not {n_dev}")
    tw, pre, post = _transform_tables(spec, n.bit_length() - 1, n_dev, mesh.rank, inverse, coset, mesh.device)
    sub = nttmod.intt if inverse else nttmod.ntt
    row = x[:, mesh.rank :: n_dev].to(mesh.device).contiguous()  # X[rank, j] = a[j R + rank]
    if pre is not None:
        row = limb.mont_mul(spec, row, pre)
    y = limb.mont_mul(spec, sub(spec, row), tw)  # C-point NTT along j, twiddled
    # transpose: split the columns, gather the rows -> (n_limbs, R, C / R)
    y = mesh.all_to_all(y.unsqueeze(1), split_axis=2, concat_axis=1)
    y = sub(spec, y.contiguous())  # R-point NTTs along i
    if post is not None:
        y = limb.mont_mul(spec, y, post)
    z = mesh.all_gather(y)  # (n_limbs, R, C / R, R): rank k holds columns k C / R ..
    return z.movedim(-1, 2).reshape(spec.n_limbs, n)


def sharded_ntt(spec: FieldSpec, mesh: Mesh, coeffs, axis: str = "data") -> torch.Tensor:
    return sharded_transform(spec, mesh, coeffs, axis=axis)


def sharded_intt(spec: FieldSpec, mesh: Mesh, evals, axis: str = "data") -> torch.Tensor:
    return sharded_transform(spec, mesh, evals, inverse=True, axis=axis)


def sharded_coset_ntt(spec: FieldSpec, mesh: Mesh, coeffs, axis: str = "data") -> torch.Tensor:
    return sharded_transform(spec, mesh, coeffs, coset=True, axis=axis)


def sharded_coset_intt(spec: FieldSpec, mesh: Mesh, evals, axis: str = "data") -> torch.Tensor:
    return sharded_transform(spec, mesh, evals, inverse=True, coset=True, axis=axis)
