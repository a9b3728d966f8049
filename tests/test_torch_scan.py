"""K3's lifted scan variant (`ec_kernel.lifted_scan`, the MSM's scan of the
fold's chunk totals) through its plain version, against the JAX package's
scan, the Python oracle and the scan it replaced.

  * against the reference's chunked `inclusive_scan` with its `lifted`
    combine (openzl_tpu/ops/msm.py:352-360) on the 2-limb toy curve, at a
    length that takes the reference's three-phase path (l = 1024, chunks of
    4, then Hillis-Steele over 256 lanes), with the port's chunks of
    `SCAN_R` throughout and with its default Hillis-Steele levels:
    affine-equal, since the two associate the sums differently, so the
    Jacobian limbs differ;
  * against per-segment sums of `openzl_tpu.ref.curve` over BN254 G1 and
    G2 at the chunk edge sizes l = 1, 3, R - 1, R, R + 1, 5 R + 3, with no,
    all and random flags, through chunks (`SCAN_NARROW` set to 0) and
    through Hillis-Steele steps (the default `SCAN_NARROW`): the same group
    elements (tolerance 0, checked as X = x Z^2 and Y = y Z^3);
  * `msm._bucket_totals` against its former Hillis-Steele scan through K3
    (`tools/kernel_probe.py` `hillis_steele_scan`): the same buckets;
  * the wrapper's launch path, level by level, through a stand-in library
    whose entry point runs the plain phases on the buffers it is handed:
    bit-equal to the plain version, with one counted launch per phase.

Inputs come from seeded numpy generators."""

import collections
import ctypes
import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.curves import jacobian as ref_jac
from openzl_tpu.curves.spec import BN254_G1, BN254_G2, toy_curve
from openzl_tpu.ops import scan_utils as ref_scan
from openzl_tpu.ref import curve as ref
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.ops import ec_kernel, msm
from openzl_tpu_torch.tools.kernel_probe import hillis_steele_scan
from openzl_tpu_torch.utils import build

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

R = ec_kernel.SCAN_R


@functools.lru_cache(maxsize=None)
def _pool(curve):
    """Affine points 2 P_0 .. 2 P_9, the identity and -2 P_0, and the same
    as Jacobian limbs with Z != 1 (the doubling of the affine P_i)."""
    rng = np.random.default_rng(7)
    G = ref.generator(curve)
    small = curve.name.startswith("toy")
    base = [ref.scalar_mul(curve, int(k), G) for k in rng.integers(1, 1 << 12 if small else 1 << 62, 10)]
    aff = [ref.add(curve, b, b) for b in base] + [None, ref.neg(curve, ref.add(curve, base[0], base[0]))]
    halves = base + [None, ref.neg(curve, base[0])]
    return aff, jac.double(curve, jac.from_affine_ints(curve, halves))


def _inputs(curve, l, mode, seed):
    """(affine points, Jacobian totals, flags) of length l from the pool."""
    rng = np.random.default_rng(seed)
    aff, pool = _pool(curve)
    idx = rng.integers(0, len(aff), l)
    flags = {"none": np.zeros(l, bool), "all": np.ones(l, bool), "random": rng.random(l) < 0.3}[mode]
    return [aff[i] for i in idx], jac.take(pool, torch.as_tensor(idx)), torch.as_tensor(flags)


def _exclusive_sums(curve, pts, flags):
    """The oracle: element i gets the sum of elements s .. i - 1, where s is
    the last flagged element before i (0 where none is)."""
    out, acc = [], None
    for p, f in zip(pts, flags.tolist()):
        out.append(acc)
        acc = p if f else ref.add(curve, acc, p)
    return out


def _assert_points(curve, got, want):
    """Jacobian (X, Y, Z) against affine points (None: the identity): X = x
    Z^2 and Y = y Z^3 where Z != 0."""
    F = jac.field_ops(curve)
    X, Y, Z = got
    inf = F.is_zero(Z)
    assert inf.tolist() == [w is None for w in want]
    live = [i for i, w in enumerate(want) if w is not None]
    if not live:
        return
    idx = torch.tensor(live)
    xs = F.from_ints(np.array([want[i][0] for i in live], dtype=object))
    ys = F.from_ints(np.array([want[i][1] for i in live], dtype=object))
    z = Z[..., idx]
    z2 = F.sqr(z)
    assert bool(F.eq(X[..., idx], F.mul(xs, z2)).all())
    assert bool(F.eq(Y[..., idx], F.mul(ys, F.mul(z2, z))).all())


def test_lifted_scan_plain_matches_reference_scan(monkeypatch):
    """l = 1024 on the toy curve: the reference picks chunks of 4 (256
    lanes) and Hillis-Steele over the 256 chunk totals; shifted by one, its
    inclusive scan is the port's exclusive one, as affine points."""
    curve = toy_curve()
    pts, P, flags = _inputs(curve, 1024, "random", 11)
    steps = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
    monkeypatch.setattr(ec_kernel, "SCAN_NARROW", 0)
    chunks = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
    F = ref_jac.field_ops(curve)

    def lifted(a, b):  # openzl_tpu/ops/msm.py:352-360
        merged = ref_jac.add(curve, ref_jac.JPoint(*a[:3]), ref_jac.JPoint(*b[:3]))
        return (*ref_jac.select(b[3], ref_jac.JPoint(*b[:3]), merged, F), a[3] | b[3])

    def lifted_pad(k):
        return (*ref_jac.identity(curve, (k,)), jnp.zeros((k,), bool))

    xs = tuple(jnp.asarray(v.numpy().astype(np.uint32)) for v in P) + (jnp.asarray(flags.numpy()),)
    incl = ref_scan.inclusive_scan(lifted, xs, lifted_pad)
    want = jac.to_affine_ints(curve, jac.JPoint(*(torch.from_numpy(np.asarray(v).astype(np.int32)) for v in incl[:3])))
    assert jac.to_affine_ints(curve, jac.JPoint(*chunks)) == [None] + want[:-1]
    assert jac.to_affine_ints(curve, jac.JPoint(*steps)) == [None] + want[:-1]
    assert want[:-1] == _exclusive_sums(curve, pts, flags)[1:]


@pytest.mark.parametrize("narrow", [0, ec_kernel.SCAN_NARROW], ids=["chunks", "steps"])
@pytest.mark.parametrize("mode", ["none", "all", "random"])
@pytest.mark.parametrize("l", sorted({1, 3, R - 1, R, R + 1, 5 * R + 3}))
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_lifted_scan_plain_matches_oracle_sums(curve, l, mode, narrow, monkeypatch):
    pts, P, flags = _inputs(curve, l, mode, l)
    monkeypatch.setattr(ec_kernel, "SCAN_NARROW", narrow)
    got = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
    _assert_points(curve, got, _exclusive_sums(curve, pts, flags))


def _bucket_totals_hillis_steele(curve, pts, keys, pidx, r, n_buckets):
    """`msm._bucket_totals` as it was before K3's scan variant: the chunk
    totals' exclusive offsets from a Hillis-Steele scan through K3."""
    dev = keys.device
    totals, tflag, bv, bflag, bchunk = ec_kernel.fold_madd(curve, pts, keys, pidx, r, n_buckets + 1)
    excl = hillis_steele_scan(curve, totals, tflag)
    merged = jac.add(curve, jac.JPoint(*(v[..., bchunk] for v in excl)), jac.JPoint(*bv))
    total = jac.select(bflag, jac.JPoint(*bv), merged)
    return jac.JPoint(*(v[..., :n_buckets] for v in total))


@pytest.mark.parametrize("r", [1, 4, 16])
def test_bucket_totals_match_hillis_steele_scan(r):
    """Runs of 0 to 40 sorted entries over 24 toy-curve buckets (segments
    across many chunks, so the scan's offsets carry), with a point and its
    negation: the same affine buckets as the former scan."""
    curve = toy_curve()
    rng = np.random.default_rng(30 + r)
    aff, _ = _pool(curve)
    live = [p for p in aff if p is not None]
    n_buckets = 24
    keys = [k for k in range(n_buckets) for _ in range(int(rng.choice([0, 1, 3, 9, 17, 40])))]
    pidx = [int(i) for i in rng.integers(0, len(live), len(keys))]
    pad = -len(keys) % r
    keys, pidx = torch.tensor(keys + [n_buckets] * pad), torch.tensor(pidx + [0] * pad)
    P = jac.normalize(curve, jac.from_affine_ints(curve, live))
    got = msm._bucket_totals(curve, P, keys, pidx, r, n_buckets)
    want = _bucket_totals_hillis_steele(curve, P, keys, pidx, r, n_buckets)
    assert jac.to_affine_ints(curve, got) == jac.to_affine_ints(curve, want)


def _view(ptr: int, shape, ctype=ctypes.c_int32) -> np.ndarray:
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class _PlainScanLib:
    """Stands in for the kernel library: `ozl_ec_lifted_scan` runs the plain
    phase (or Hillis-Steele step) on the buffers it is handed, and records
    (phase, n)."""

    def __init__(self, curve):
        self.curve, self.calls = curve, []

    def ozl_ec_lifted_scan(self, phase, ext, ax, ay, az, af, bx, by, bz, bf, cx, cy, cz, cf, n, d, *rest):
        self.calls.append((phase, n))
        head = (self.curve.base.n_limbs,) + ((2,) if ext == 2 else ())
        m = -(-n // R)

        def coords(ptrs, k):
            return [_view(p, head + (k,)) for p in ptrs]

        def t(arrs):
            return tuple(torch.from_numpy(a.copy()) for a in arrs)

        def flags(p, k):
            return _view(p, (k,), ctypes.c_uint8)

        if phase == 2:
            out = ec_kernel.scan_step_plain(self.curve, t(coords((ax, ay, az), n)),
                                            torch.from_numpy(flags(af, n).astype(bool)), d)
            for dst, src in zip(coords((bx, by, bz), n), out[0]):
                dst[...] = src.numpy()
            flags(bf, n)[...] = out[1].numpy()
        elif phase == 1:
            out = ec_kernel.scan_fold_plain(self.curve, t(coords((ax, ay, az), n)),
                                            torch.from_numpy(flags(af, n).astype(bool)))
            for dst, src in zip(coords((bx, by, bz), n) + coords((cx, cy, cz), m), out[0] + out[2]):
                dst[...] = src.numpy()
            flags(bf, n)[...] = out[1].numpy()
            flags(cf, m)[...] = out[3].numpy()
        else:
            out = ec_kernel.scan_offsets_plain(self.curve, t(coords((ax, ay, az), m)), t(coords((bx, by, bz), n)),
                                               torch.from_numpy(flags(bf, n).astype(bool)))
            for dst, src in zip(coords((bx, by, bz), n), out):
                dst[...] = src.numpy()
        return 0


def _launches(n, narrow):
    """The (phase, n) launches of a lifted scan of n elements: ceil(log2 n)
    Hillis-Steele steps for a narrow level of 2 or more, else a fold, the
    chunk totals' scan and an offset launch (none past a single chunk)."""
    if 2 <= n <= narrow:
        return [(2, n)] * (n - 1).bit_length()
    m = -(-n // R)
    return [(1, n)] + (_launches(m, narrow) + [(3, n)] if m > 1 else [])


@pytest.mark.parametrize("narrow", [0, 2 * R], ids=["chunks", "steps"])
@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_lifted_scan_launch_path_matches_plain(curve, narrow, monkeypatch):
    """l = 5 R^2 + 3: levels of chunks down to a single chunk, or down to a
    narrow level of Hillis-Steele steps; each launch counted with its
    width; the plain version's limbs."""
    l = 5 * R * R + 3
    _, P, flags = _inputs(curve, l, "random", 5)
    monkeypatch.setattr(ec_kernel, "SCAN_NARROW", narrow)
    want = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
    fake = _PlainScanLib(curve)
    monkeypatch.setattr(ec_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(ec_kernel.K3S, "launches", 0)
    monkeypatch.setattr(ec_kernel.K3S, "by_width", {})
    got = ec_kernel.lifted_scan(curve, tuple(P), flags)
    calls = _launches(l, narrow)
    assert {p for p, _ in calls} == ({1, 3} if narrow == 0 else {1, 2, 3})
    assert fake.calls == calls
    assert ec_kernel.K3S.launches == len(calls)
    assert ec_kernel.K3S.by_width == dict(collections.Counter(1 << (w - 1).bit_length() for _, w in calls))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
