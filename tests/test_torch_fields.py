"""The port's limb arithmetic and kernel K1's plain version against the JAX
package (`openzl_tpu.fields.limb`, and `ntt_kernel.mont_mul` /
`mont_scale` in Pallas interpret mode). Every comparison is exact integer
equality of the limb arrays (tolerance 0)."""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.curves.spec import toy_curve
from openzl_tpu.fields import ext as ref_ext
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BLS12_377_FQ, BLS12_381_FQ, BN254_FQ, BN254_FR
from openzl_tpu.ops import ntt_kernel as ref_ntt_kernel
from openzl_tpu_torch.fields import ext, limb
from openzl_tpu_torch.ops import ntt_kernel

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


SPECS = [BN254_FR, BN254_FQ, BLS12_381_FQ]


def _vals(spec, n, seed):
    rng = random.Random(seed)
    p = spec.modulus
    return [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n - 4)]


def _pair(spec, n, seed):
    """Canonical limbs (host uint32) of two value lists; b is a rotation of
    a's edge values so 0, 1 and p-1 meet each other."""
    a = _vals(spec, n, seed)
    b = a[1:] + a[:1]
    return ref_limb.pack(spec, a), ref_limb.pack(spec, b)


def _eq(port, ref):
    assert np.array_equal(port.cpu().numpy().astype(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_ring_ops_match_reference(spec):
    a, b = _pair(spec, 40, 1)
    ta, tb = limb.tensor(a), limb.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(limb.add(spec, ta, tb), ref_limb.add(spec, ja, jb))
    _eq(limb.sub(spec, ta, tb), ref_limb.sub(spec, ja, jb))
    _eq(limb.neg(spec, ta), ref_limb.neg(spec, ja))
    _eq(limb.double(spec, ta), ref_limb.double(spec, ja))
    assert np.array_equal(limb.is_zero(ta).numpy(), np.asarray(ref_limb.is_zero(ja)))
    assert np.array_equal(limb.eq(ta, tb).numpy(), np.asarray(ref_limb.eq(ja, jb)))
    mask = np.arange(40) % 3 == 0
    _eq(limb.select(torch.as_tensor(mask), ta, tb), ref_limb.select(jnp.asarray(mask), ja, jb))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_montgomery_ops_match_reference(spec):
    a, b = _pair(spec, 40, 2)
    ta, tb = limb.tensor(a), limb.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(limb.mont_mul(spec, ta, tb), ref_limb.mont_mul(spec, ja, jb))
    _eq(limb.mont_sqr(spec, ta), ref_limb.mont_sqr(spec, ja))
    _eq(limb.to_mont(spec, ta), ref_limb.to_mont(spec, ja))
    _eq(limb.from_mont(spec, ta), ref_limb.from_mont(spec, ja))
    # broadcast single-element operand (the scale path)
    _eq(limb.mont_mul(spec, ta, tb[:, 5:6]), ref_limb.mont_mul(spec, ja, jb[:, 5:6]))
    _eq(limb.mont_pow(spec, ta[:, :6], 0x1F3), ref_limb.mont_pow(spec, ja[:, :6], 0x1F3))
    _eq(limb.mont_inv(spec, ta[:, :4]), ref_limb.mont_inv(spec, ja[:, :4]))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_packing_matches_reference(spec):
    vals = np.array(_vals(spec, 20, 3), dtype=object).reshape(4, 5)
    assert np.array_equal(limb.pack(spec, vals), ref_limb.pack(spec, vals))
    assert np.array_equal(limb.pack_mont(spec, vals), ref_limb.pack_mont(spec, vals))
    packed = limb.tensor(ref_limb.pack_mont(spec, vals))
    assert (limb.unpack_mont(spec, packed) == vals).all()
    assert (limb.unpack(spec, limb.tensor(ref_limb.pack(spec, vals))) == vals).all()


def test_k1_plain_matches_pallas_interpret(n=33):
    """Plain K1 against the Pallas mul/scale kernels in interpret mode, as
    tests/test_ntt_kernel.py runs them (toy 31-bit field)."""
    spec = toy_curve().base
    a, b = _pair(spec, n, 4)
    ma, mb = ref_limb.to_mont(spec, jnp.asarray(a)), ref_limb.to_mont(spec, jnp.asarray(b))
    want = ref_ntt_kernel.mont_mul(spec, ma, mb, interpret=True)
    _eq(ntt_kernel.mont_mul(spec, limb.tensor(np.asarray(ma)), limb.tensor(np.asarray(mb))), want)
    want = ref_ntt_kernel.mont_scale(spec, ma, mb[:, 7], interpret=True)
    _eq(ntt_kernel.mont_scale(spec, limb.tensor(np.asarray(ma)), limb.tensor(np.asarray(mb[:, 7]))), want)


@pytest.mark.parametrize("spec,beta", [(BN254_FQ, -1), (BLS12_377_FQ, -5)], ids=["bn254", "bls12_377"])
def test_fq2_ops_match_reference(spec, beta):
    rng = random.Random(6)
    pairs = np.array(
        [[rng.randrange(spec.modulus), rng.randrange(spec.modulus)] for _ in range(6)] + [[0, 1], [1, 0]],
        dtype=object,
    )
    F, R = ext.fq2_ops(spec, beta), ref_ext.fq2_ops(spec, beta)
    x = F.from_ints(pairs)
    y = F.from_ints(pairs[::-1].copy())
    jx, jy = R.from_ints(pairs), R.from_ints(pairs[::-1].copy())
    _eq(x, jx)
    _eq(F.mul(x, y), R.mul(jnp.asarray(jx), jnp.asarray(jy)))
    _eq(F.sqr(x), R.sqr(jnp.asarray(jx)))
    _eq(F.inv(x[..., :3]), R.inv(jnp.asarray(jx)[..., :3]))
    assert (F.to_ints(x) == pairs).all()


def test_cpu_tensors_run_plain_and_other_devices_raise():
    spec = BN254_FR
    a = limb.tensor(ref_limb.pack(spec, [3, 4]))
    assert ntt_kernel.device_kind(a) == "cpu"
    with pytest.raises(ValueError):
        ntt_kernel.mont_mul(spec, a.to("meta"), a.to("meta"))



@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FQ], ids=lambda s: s.name)
def test_geom_series_matches_reference_packing(spec):
    """start base^i, i < count, built by doubling with K1 products, equals
    the reference's Montgomery packing of the same powers (count not a power
    of two, as for the h query's n - 1)."""
    rng = random.Random(21)
    p = spec.modulus
    start, base, count = rng.randrange(p), rng.randrange(p), 37
    want = ref_limb.pack_mont(spec, np.array([start * pow(base, i, p) % p for i in range(count)], dtype=object))
    _eq(limb.geom_series_mont(spec, start, base, count), want)


def test_scans_match_reference():
    """inclusive_scan and segmented_scan over modular addition against
    `openzl_tpu.ops.scan_utils` (n = 300 takes the reference's chunked path
    and the port's log-step path)."""
    from openzl_tpu.ops import scan_utils as ref_scan
    from openzl_tpu_torch.ops import scan_utils

    spec = BN254_FR
    n = 300
    x, _ = _pair(spec, n, 8)
    starts = np.random.default_rng(9).random(n) < 0.1
    starts[0] = True

    def port_add(a, b):
        return (limb.add(spec, a[0], b[0]),)

    def ref_add(a, b):
        return (ref_limb.add(spec, a[0], b[0]),)

    want = ref_scan.inclusive_scan(ref_add, (jnp.asarray(x),), lambda k: (jnp.zeros((spec.n_limbs, k), jnp.uint32),))
    (got,) = scan_utils.inclusive_scan(port_add, (limb.tensor(x),), lambda k: (limb.zeros(spec, (k,)),))
    _eq(got, want[0])
    want = ref_scan.segmented_scan(
        ref_add, (jnp.asarray(x),), jnp.asarray(starts), lambda k: (jnp.zeros((spec.n_limbs, k), jnp.uint32),)
    )
    (got,) = scan_utils.segmented_scan(
        port_add, (limb.tensor(x),), torch.as_tensor(starts), lambda k: (limb.zeros(spec, (k,)),)
    )
    _eq(got, want[0])
