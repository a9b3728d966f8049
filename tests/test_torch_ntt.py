"""Kernel K2's plain version and the port's NTTs against the JAX package.

K2 (plain) is held against `openzl_tpu.ops.ntt_kernel.small_ntt` in Pallas
interpret mode on BabyBear, as tests/test_ntt_kernel.py runs it; `ntt`,
`intt`, `coset_ntt` and `coset_intt` against `openzl_tpu.ops.ntt` on BN254
Fr at 2^8 to 2^10. Inputs come from numpy.random.default_rng(seed); every
comparison is exact equality (tolerance 0)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BN254_FR, FieldSpec
from openzl_tpu.ops import ntt as ref_ntt
from openzl_tpu.ops import ntt_kernel as ref_ntt_kernel
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.ops import ntt, ntt_kernel

# xdist workers share the machine's cores: one torch thread each, since
# torch's default of one thread per core oversubscribes them many times
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


BABYBEAR = FieldSpec(name="babybear", modulus=2013265921)


def _rand_mont(spec, shape, seed):
    rng = np.random.default_rng(seed)
    vals = np.array(
        [int(v) % spec.modulus for v in rng.integers(0, 1 << 62, int(np.prod(shape)))],
        dtype=object,
    ).reshape(shape)
    return ref_limb.pack_mont(spec, vals)


def _roots(spec, log_n, inverse=False):
    """Montgomery limbs of w^j, j < n (the reference's _root_powers table,
    computed here so no cache file is written)."""
    n = 1 << log_n
    w = ref_ntt.group_gen(spec, log_n)
    if inverse:
        w = pow(w, -1, spec.modulus)
    pows, acc = [], 1
    for _ in range(n):
        pows.append(acc)
        acc = acc * w % spec.modulus
    return ref_limb.pack_mont(spec, np.array(pows, dtype=object))


@pytest.mark.parametrize("m,lanes,post", [(8, 5, False), (16, 3, True), (64, 2, True), (2, 4, False)])
def test_k2_plain_matches_pallas_interpret(m, lanes, post):
    spec = BABYBEAR
    log_n = 10
    R = _roots(spec, log_n)
    ref_tw = ref_ntt._stage_twiddles(spec, R, 1 << log_n, m)  # (n, log m, m)
    x = _rand_mont(spec, (m, lanes), m * 100 + lanes)
    post_tw = _rand_mont(spec, (m, lanes), 7) if post else None
    want = ref_ntt_kernel.small_ntt(
        spec, jnp.asarray(x), jnp.asarray(ref_tw),
        None if post_tw is None else jnp.asarray(post_tw), interpret=True,
    )
    # the port's table keeps entry j < h of each stage: (n, log m, m / 2)
    port_tw = limb.tensor(ref_tw[:, :, : m // 2])
    got = ntt_kernel.small_ntt(
        spec, limb.tensor(x), port_tw, None if post_tw is None else limb.tensor(post_tw)
    )
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


def test_k2_stage_table_matches_reference_layout():
    """The port's own plan tables equal the reference's in every entry a
    stage reads (j < h = m >> (s + 1))."""
    spec = BN254_FR
    log_n, m = 10, 32
    R = _roots(spec, log_n)
    ref_tw = ref_ntt._stage_twiddles(spec, R, 1 << log_n, m)
    port_tw = ntt._stage_twiddles(limb.tensor(R), 1 << log_n, m).numpy()
    for s in range(m.bit_length() - 1):
        h = m >> (s + 1)
        assert np.array_equal(port_tw[:, s, :h], ref_tw[:, s, :h])


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_transforms_match_reference(log_n):
    spec = BN254_FR
    x = _rand_mont(spec, (1 << log_n,), log_n)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for port_fn, ref_fn in (
        (ntt.ntt, ref_ntt.ntt),
        (ntt.intt, ref_ntt.intt),
        (ntt.coset_ntt, ref_ntt.coset_ntt),
        (ntt.coset_intt, ref_ntt.coset_intt),
    ):
        got = port_fn(spec, tx)
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref_fn(spec, jx))), port_fn.__name__


def test_transform_batch_axis_matches_reference():
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 11)
    got = ntt.ntt(spec, limb.tensor(x))
    want = ref_ntt.ntt(spec, jnp.asarray(x))
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_tables_match_reference(inverse):
    """The root powers and coset scales, built on the tensor's device by
    `limb.geom_series_mont`, equal the reference's host tables."""
    spec, log_n = BN254_FR, 9
    cpu = torch.device("cpu")
    R = ntt._root_powers(spec, log_n, inverse, cpu)
    assert np.array_equal(R.numpy(), _roots(spec, log_n, inverse))
    scales = ntt._coset_scales(spec, 1 << log_n, inverse, cpu)
    assert np.array_equal(scales.numpy(), ref_ntt._coset_scales(spec, 1 << log_n, inverse))


def test_coset_transforms_batch_axis_match_reference():
    """The batched coset transforms of the prover's h polynomial (u, v and w
    stacked on a trailing axis of 3)."""
    spec = BN254_FR
    x = _rand_mont(spec, (256, 3), 12)
    tx, jx = limb.tensor(x), jnp.asarray(x)
    for port_fn, ref_fn in ((ntt.coset_ntt, ref_ntt.coset_ntt), (ntt.coset_intt, ref_ntt.coset_intt)):
        got = port_fn(spec, tx)
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref_fn(spec, jx))), port_fn.__name__


@pytest.mark.parametrize("log_n", [1, 4, 13])
def test_round_trip_and_level_split(log_n):
    spec = BN254_FR
    x = limb.tensor(_rand_mont(spec, (1 << log_n,), 100 + log_n))
    assert torch.equal(ntt.intt(spec, ntt.ntt(spec, x)), x)
    levels = ntt._levels(log_n)
    assert sum(levels) == log_n and max(levels) <= 6 and max(levels) - min(levels) <= 1
