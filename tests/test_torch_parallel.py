"""The port's `parallel/` on a gloo process group of four CPU ranks, held
against the JAX package's sharded functions on a 4-device sub-mesh of the
8-device virtual CPU mesh, the port's single-device functions and the
`ref` oracle. Every comparison is exact: transforms and digests as limb
arrays, MSMs as affine points (the tree of partial sums adds in another
order than one device's pipeline, so Jacobian limbs may differ).

The ranks (`openzl_tpu_torch.parallel.launch.RankPool`) start once per
module, join through a `FileStore` under a temporary directory and run one
torch thread each; every `run` has a deadline, past which the ranks are
killed and the test fails. They run `torch_mesh_tasks`, which never
imports JAX."""

import os
import random

import numpy as np
import pytest
import torch

from openzl_tpu.crypto.poseidon.permutation import Poseidon as RefPoseidon
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu.parallel import local_mesh as ref_local_mesh
from openzl_tpu.parallel import sharded_poseidon_hash as ref_sharded_poseidon_hash
from openzl_tpu.parallel import sharded_transform as ref_sharded_transform
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BN254_FR
from openzl_tpu_torch.ops import msm as msmmod
from openzl_tpu_torch.ops import ntt as nttmod
from openzl_tpu_torch.parallel import ops as pops
from openzl_tpu_torch.parallel.launch import RankPool
from openzl_tpu_torch.ref import curve as refc
from openzl_tpu_torch.ref.pairing import BN254

import torch_mesh_tasks as tasks

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORLD = 4
#: seconds a run may take before its ranks are killed
DEADLINE = 240
LOG_N = 9  # the JAX package's own fast-suite size
KINDS = {"ntt": (False, False), "intt": (True, False), "coset_ntt": (False, True), "coset_intt": (True, True)}
SINGLE = {"ntt": nttmod.ntt, "intt": nttmod.intt, "coset_ntt": nttmod.coset_ntt, "coset_intt": nttmod.coset_intt}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, "gloo", tmp_path_factory.mktemp("store"), devices=["cpu"] * WORLD,
                  timeout=DEADLINE) as p:
        yield p


def _coeffs(seed: int) -> np.ndarray:
    rng = random.Random(seed)
    vals = [0, 1, BN254_FR.modulus - 1] + [rng.randrange(BN254_FR.modulus) for _ in range((1 << LOG_N) - 3)]
    return limb.pack_mont(BN254_FR, np.array(vals, dtype=object))


#: the JAX package's sharded results, each computed once (one compile)
_REF = {}


def _ref_transform(which: str) -> np.ndarray:
    if which not in _REF:
        inverse, coset = KINDS[which]
        _REF[which] = np.asarray(ref_sharded_transform(REF_BN254_FR, ref_local_mesh(WORLD), _coeffs(7),
                                                       inverse=inverse, coset=coset))
    return _REF[which]


def test_collectives_follow_the_reference_axes(pool):
    """all_gather stacks onto a new trailing axis in mesh order; the tiled
    all_to_all sends block j of the split axis to rank j and concatenates
    what arrives along the concat axis in mesh order; a 3-rank sub-mesh
    leaves rank 3 out."""
    n = WORLD
    vs = [np.arange(2 * 3 * 2 * n).reshape(2, 3, 2 * n) + 1000 * r for r in range(n)]
    for r, out in enumerate(pool.run(tasks.collectives, n, "cpu")):
        assert out["rank"] == r and out["size"] == n
        assert np.array_equal(out["gather"], np.stack(vs, -1))
        blocks = [np.split(vs[i], n, axis=2)[r] for i in range(n)]
        assert np.array_equal(out["a2a"], np.concatenate(blocks, axis=1))
        assert np.array_equal(out["a2a_front"], np.concatenate(blocks, axis=0))
    sub = pool.run(tasks.collectives, 3, "cpu")
    assert sub[3] is None and [o["size"] for o in sub[:3]] == [3, 3, 3]
    vs3 = [np.arange(2 * 3 * 6).reshape(2, 3, 6) + 1000 * r for r in range(3)]
    for r, out in enumerate(sub[:3]):
        assert np.array_equal(out["a2a"], np.concatenate([np.split(vs3[i], 3, axis=2)[r] for i in range(3)], 1))


def _points(curve, n, rng, none_at=()):
    pts = [refc.scalar_mul(curve, rng.randrange(1, 1 << 20), refc.generator(curve)) for _ in range(n)]
    for i in none_at:
        pts[i] = None
    return pts


@pytest.mark.parametrize("ranks,n", [pytest.param(3, 10, id="3"), pytest.param(4, 10, id="4"),
                                     pytest.param(4, 9, id="4-n9")])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_sharded_msm_matches_oracle_and_one_device(pool, ranks, n, group):
    """Ten points (padded to 12: one rank's shard is part padding), or nine
    over 4 ranks (shares of 3: the last rank's lies wholly past N, so it
    holds 3 identities), an identity, a zero scalar and p - 1, full-width
    scalars: a log2 tree of partials at 4 ranks, the sequential fold at 3."""
    curve = getattr(BN254, group)
    rng = random.Random(31 + ranks)
    pts = _points(curve, n, rng, none_at=(3,))
    ks = [rng.randrange(curve.scalar.modulus) for _ in range(n)]
    ks[5], ks[8] = 0, curve.scalar.modulus - 1
    want = refc.msm(curve, ks, pts)
    out = pool.run(tasks.msm, ranks, f"bn254_{group}", ks, pts, "cpu")
    assert out[ranks:] == [None] * (WORLD - ranks)
    assert out[:ranks] == [want] * ranks
    scal = limb.tensor(limb.pack(curve.scalar, np.array(ks, dtype=object)))
    one = msmmod.msm(curve, scal, jac.from_affine_ints(curve, pts, "cpu"))
    assert jac.to_affine_ints(curve, one) == want


@pytest.mark.parametrize("n,size", [(9, 4), (5, 4), (4, 3), (10, 4), (12, 4)])
def test_msm_shard_gives_every_rank_a_full_share(n, size):
    """Each rank's shard holds m = ceil(N / size) entries, as the
    reference's padded global arrays give it: the shards in rank order are
    the input followed by zero scalars times identities, also where a
    rank's share lies wholly past N."""
    curve = BN254.g1
    rng = random.Random(n * 10 + size)
    pts = _points(curve, n, rng)
    scal = limb.tensor(limb.pack(curve.scalar, np.array([rng.randrange(1, 1 << 64) for _ in range(n)],
                                                        dtype=object)))
    pj = jac.from_affine_ints(curve, pts, "cpu")
    m = -(-n // size)
    shards = [pops._msm_shard(curve, _View(size, r), scal, [pj]) for r in range(size)]
    assert all(s.shape[1] == m and p.z.shape[-1] == m for s, (p,) in shards)
    cat_s = torch.cat([s for s, _ in shards], dim=1)
    assert torch.equal(cat_s[:, :n], scal) and not cat_s[:, n:].any()
    cat_p = jac.concat([p for _, (p,) in shards])
    assert jac.to_affine_ints(curve, cat_p) == pts + [None] * (m * size - n)


class _View:
    """The part of a mesh that a rank's shard depends on."""

    def __init__(self, size, rank):
        self.size, self.rank, self.device = size, rank, torch.device("cpu")


@pytest.mark.parametrize("ranks", [3, 4])
def test_sharded_msm_multi_with_identity_points_per_set(pool, ranks):
    """Three sets sharing 11 scalars (padded to a multiple of the mesh),
    each with identities at its own positions, as the JAX package's
    `test_sharded_msm_multi_toy_fast`; small scalars (window 4, 8 bits)."""
    curve = BN254.g1
    rng = random.Random(0x3A3A + ranks)
    n = 11
    ks = [rng.randrange(1 << 8) for _ in range(n - 2)] + [0, 1]
    sets = [_points(curve, n, rng, none_at=range(s, n, 4 + s)) for s in range(3)]
    want = [refc.msm(curve, ks, pts) for pts in sets]
    out = pool.run(tasks.msm, ranks, "bn254_g1", ks, sets, "cpu", 4, 8, True)
    assert out[:ranks] == [want] * ranks and out[ranks:] == [None] * (WORLD - ranks)
    scal = limb.tensor(limb.pack(curve.scalar, np.array(ks, dtype=object)))
    one = msmmod.msm_multi(curve, scal, [jac.from_affine_ints(curve, p, "cpu") for p in sets], 4, 8)
    assert [jac.to_affine_ints(curve, o) for o in one] == want


@pytest.mark.parametrize("which", sorted(KINDS))
def test_sharded_transform_matches_jax_sharded_and_one_device(pool, which):
    """2^9 BN254 Fr points (0, 1 and p - 1 among them) over 4 ranks: R = 4
    rows of C = 128, the 128-point sub-transforms, the all-to-all and the
    4-point sub-transforms batched over 32 columns, against the JAX
    package's `sharded_transform` on its 4-device mesh and the port's own
    single-device transform, bit-exact."""
    x = _coeffs(7)
    out = pool.run(tasks.transform, WORLD, "BN254_FR", which, x, "cpu")
    ref = _ref_transform(which)
    single = SINGLE[which](BN254_FR, limb.tensor(x)).numpy()
    assert np.array_equal(single.astype(np.uint32), ref)
    for got in out:
        assert got.dtype == np.int32 and np.array_equal(got.astype(np.uint32), ref)


def test_sharded_poseidon_hash_matches_jax(pool):
    """Width 3 over BN254 Fr, a batch of 32 split 8 a rank, as the JAX
    package's `test_sharded_poseidon_matches_single_chip`."""
    vals = np.random.RandomState(0).randint(0, 1 << 14, size=(BN254_FR.n_limbs, 2, 32)).astype(np.uint32)
    ref = np.asarray(ref_sharded_poseidon_hash(RefPoseidon.create(REF_BN254_FR, arity=2), ref_local_mesh(WORLD),
                                               vals))
    for got in pool.run(tasks.poseidon, WORLD, "BN254_FR", 2, vals, "cpu"):
        assert np.array_equal(got.astype(np.uint32), ref)


def test_sharded_code_refuses_what_it_cannot_shard(pool):
    out = pool.run(tasks.refusals, "cpu")
    for r, o in enumerate(out):
        assert ("power-of-two mesh" in o["transform3"]) if r < 3 else o["transform3"] is None
        assert "does not split" in o["batch"]
        assert "'model'" in o["axis"]
        assert "NCCL mesh runs on CUDA" in o["nccl"]


def test_rank_pool_fails_on_a_rank_error_and_on_its_deadline(tmp_path):
    """A rank that raises, or a run past its deadline, ends the pool (its
    ranks killed) and fails the caller; a dead pool refuses more runs."""
    with RankPool(2, "gloo", tmp_path, timeout=60) as p:
        assert p.run(tasks.sleep, 0.01) == [0.01, 0.01]
        with pytest.raises(RuntimeError, match="fails on purpose"):
            p.run(tasks.fail)
        assert not p.alive
        with pytest.raises(RuntimeError, match="ended by an earlier failure"):
            p.run(tasks.sleep, 0.01)
    with RankPool(2, "gloo", tmp_path, timeout=60) as p:
        with pytest.raises(RuntimeError, match="deadline"):
            p.run(tasks.sleep, 30, timeout=2)
        assert not any(proc.is_alive() for proc in p._procs)
