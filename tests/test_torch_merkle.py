"""The port's Merkle tree and path verification (plain K5 on the CPU)
against the JAX package, limb for limb.

The structure is held against the reference's `MerkleTree` (levels, roots,
pushes, paths, `verify_batch` masks, `CurrentPath`) on the repository's
31-bit toy field (`toy_fp32`) at height 7 with 21 leaves: the reference
compiles one jnp Poseidon per level width, seconds each on that field and
twenty on a 16-limb one. On BN254 Fr, the slice's field, the port's root is
held against the reference's `CurrentPath`, which joins through the
Python-int Poseidon oracle.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openzl_tpu.crypto.merkle import path as ref_path
from openzl_tpu.crypto.merkle.tree import MerkleParameters as RefParameters
from openzl_tpu.crypto.merkle.tree import MerkleTree as RefTree
from openzl_tpu.curves.spec import toy_curve
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu_torch.crypto.merkle import path as mpath
from openzl_tpu_torch.crypto.merkle.tree import MerkleParameters, MerkleTree
from openzl_tpu_torch.fields.spec import BN254_FR, FieldSpec

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

HEIGHT, COUNT, SPLIT = 7, 21, 13


def _leaves(spec, count, seed):
    rng = np.random.default_rng(seed)
    vals = np.array([int.from_bytes(rng.bytes(spec.n_bytes + 8), "little") % spec.modulus
                     for _ in range(count)], dtype=object)
    return ref_limb.pack_mont(spec, vals)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.fixture(scope="module")
def toy():
    ref_spec = toy_curve().base
    spec = FieldSpec(ref_spec.name, ref_spec.modulus)
    leaves = _leaves(ref_spec, COUNT, 5)
    ref_params = RefParameters(ref_spec, HEIGHT)
    ref_tree = RefTree.from_leaf_digests(ref_params, leaves)
    params = MerkleParameters(spec, HEIGHT)
    tree = MerkleTree.from_leaf_digests(params, leaves, device="cpu")
    return dict(ref_params=ref_params, ref_tree=ref_tree, params=params, tree=tree, leaves=leaves)


def _batch(tree, leaves, count):
    sib, inner = tree.path_arrays(np.arange(count))
    return tree.root(), torch.as_tensor(leaves.astype(np.int32)), sib, inner


def test_levels_root_and_pushes_match_reference(toy):
    tree, ref_tree, leaves = toy["tree"], toy["ref_tree"], toy["leaves"]
    assert len(tree.levels) == len(ref_tree.levels) == HEIGHT
    for got, want in zip(tree.levels, ref_tree.levels):
        _eq(got, want)
    _eq(tree.root(), ref_tree.root())
    pushed = MerkleTree.from_leaf_digests(toy["params"], leaves[:, :SPLIT], device="cpu")
    pushed = pushed.push_leaf_digests(leaves[:, SPLIT:])
    for got, want in zip(pushed.levels, tree.levels):
        _eq(got, want)
    one_by_one = MerkleTree.empty(toy["params"], device="cpu")
    for i in range(3):
        one_by_one = one_by_one.push(leaves[:, i])
    _eq(one_by_one.root(), MerkleTree.from_leaf_digests(toy["params"], leaves[:, :3], device="cpu").root())
    _eq(MerkleTree.empty(toy["params"], device="cpu").root(), RefTree.empty(toy["ref_params"]).root())


def test_paths_match_reference(toy):
    tree, ref_tree, leaves = toy["tree"], toy["ref_tree"], toy["leaves"]
    for i in range(COUNT):
        got, want = tree.path(i), ref_tree.path(i)
        _eq(got.sibling_digest, want.sibling_digest)
        _eq(got.inner_path, want.inner_path)
    for i in (0, 7, COUNT - 1):  # one fold each; verify_batch folds them all
        assert tree.path(i).verify(tree.root(), leaves[:, i])
    assert not tree.path(3).verify(tree.root(), leaves[:, 4])


def test_verify_batch_masks_match_reference(toy):
    tree, leaves = toy["tree"], toy["leaves"]
    root, leaf_t, sib, inner = _batch(tree, leaves, COUNT)
    flipped = leaf_t.clone()
    flipped[0, 7] ^= 1
    idx = np.arange(COUNT)
    ok = mpath.verify_batch(toy["params"], root, leaf_t, sib, inner, idx)
    bad = mpath.verify_batch(toy["params"], root, flipped, sib, inner, idx)
    ref_args = (jnp.asarray(np.asarray(toy["ref_tree"].root())), jnp.asarray(sib.numpy().astype(np.uint32)),
                jnp.asarray(inner.numpy().astype(np.uint32)), idx.astype(np.uint32))
    ref_ok = ref_path.verify_batch(toy["ref_params"], ref_args[0], jnp.asarray(leaves), *ref_args[1:])
    ref_bad = ref_path.verify_batch(toy["ref_params"], ref_args[0],
                                    jnp.asarray(flipped.numpy().astype(np.uint32)), *ref_args[1:])
    assert bool(ok.all()) and ok.tolist() == np.asarray(ref_ok).tolist()
    assert bad.tolist() == np.asarray(ref_bad).tolist() == [i != 7 for i in range(COUNT)]


def test_current_path_roots_match_tree(toy):
    params, ref_params, leaves = toy["params"], toy["ref_params"], toy["leaves"]
    cur, ref_cur = mpath.CurrentPath.empty(params), ref_path.CurrentPath.empty(ref_params)
    for i in range(COUNT):
        cur, ref_cur = cur.push(leaves[:, i]), ref_cur.push(leaves[:, i])
        _eq(cur.root_digest, ref_cur.root_digest)
        if i in (0, 6, COUNT - 1):
            _eq(cur.root_digest, MerkleTree.from_leaf_digests(params, leaves[:, : i + 1], device="cpu").root())
    _eq(cur.root_digest, toy["tree"].root())


def test_bn254_root_matches_reference_oracle():
    height, count = 6, 11
    leaves = _leaves(REF_BN254_FR, count, 6)
    tree = MerkleTree.from_leaf_digests(MerkleParameters(BN254_FR, height), leaves, device="cpu")
    ref_cur = ref_path.CurrentPath.empty(RefParameters(REF_BN254_FR, height))
    for i in range(count):
        ref_cur = ref_cur.push(leaves[:, i])
    _eq(tree.root(), ref_cur.root_digest)
    root, leaf_t, sib, inner = _batch(tree, leaves, count)
    assert bool(mpath.verify_batch(tree.parameters, root, leaf_t, sib, inner, np.arange(count)).all())


def test_tree_entry_points_default_to_cuda_and_check_input():
    params = MerkleParameters(BN254_FR, 3)
    assert params.poseidon.device == torch.device("cuda")
    for entry in (MerkleTree.from_leaf_digests, MerkleTree.empty):
        assert inspect.signature(entry).parameters["device"].default == "cuda"
    with pytest.raises(ValueError, match="capacity"):
        MerkleTree.from_leaf_digests(params, np.zeros((16, 5), np.uint32), device="cpu")
    tree = MerkleTree.from_leaf_digests(params, np.zeros((16, 3), np.uint32), device="cpu")
    with pytest.raises(IndexError):
        tree.path(3)
