"""Merkle membership paths with batched verification.

Port of `openzl_tpu/crypto/merkle/path.py`. A path is the sibling leaf
digest plus the inner sibling digests (reference
openzl-crypto/src/merkle_tree/path.rs:628-775); the root is recomputed by
joining with the sibling at each level, ordered (acc, sibling) by the
parity of the node index (path.rs:105-166). `verify_batch` folds many paths
at once, one batched Poseidon hash per level (K5 on a CUDA device), with
the operands ordered by index-bit masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...fields import limb
from .tree import MerkleParameters, as_limbs


@dataclasses.dataclass(frozen=True)
class MerklePath:
    parameters: MerkleParameters
    leaf_index: int
    sibling_digest: torch.Tensor  # (n_limbs,)
    inner_path: torch.Tensor  # (n_limbs, height - 2), leaf-adjacent first

    def root(self, leaf_digest) -> torch.Tensor:
        """The root this path implies for `leaf_digest`, (n_limbs,)."""
        dev = self.sibling_digest.device
        bits = index_bits(self.parameters, [self.leaf_index], dev)
        out = _fold_root(self.parameters, as_limbs(leaf_digest, dev).reshape(-1, 1),
                         self.sibling_digest.reshape(-1, 1), self.inner_path[..., None], bits)
        return out[:, 0]

    def verify(self, root, leaf_digest) -> bool:
        return bool(limb.eq(self.root(leaf_digest), as_limbs(root, self.sibling_digest.device)))


def verify_batch(
    parameters: MerkleParameters,
    roots: torch.Tensor,  # (n_limbs, batch) or (n_limbs,) broadcast
    leaf_digests: torch.Tensor,  # (n_limbs, batch)
    sibling_digests: torch.Tensor,  # (n_limbs, batch)
    inner_paths: torch.Tensor,  # (n_limbs, height - 2, batch)
    leaf_indices,  # (batch,) ints
) -> torch.Tensor:
    """Batched membership check on the device of `leaf_digests`; returns a
    (batch,) bool mask."""
    bits = index_bits(parameters, leaf_indices, leaf_digests.device)
    got = _fold_root(parameters, leaf_digests, sibling_digests, inner_paths, bits)
    if roots.ndim == 1:
        roots = roots[:, None]
    return limb.eq(got, roots)


def index_bits(parameters: MerkleParameters, indices, device) -> torch.Tensor:
    """(height - 1, batch) bool: bit l = parity of the node index at level l."""
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device).reshape(-1)
    shifts = torch.arange(parameters.height - 1, device=device)
    return ((idx[None, :] >> shifts[:, None]) & 1).bool()


def _fold_root(parameters, leaf, sibling, inner, bits) -> torch.Tensor:
    # leaf level: order by bit 0 (right child when set)
    acc = parameters.join_leaves(limb.select(bits[0], sibling, leaf), limb.select(bits[0], leaf, sibling))
    for level in range(parameters.path_length):
        sib, bit = inner[:, level], bits[level + 1]
        acc = parameters.join(limb.select(bit, sib, acc), limb.select(bit, acc, sib))
    return acc


# ---------------------------------------------------------------------------
# CurrentPath: the right-most path with O(height) state, updated on push
# (reference openzl-crypto/src/merkle_tree/path.rs:778-913)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurrentPath:
    """Compressed right-most path on the host: per level, the pending left
    child digest (numpy limbs). `push` takes O(height) single joins through
    the Python-int oracle (`MerkleParameters.join_ints`)."""

    parameters: MerkleParameters
    count: int
    frontier: tuple  # per level 0..height-2: (n_limbs,) last left child
    root_digest: np.ndarray  # (n_limbs,)

    @classmethod
    def empty(cls, parameters: MerkleParameters) -> "CurrentPath":
        zero = np.zeros(parameters.spec.n_limbs, dtype=np.uint32)
        return cls(parameters, 0, tuple(zero for _ in range(parameters.height - 1)), zero.copy())

    @property
    def leaf_index(self) -> int:
        if self.count == 0:
            raise ValueError("empty path")
        return self.count - 1

    def push(self, leaf_digest) -> "CurrentPath":
        """Append a leaf; the root matches the dense tree's (zero sentinels
        for absent right subtrees)."""
        idx = self.count
        if idx >= self.parameters.capacity:
            raise ValueError("the tree is full")
        node = np.asarray(leaf_digest, dtype=np.uint32)
        zero = np.zeros(self.parameters.spec.n_limbs, dtype=np.uint32)
        frontier = list(self.frontier)
        for level in range(self.parameters.height - 1):
            if (idx >> level) & 1 == 0:
                frontier[level] = node
                node = self.parameters.join_ints(node, zero)
            else:
                node = self.parameters.join_ints(frontier[level], node)
        return CurrentPath(self.parameters, idx + 1, tuple(frontier), node)
