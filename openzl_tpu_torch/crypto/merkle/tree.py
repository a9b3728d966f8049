"""Merkle tree with device-resident levels, hashed one level per batch.

Port of `openzl_tpu/crypto/merkle/tree.py`. A tree is an immutable value
holding one digest tensor per level, (n_limbs, occupied) int32 Montgomery
limbs on one device; a bulk build hashes a whole level in one batched
Poseidon call (kernel K5 on a CUDA device), and pushes rebuild only the
dirty suffix of each level.

Semantics of the reference (openzl-crypto/src/merkle_tree):
  * capacity = 2^(height - 1); a path is the sibling leaf plus height - 2
    inner digests (tree.rs:196-216)
  * an absent sibling reads as the zero sentinel, not as a hash of zeros;
    absent subtrees are never hashed (inner_tree.rs:282-370)
  * joins order (lhs, rhs) by node parity (path.rs:105-166)

Each level is hashed at its exact width (an odd trailing node is joined
with the zero sentinel); the reference's constant-shape padding and
power-of-two bucketing existed only to bound XLA recompiles and are gone.
A bulk build queues every level's hash on the device without a host sync;
the only readback is what the caller asks for (`root`, `path`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...fields import limb
from ...fields.spec import FieldSpec
from ..poseidon.permutation import Poseidon


def as_limbs(x, device) -> torch.Tensor:
    """int32 limb tensor on `device` from numpy limbs or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=limb.DTYPE).contiguous()
    return limb.tensor(x, device)


@dataclasses.dataclass(frozen=True)
class MerkleParameters:
    """Poseidon arity-2 joins over a field; the leaf digest is the leaf
    itself (the reference's `IdentityLeafHash`, tree.rs:68-90)."""

    spec: FieldSpec
    height: int  # capacity = 2^(height - 1), height >= 2

    @functools.cached_property
    def poseidon(self) -> Poseidon:
        return Poseidon.create(self.spec, arity=2)

    @property
    def capacity(self) -> int:
        return 1 << (self.height - 1)

    @property
    def path_length(self) -> int:
        return self.height - 2

    def join(self, lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """Batched join: lhs, rhs (n_limbs, *batch) on one device."""
        return self.poseidon.hash(torch.stack([lhs, rhs], dim=1))

    join_leaves = join

    @functools.cached_property
    def _int_params(self):
        from ...ref import poseidon as refposeidon

        perm = self.poseidon
        return refposeidon.PoseidonParams.generate(self.spec, perm.width, perm.full_rounds,
                                                   perm.partial_rounds)

    def join_ints(self, lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
        """One join on the host through the Python-int oracle: for the
        single-pair joins of `CurrentPath.push`, where a device launch per
        join would cost more than the hash."""
        from ...ref import poseidon as refposeidon

        li = int(limb.unpack_mont(self.spec, np.asarray(lhs)))
        ri = int(limb.unpack_mont(self.spec, np.asarray(rhs)))
        return limb.pack_mont(self.spec, refposeidon.hash(self._int_params, [li, ri]))


def hash_level(parameters: MerkleParameters, level: torch.Tensor) -> torch.Tensor:
    """Parent level of an occupied level (n_limbs, m): ceil(m / 2) joins of
    (level[2i], level[2i + 1]), the last right child the zero sentinel when
    m is odd."""
    m = level.shape[1]
    if m == 0:
        return level
    if m % 2:
        level = torch.cat([level, torch.zeros_like(level[:, :1])], dim=1)
    return parameters.join(level[:, 0::2], level[:, 1::2])


@dataclasses.dataclass(frozen=True)
class MerkleTree:
    """Immutable Merkle tree; level l holds the digests of its occupied
    nodes, ceil(count / 2^l) of them; levels[height - 1] = [root] once
    the tree is not empty."""

    parameters: MerkleParameters
    count: int
    levels: tuple  # of (n_limbs, occupied_l) int32 tensors on one device

    @classmethod
    def empty(cls, parameters: MerkleParameters, device="cuda") -> "MerkleTree":
        z = limb.zeros(parameters.spec, (0,), device)
        return cls(parameters, 0, tuple(z for _ in range(parameters.height)))

    @classmethod
    def from_leaf_digests(cls, parameters: MerkleParameters, digests, device="cuda") -> "MerkleTree":
        """Bulk build: one batched hash per level, at the level's width."""
        current = as_limbs(digests, device)
        count = current.shape[1]
        if count > parameters.capacity:
            raise ValueError(f"{count} leaves exceed the capacity {parameters.capacity}")
        levels = [current]
        for _ in range(parameters.height - 1):
            current = hash_level(parameters, current)
            levels.append(current)
        return cls(parameters, count, tuple(levels))

    @property
    def spec(self) -> FieldSpec:
        return self.parameters.spec

    @property
    def device(self) -> torch.device:
        return self.levels[0].device

    def __len__(self) -> int:
        return self.count

    def root(self) -> torch.Tensor:
        """(n_limbs,) Montgomery root digest (zero when empty)."""
        top = self.levels[-1]
        if top.shape[1] == 0:
            return limb.zeros(self.spec, (), self.device)
        return top[:, 0]

    def push_leaf_digests(self, digests) -> "MerkleTree":
        """Append leaf digests, rehashing only the nodes above them."""
        digests = as_limbs(digests, self.device)
        add = digests.shape[1]
        if add == 0:
            return self
        if self.count + add > self.parameters.capacity:
            raise ValueError(f"{self.count + add} leaves exceed the capacity {self.parameters.capacity}")
        current = torch.cat([self.levels[0], digests], dim=1)
        new_levels = [current]
        start = self.count  # first dirty index at the current level
        for level in range(1, self.parameters.height):
            parent_start = start >> 1
            rebuilt = hash_level(self.parameters, current[:, parent_start * 2 :])
            current = torch.cat([self.levels[level][:, :parent_start], rebuilt], dim=1)
            new_levels.append(current)
            start = parent_start
        return MerkleTree(self.parameters, self.count + add, tuple(new_levels))

    def push(self, leaf_digest) -> "MerkleTree":
        return self.push_leaf_digests(as_limbs(leaf_digest, self.device).reshape(-1, 1))

    def path_arrays(self, indices) -> tuple:
        """Membership paths of many leaves at once, gathered on the device:
        (sibling leaf digests (n_limbs, k), inner digests (n_limbs,
        height - 2, k)), absent siblings zero."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.device).reshape(-1)
        if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < self.count):
            raise IndexError(f"leaf index outside [0, {self.count})")
        sibs = []
        for level in range(self.parameters.height - 1):
            arr = self.levels[level]
            sib = (idx >> level) ^ 1
            present = sib < arr.shape[1]
            sibs.append(torch.where(present, arr[:, torch.clamp(sib, max=arr.shape[1] - 1)], 0))
        inner = (torch.stack(sibs[1:], dim=1) if len(sibs) > 1
                 else limb.zeros(self.spec, (0, idx.numel()), self.device))
        return sibs[0], inner

    def path(self, index: int) -> "MerklePath":
        from .path import MerklePath

        sibling, inner = self.path_arrays([index])
        return MerklePath(self.parameters, index, sibling[:, 0], inner[:, :, 0])
