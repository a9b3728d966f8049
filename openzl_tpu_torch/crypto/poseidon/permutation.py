"""Batched Poseidon permutation and hash over 16-bit limb tensors.

Port of `openzl_tpu/crypto/poseidon/permutation.py`. A batch of states is an
int32 tensor ``(n_limbs, width, *batch)`` of Montgomery-form limbs, the
reference's layout. `permute` runs kernel K5 (classic rounds, dense MDS)
and `permute_optimized` kernel K6 (compressed keys, sparse partial rounds)
on a CUDA tensor, and their plain torch versions on a CPU tensor
(`openzl_tpu_torch.ops.poseidon_kernel`). Both give the same permutation.

Round structure (reference openzl-crypto/src/poseidon/mod.rs:193-283): add
round keys, S-box x^5 (every element in full rounds, element 0 in partial
rounds), then the MDS product. Hashing enters with state = [domain tag,
*inputs], tag 2^arity - 1, and returns element 0.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ...fields import limb
from ...fields.spec import FieldSpec
from . import constants, param_gen, preprocessing
from . import mds as mds_mod

#: Wire-compatible round numbers (width -> (R_F, R_P)) of the reference's
#: arkworks-plugin instances (plugins/arkworks/src/poseidon/mod.rs:300-322)
ROUND_NUMBERS = {
    2: (8, 55),
    3: (8, 55),
    4: (8, 55),
    5: (8, 56),
    6: (8, 56),
    9: (8, 57),
    17: (8, 59),
}


def round_numbers(width: int, modulus_bits: int) -> tuple[int, int]:
    """(R_F, R_P) at `width`: the reference's wire-compatible table, and for
    a width it does not pin, the security search (`constants.from_arity`)."""
    if width in ROUND_NUMBERS:
        return ROUND_NUMBERS[width]
    found = constants.from_arity(width - 1, modulus_bits=modulus_bits)
    return found.full_rounds, found.partial_rounds


@functools.lru_cache(maxsize=None)
def _host_params(spec: FieldSpec, width: int, full_rounds: int, partial_rounds: int):
    """Montgomery limb arrays of the classic and the optimized parameters,
    derived from the integer round constants and Cauchy MDS (host, once per
    configuration; the layouts of the reference's `Poseidon` fields)."""
    keys = param_gen.generate_round_constants(spec, width, full_rounds, partial_rounds)
    mds = param_gen.generate_mds(spec, width)
    rounds = full_rounds + partial_rounds
    obj = lambda x: np.array(x, dtype=object)  # noqa: E731
    keys_arr = np.moveaxis(limb.pack_mont(spec, obj(keys).reshape(rounds, width)), 0, 1)
    mds_arr = limb.pack_mont(spec, obj(mds))

    p = spec.modulus
    matrices = mds_mod.derive_mds_matrices(p, mds)
    ckeys = preprocessing.compress_round_constants(p, width, full_rounds, partial_rounds, keys, matrices)
    pre_sparse, sparse = mds_mod.factor_to_sparse_matrices(p, mds, partial_rounds)
    half = full_rounds // 2
    full_post = [ckeys[width * (1 + r) : width * (2 + r)] for r in range(half)]
    pofs = width * (half + 1)
    partial_keys = ckeys[pofs : pofs + partial_rounds]
    fofs = pofs + partial_rounds
    full_post += [ckeys[fofs + width * r : fofs + width * (r + 1)] for r in range(half - 1)]
    return dict(
        round_keys=keys_arr,
        mds=mds_arr,
        opt_initial=limb.pack_mont(spec, obj(ckeys[:width])),
        opt_full_keys=np.moveaxis(limb.pack_mont(spec, obj(full_post)), 0, 1),
        opt_partial_keys=np.moveaxis(limb.pack_mont(spec, obj(partial_keys)), 0, 1),
        opt_pre_sparse=limb.pack_mont(spec, obj(pre_sparse)),
        opt_w_hat=np.moveaxis(limb.pack_mont(spec, obj([s.w_hat for s in sparse])), 0, 1),
        opt_v_rest=np.moveaxis(limb.pack_mont(spec, obj([s.v_rest for s in sparse])), 0, 1),
    )


class BatchedPermutation:
    """What `Poseidon` and `Poseidon2` share: per-device parameter tensors,
    the batch layout around the kernel wrapper, and the hash's domain tag.
    Subclasses have `spec`, `width`, `device` and `_dev` fields and a
    `_permute_flat` on (n_limbs, width, B)."""

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    @property
    def arity(self) -> int:
        return self.width - 1

    def tensors(self, key: str, device, build):
        """Device copy of a derived parameter array, built once per device."""
        dev = torch.device(device)
        if (key, dev) not in self._dev:
            self._dev[key, dev] = build()
        return self._dev[key, dev]

    def _on_device(self, x) -> torch.Tensor:
        """A tensor stays on its device; numpy limbs go to `self.device`."""
        return x if isinstance(x, torch.Tensor) else limb.tensor(x, self.device)

    def _apply(self, fn, state) -> torch.Tensor:
        """fn on (n_limbs, width, B), for states (n_limbs, width, *batch)."""
        state = self._on_device(state)
        squeeze = state.ndim == 2
        if squeeze:
            state = state[..., None]
        batch = state.shape[2:]
        out = fn(self, state.reshape(state.shape[:2] + (-1,)).contiguous())
        out = out.reshape(out.shape[:2] + batch)
        return out[..., 0] if squeeze else out

    def permute(self, state) -> torch.Tensor:
        """The permutation of Montgomery-form states, (n_limbs, width,
        *batch) -> same shape."""
        return self._apply(type(self)._permute_flat, state)

    def domain_tag_mont(self) -> np.ndarray:
        """2^arity - 1 in Montgomery limb form, shape (n_limbs,)."""
        return limb.pack_mont(self.spec, (1 << self.arity) - 1)

    def hash(self, inputs) -> torch.Tensor:
        """inputs (n_limbs, arity, *batch) Montgomery -> (n_limbs, *batch):
        element 0 of the permutation of [2^arity - 1, *inputs]."""
        inputs = self._on_device(inputs)
        tag = self.tensors("tag", inputs.device, lambda: limb.tensor(self.domain_tag_mont(), inputs.device))
        shape = (self.spec.n_limbs, 1) + tuple(inputs.shape[2:])
        tag = tag.reshape((self.spec.n_limbs, 1) + (1,) * (inputs.ndim - 2)).expand(shape)
        return self.permute(torch.cat([tag, inputs], dim=1))[:, 0]


@dataclasses.dataclass(frozen=True, eq=False)
class Poseidon(BatchedPermutation):
    """One Poseidon configuration: host Montgomery limb arrays (uint32, the
    reference's shapes) and the device that numpy inputs go to. Tensors
    derived from the arrays are cached per device in `_dev`."""

    spec: FieldSpec
    width: int
    full_rounds: int
    partial_rounds: int
    round_keys: np.ndarray  # (rounds, n_limbs, width)
    mds: np.ndarray  # (n_limbs, width, width), mds[:, i, j] = M[i][j]
    opt_initial: np.ndarray  # (n_limbs, width) added before round 0
    opt_full_keys: np.ndarray  # (full_rounds - 1, n_limbs, width) post-S-box
    opt_partial_keys: np.ndarray  # (partial_rounds, n_limbs) post-S-box
    opt_pre_sparse: np.ndarray  # (n_limbs, width, width) boundary matrix
    opt_w_hat: np.ndarray  # (partial_rounds, n_limbs, width) sparse first columns
    opt_v_rest: np.ndarray  # (partial_rounds, n_limbs, width - 1) sparse first rows
    device: torch.device = torch.device("cuda")
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def create(cls, spec: FieldSpec, arity: int, full_rounds: int | None = None,
               partial_rounds: int | None = None, device="cuda") -> "Poseidon":
        """The instance for `spec` and `arity`; round numbers default to the
        reference's wire-compatible table, and for a width it does not pin,
        to the security search (`constants.from_arity` at the field's bit
        length)."""
        width = arity + 1
        if full_rounds is None or partial_rounds is None:
            full_rounds, partial_rounds = round_numbers(width, spec.bits)
        spec = FieldSpec(spec.name, spec.modulus)
        arrays = _host_params(spec, width, full_rounds, partial_rounds)
        return cls(spec, width, full_rounds, partial_rounds, **arrays, device=torch.device(device))

    @classmethod
    def from_reference(cls, perm, device="cuda") -> "Poseidon":
        """From a reference (JAX package) `Poseidon`: its numpy parameter
        arrays, field name and modulus, and round numbers."""
        fields = ("round_keys", "mds", "opt_initial", "opt_full_keys", "opt_partial_keys",
                  "opt_pre_sparse", "opt_w_hat", "opt_v_rest")
        return cls(
            FieldSpec(perm.spec.name, perm.spec.modulus), int(perm.width), int(perm.full_rounds),
            int(perm.partial_rounds), **{k: np.asarray(getattr(perm, k), np.uint32) for k in fields},
            device=torch.device(device),
        )

    def _permute_flat(self, state: torch.Tensor) -> torch.Tensor:
        from ...ops import poseidon_kernel

        return poseidon_kernel.permute(self, state)

    def _permute_optimized_flat(self, state: torch.Tensor) -> torch.Tensor:
        from ...ops import poseidon_kernel

        return poseidon_kernel.permute_optimized(self, state)

    def permute_optimized(self, state) -> torch.Tensor:
        """The same permutation through the optimized rounds (K6)."""
        return self._apply(Poseidon._permute_optimized_flat, state)
