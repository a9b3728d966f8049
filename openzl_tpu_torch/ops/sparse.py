"""Sparse field matrices (COO) and the QAP matvec.

Port of `openzl_tpu/ops/sparse.py` `SparseFieldMatrix`. A matvec gathers the
assignment by column, multiplies by the stored Montgomery coefficients with
kernel K1, and sums each row exactly: limb-wise `index_add_` in int64,
carry normalisation, then ceil(log2(max row nnz)) conditional subtractions
of p 2^j. (The reference summed rows with a log-depth modular segmented
scan in jnp, outside any kernel; this sum is plain torch too.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..fields.spec import FieldSpec
from ..fields import limb
from . import ntt_kernel


@dataclasses.dataclass(eq=False)
class SparseFieldMatrix:
    """COO matrix over a prime field, rows sorted, Montgomery values."""

    spec: FieldSpec
    n_rows: int
    n_cols: int
    rows: np.ndarray  # (nnz,) int32, sorted ascending
    cols: np.ndarray  # (nnz,) int32
    vals: np.ndarray  # (n_limbs, nnz) uint32, Montgomery form
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @classmethod
    def from_lincombs(
        cls, spec: FieldSpec, lincombs: Sequence, n_rows: int, n_cols: int
    ) -> "SparseFieldMatrix":
        """Build from LinComb rows; coefficients are interned so the
        Montgomery conversion runs once per distinct value."""
        rows: List[int] = []
        cols: List[int] = []
        ids: List[int] = []
        interned: dict = {}
        for r, lc in enumerate(lincombs):
            for k, coeff in lc.terms.items():
                i = interned.setdefault(coeff, len(interned))
                rows.append(r)
                cols.append(k)
                ids.append(i)
        p = spec.modulus
        pool = limb.pack_mont(spec, np.array([c % p for c in interned], dtype=object))
        r = np.asarray(rows, dtype=np.int32)
        c = np.asarray(cols, dtype=np.int32)
        v = np.asarray(ids, dtype=np.int64)
        order = np.argsort(r, kind="stable")
        vals = pool[:, v[order]] if len(v) else np.zeros((spec.n_limbs, 0), np.uint32)
        return cls(spec, n_rows, n_cols, r[order], c[order], vals)

    @classmethod
    def from_reference(cls, m) -> "SparseFieldMatrix":
        """From a reference (JAX package) `SparseFieldMatrix` through its
        COO numpy arrays and its field's name and modulus. Its
        zero-coefficient padding entries (row = n_rows) fall into the dump
        slot of `matvec`."""
        return cls(FieldSpec(m.spec.name, m.spec.modulus), m.n_rows, m.n_cols, np.asarray(m.rows, np.int32),
                   np.asarray(m.cols, np.int32), np.asarray(m.vals, np.uint32))

    def transpose(self) -> "SparseFieldMatrix":
        """Swapped-axes copy (QAP column evaluations)."""
        order = np.argsort(self.cols, kind="stable")
        return SparseFieldMatrix(
            self.spec, self.n_cols, self.n_rows,
            self.cols[order], self.rows[order], self.vals[:, order],
        )

    def device_buffers(self, device):
        """(rows, cols, vals, log2 bound of the row nnz) on `device`, cached."""
        key = torch.device(device)
        if key not in self._dev:
            counts = np.bincount(self.rows, minlength=1) if self.nnz else np.ones(1, np.int64)
            bound = max(0, int(counts.max() - 1).bit_length())
            self._dev[key] = (
                torch.as_tensor(self.rows.astype(np.int64), device=key),
                torch.as_tensor(self.cols.astype(np.int64), device=key),
                limb.tensor(self.vals, key),
                bound,
            )
        return self._dev[key]

    def drop_device(self) -> None:
        """Free the cached device buffers (the staged prover's discipline:
        one matrix on the device at a time); the host arrays remain."""
        self._dev.clear()

    def matvec(self, z_mont: torch.Tensor) -> torch.Tensor:
        """(self @ z) mod p: z_mont (n_limbs, n_cols) Montgomery ->
        (n_limbs, n_rows) Montgomery, on z's device."""
        spec = self.spec
        n = spec.n_limbs
        rows, cols, vals, bound = self.device_buffers(z_mont.device)
        terms = ntt_kernel.mont_mul(spec, vals, z_mont[:, cols].contiguous())
        sums = torch.zeros((n, self.n_rows + 1), dtype=torch.int64, device=z_mont.device)
        sums.index_add_(1, rows, terms.to(torch.int64))
        return reduce_sums(spec, sums[:, : self.n_rows], bound)


def reduce_sums(spec: FieldSpec, sums: torch.Tensor, bound: int) -> torch.Tensor:
    """Limb-wise int64 sums of at most 2^bound canonical elements ->
    canonical limbs mod p."""
    n = spec.n_limbs
    x = limb.normalize(sums, n + 2)
    for j in reversed(range(bound)):
        pj = torch.as_tensor(
            limb._ints_to_limbs(np.array(spec.modulus << j, dtype=object), n + 2).astype(np.int64),
            device=x.device,
        ).reshape((n + 2,) + (1,) * (x.ndim - 1))
        d, borrow = limb._sub_raw(x, pj)
        x = torch.where(borrow.bool().unsqueeze(0), x, d)
    return x[:n].to(limb.DTYPE)
