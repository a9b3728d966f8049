"""Replayable witness generation: the witness calculator.

Carried from `openzl_tpu/eclair/witness.py` (pure Python, but its package
imports JAX; see `r1cs.py`). The R1CS compiler records a hint tape while
the circuit is built once; this module flattens the tape and replays it
against fresh leaf values, in Python or through the shared native C++
evaluator of `openzl_tpu_torch.native` (`make -C native`).

Leaf witnesses are the `secret_witness` allocations the user made directly;
every other witness column is derived by a tape op (mul / inv / iszero /
bits / divmod) from earlier columns.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..fields import limb
from .r1cs import R1CS, LinComb

# op codes shared with native/witness.cpp
_OP_MUL = 0
_OP_INV = 1
_OP_ISZERO = 2
_OP_BITS = 3
_OP_DIVMOD = 4

_OPS_BY_NAME = {
    "mul": _OP_MUL,
    "inv": _OP_INV,
    "iszero": _OP_ISZERO,
    "bits": _OP_BITS,
    "divmod": _OP_DIVMOD,
}


def native_available() -> bool:
    """True when the shared evaluator `native/libozlfield.so` is built
    (`make -C native`) and loads."""
    from .. import native

    return native.available()


class WitnessCalculator:
    """Flattened hint tape for one circuit; replays assignments from leaves.

    Build once per circuit (from a SETUP- or PROVE-mode compile), then call
    :meth:`evaluate` per proof. `evaluate` returns the full Groth16
    assignment vector ``[1, instances..., witnesses...]``.
    """

    def __init__(self, cs: R1CS):
        self.p = cs.p
        self.num_instance = cs.num_instance
        self.n_vars = cs.num_variables
        col = cs.column

        hint_out_cols = set()
        ops_rows: List[Tuple[int, ...]] = []
        lc_cols: List[int] = []
        lc_coeffs: List[int] = []
        moduli: List[int] = []

        def push_lc(lc: LinComb) -> Tuple[int, int]:
            start = len(lc_cols)
            for k, c in lc.terms.items():
                lc_cols.append(col(k))
                lc_coeffs.append(c % cs.p)
            return start, len(lc_cols)

        for hint in cs.hints:
            kind = hint[0]
            op = _OPS_BY_NAME[kind]
            if kind == "mul":
                _, lca, lcb, out = hint
                a0, a1 = push_lc(lca)
                b0, b1 = push_lc(lcb)
                row = (op, a0, a1, b0, b1, col(out), 1, 0)
                hint_out_cols.add(col(out))
            elif kind == "inv":
                _, lca, out = hint
                a0, a1 = push_lc(lca)
                row = (op, a0, a1, 0, 0, col(out), 1, 0)
                hint_out_cols.add(col(out))
            elif kind == "iszero":
                _, lca, zk, ik = hint
                a0, a1 = push_lc(lca)
                zc, ic = col(zk), col(ik)
                assert ic == zc + 1, "iszero outputs must be consecutive"
                row = (op, a0, a1, 0, 0, zc, 2, 0)
                hint_out_cols.update((zc, ic))
            elif kind == "bits":
                _, lca, keys = hint
                a0, a1 = push_lc(lca)
                cols = [col(k) for k in keys]
                assert cols == list(
                    range(cols[0], cols[0] + len(cols))
                ), "bit outputs must be consecutive"
                row = (op, a0, a1, 0, 0, cols[0], len(cols), 0)
                hint_out_cols.update(cols)
            elif kind == "divmod":
                _, lca, modulus, qk, rk = hint
                a0, a1 = push_lc(lca)
                qc, rc = col(qk), col(rk)
                assert rc == qc + 1, "divmod outputs must be consecutive"
                row = (op, a0, a1, 0, 0, qc, 2, len(moduli))
                moduli.append(modulus)
                hint_out_cols.update((qc, rc))
            else:  # pragma: no cover - defensive
                raise ValueError(f"unknown hint kind {kind!r}")
            ops_rows.append(row)

        ni = cs.num_instance_total
        self.leaf_cols = [
            c for c in range(ni, self.n_vars) if c not in hint_out_cols
        ]
        self.num_leaves = len(self.leaf_cols)
        self._ops = np.array(ops_rows, dtype=np.int32).reshape(-1, 8)
        self._lc_cols = np.array(lc_cols, dtype=np.int32)
        self._lc_coeffs = lc_coeffs
        self._moduli = moduli
        self._native = None  # lazily built flattened form for the C++ path

    # ------------------------------------------------------------------

    def leaf_values(self, cs: R1CS) -> List[int]:
        """Extract this circuit's leaf-witness values from a PROVE-mode
        build of the same circuit (convenience for tests/migration)."""
        z = cs.assignment()
        return [z[c] for c in self.leaf_cols]

    def evaluate(
        self,
        instance_values: Sequence[int],
        leaf_witness_values: Sequence[int],
        backend: str = "auto",
    ) -> List[int]:
        """Full assignment [1, instances..., witnesses...] from leaves.

        backend: "native" (C++ evaluator, error if unavailable), "python"
        (bigint replay), or "auto" (native when built).
        """
        assert len(instance_values) == self.num_instance, "instance count"
        assert len(leaf_witness_values) == self.num_leaves, "leaf count"
        if backend == "auto":
            backend = "native" if native_available() else "python"
        if backend == "native":
            return self._evaluate_native(instance_values, leaf_witness_values)
        return self._evaluate_python(instance_values, leaf_witness_values)

    # -- python replay (test oracle / fallback) -------------------------

    def _evaluate_python(self, instance_values, leaf_witness_values):
        p = self.p
        z = [0] * self.n_vars
        z[0] = 1
        for i, v in enumerate(instance_values):
            z[1 + i] = v % p
        for c, v in zip(self.leaf_cols, leaf_witness_values):
            z[c] = v % p
        cols, coeffs = self._lc_cols, self._lc_coeffs

        def ev(s, e):
            return sum(coeffs[i] * z[cols[i]] for i in range(s, e)) % p

        for op, a0, a1, b0, b1, out, n_out, aux in self._ops:
            if op == _OP_MUL:
                z[out] = ev(a0, a1) * ev(b0, b1) % p
            elif op == _OP_INV:
                z[out] = pow(ev(a0, a1), -1, p)
            elif op == _OP_ISZERO:
                a = ev(a0, a1)
                z[out] = 1 if a == 0 else 0
                z[out + 1] = 0 if a == 0 else pow(a, -1, p)
            elif op == _OP_BITS:
                a = ev(a0, a1)
                for i in range(n_out):
                    z[out + i] = (a >> i) & 1
            elif op == _OP_DIVMOD:
                q, r = divmod(ev(a0, a1), self._moduli[aux])
                z[out], z[out + 1] = q % p, r % p
        return z

    # -- native replay ---------------------------------------------------

    def evaluate_bytes(
        self, instance_values: Sequence[int], leaf_witness_values: Sequence[int]
    ) -> Tuple[bytes, int]:
        """Native replay returning (raw LE assignment bytes, stride) —
        avoids materializing Python ints when the consumer re-packs into
        limbs anyway (Groth16 prove path)."""
        from .. import native

        if self._native is None:
            self._native = native.pack_witness_tape(
                self.p, self._ops, self._lc_cols, self._lc_coeffs, self._moduli
            )
            self._preset_cols = np.concatenate(
                [
                    np.arange(1 + self.num_instance, dtype=np.int32),
                    np.asarray(self.leaf_cols, dtype=np.int32),
                ]
            )
        assert self._native is not None, "native library not built"
        preset_vals = (
            [1]
            + [v % self.p for v in instance_values]
            + [v % self.p for v in leaf_witness_values]
        )
        z = native.witness_eval(
            self._native, self.n_vars, self._preset_cols, preset_vals
        )
        return z, self._native["stride"]

    def _evaluate_native(self, instance_values, leaf_witness_values):
        z, stride = self.evaluate_bytes(instance_values, leaf_witness_values)
        return [
            int.from_bytes(z[i * stride : (i + 1) * stride], "little")
            for i in range(self.n_vars)
        ]

    def evaluate_limbs(
        self, instance_values: Sequence[int], leaf_witness_values: Sequence[int]
    ) -> np.ndarray:
        """Full canonical assignment as planar (n_limbs, n_vars) uint32
        limbs, the input format of `Groth16.prove_assigned`. With the native
        library built, the evaluator's little-endian byte buffer is viewed
        as u16 limbs and transposed (no Python ints); without it the Python
        replay's ints are packed."""
        n_limbs = -(-self.p.bit_length() // 16)
        if not native_available():
            z = self._evaluate_python(instance_values, leaf_witness_values)
            return limb._ints_to_limbs(np.array(z, dtype=object), n_limbs)
        z, stride = self.evaluate_bytes(instance_values, leaf_witness_values)
        n16 = stride // 2
        assert n16 >= n_limbs, (stride, n_limbs)
        u16 = np.frombuffer(z, dtype="<u2").reshape(self.n_vars, n16)
        # high u16 words beyond n_limbs are zero (values are canonical < p)
        return np.ascontiguousarray(u16.T[:n_limbs]).astype(np.uint32)
