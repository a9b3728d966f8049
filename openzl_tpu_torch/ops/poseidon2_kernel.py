"""Kernel K7 (Poseidon2).

Port of `openzl_tpu/ops/poseidon2_kernel.py`. The CUDA source is
`openzl_tpu_torch/csrc/poseidon2_kernel.cu` (design notes there); this
module holds the wrapper, the launch counter and the plain torch version.
Layout and dispatch as in `poseidon_kernel`: (n_limbs, width, B) int32
Montgomery limbs; a CUDA tensor launches the kernel, a CPU tensor runs the
plain version. K7 is built at `KERNEL_WIDTHS`, every width Poseidon2 has
round numbers for; a state of another width is refused before any launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limb
from ..utils import build
from . import ntt_kernel
from .ntt_kernel import device_kind
from .poseidon_kernel import check_state, pow5_plain, words, words_buffer

K7 = build.KernelInfo(
    name="poseidon2_permute",
    source="openzl_tpu_torch/csrc/poseidon2_kernel.cu",
    replaces="openzl_tpu/ops/poseidon2_kernel.py:53",
)

#: the state widths K7 is built for (`ROUND_NUMBERS_128`'s)
KERNEL_WIDTHS = (2, 3, 4, 8, 12)


def _small_mul(spec, x: torch.Tensor, c: int) -> torch.Tensor:
    """c x for a small positive integer c, by doublings and additions."""
    acc, dbl = None, x
    while c:
        if c & 1:
            acc = dbl if acc is None else limb.add(spec, acc, dbl)
        c >>= 1
        if c:
            dbl = limb.add(spec, dbl, dbl)
    return acc


def _sum(spec, state: torch.Tensor) -> torch.Tensor:
    s = state[:, 0]
    for i in range(1, state.shape[1]):
        s = limb.add(spec, s, state[:, i])
    return s


def _ext_layer(perm, state: torch.Tensor) -> torch.Tensor:
    spec, w = perm.spec, perm.width
    if w in (2, 3):  # circ(2, 1[, 1]): x_i + sum x
        return limb.add(spec, state, _sum(spec, state)[:, None])
    from ..crypto.poseidon2 import external_matrix

    me = external_matrix(w)
    cols = []
    for i in range(w):
        acc = _small_mul(spec, state[:, 0], me[i][0])
        for j in range(1, w):
            acc = limb.add(spec, acc, _small_mul(spec, state[:, j], me[i][j]))
        cols.append(acc)
    return torch.stack(cols, dim=1)


def _int_layer(perm, state: torch.Tensor) -> torch.Tensor:
    """sum x + diag_i x_i for every i."""
    spec = perm.spec
    s = _sum(spec, state)
    return torch.stack([limb.add(spec, s, _small_mul(spec, state[:, i], d))
                        for i, d in enumerate(perm.diag)], dim=1)


def poseidon2_permute_plain(perm, state: torch.Tensor) -> torch.Tensor:
    """Plain torch K7 on (n_limbs, width, B)."""
    spec = perm.spec
    ext, ints = perm.tensors("limbs", state.device, lambda: (
        limb.tensor(perm.ext_keys, state.device), limb.tensor(perm.int_keys, state.device)))
    half = perm.full_rounds // 2

    def ext_round(state, keys):
        return _ext_layer(perm, pow5_plain(spec, limb.add(spec, state, keys[..., None])))

    state = _ext_layer(perm, state)
    for r in range(half):
        state = ext_round(state, ext[r])
    for r in range(perm.partial_rounds):
        head = pow5_plain(spec, limb.add(spec, state[:, :1], ints[r][:, None, None]))
        state = _int_layer(perm, torch.cat([head, state[:, 1:]], dim=1))
    for r in range(half, perm.full_rounds):
        state = ext_round(state, ext[r])
    return state


def _words(perm, device) -> torch.Tensor:
    """[ext keys (R_F, w, NW); int keys (R_P, NW); diagonal (w,)]."""
    return perm.tensors("k7", device, lambda: words_buffer([
        words(np.moveaxis(perm.ext_keys, 1, 2), 2),
        words(perm.int_keys, 1),
        np.asarray(perm.diag, dtype=np.uint32),
    ], device))


def permute(perm, state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on (n_limbs, width, B) (K7)."""
    if device_kind(state) == "cpu":
        return poseidon2_permute_plain(perm, state)
    check_state(perm, state, KERNEL_WIDTHS)
    consts = _words(perm, state.device)
    p_words, n0 = ntt_kernel.word_consts(perm.spec)
    out = torch.empty_like(state)
    code = build.lib().ozl_poseidon2_permute(
        out.data_ptr(), state.data_ptr(), consts.data_ptr(), state.shape[2], perm.width,
        perm.full_rounds, perm.partial_rounds, perm.spec.n_limbs, p_words.ctypes.data, n0,
        build.stream_ptr(state),
    )
    build.check(code, K7.name)
    K7.count(state.shape[2], state_width=perm.width)
    return out
