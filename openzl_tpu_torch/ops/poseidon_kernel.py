"""Kernels K5 (classic Poseidon) and K6 (optimized Poseidon).

Port of `openzl_tpu/ops/poseidon_kernel.py`. The CUDA source is
`openzl_tpu_torch/csrc/poseidon_kernel.cu` (design notes there); this module
holds the wrappers, launch counters and plain torch versions.

A state batch is (n_limbs, width, B) int32 Montgomery limbs, the layout of
the whole port; the kernels read and write it directly, so nothing is
re-laid out around a launch. The round constants and matrices go to the
kernel as one int32 buffer of 32-bit words, built once per device
(`words_buffer`).

K5 has two variants at width 3, both kernels: "wide", one thread per
state, and "split", four lanes per state with half the serial chain of
products, for batches too narrow to fill the card (the upper levels of a
Merkle build). `variant(B)` picks "split" up to `SPLIT_MAX_B` states. K5
and K6 are built at every width in `KERNEL_WIDTHS` (2 to 17); at widths
other than 3 they run one kernel with the width as an argument ("wide"
only), and a state of another width is refused before any launch.

Dispatch: a CUDA tensor launches the kernel (a failed build or launch
raises), a CPU tensor runs the plain version. Nothing moves between devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import limb
from ..utils import build
from . import ntt_kernel
from .ntt_kernel import device_kind, mont_mul_plain

K5 = build.KernelInfo(
    name="poseidon_permute",
    source="openzl_tpu_torch/csrc/poseidon_kernel.cu",
    replaces="openzl_tpu/ops/poseidon_kernel.py:158",
)
K6 = build.KernelInfo(
    name="poseidon_permute_opt",
    source="openzl_tpu_torch/csrc/poseidon_kernel.cu",
    replaces="openzl_tpu/ops/poseidon_kernel.py:198",
)

#: the state widths and the limb count the kernels are built for: arity 1
#: to 16 (the reference's pinned widths 2-6, 9 and 17, and the searched
#: ones between) over a 254/255-bit field (BN254 Fr, BLS12-381 Fr)
KERNEL_WIDTHS = tuple(range(2, 18))
KERNEL_LIMBS = 16
#: the width of K5's split variant (and of the Merkle tree's hash)
SPLIT_WIDTH = 3

#: K5 runs the split variant up to this many states, the wide one above:
#: where the two variants' times cross on the H100 (`tools/kernel_probe.py`;
#: PERF.md)
SPLIT_MAX_B = 10240
VARIANTS = ("wide", "split")


def variant(batch: int, width: int = SPLIT_WIDTH) -> str:
    """The K5 variant the wrapper launches for `batch` states of `width`
    elements: "split" only at width 3."""
    return "split" if width == SPLIT_WIDTH and batch <= SPLIT_MAX_B else "wide"


def words(arr: np.ndarray, limb_axis: int) -> np.ndarray:
    """16-bit limb array -> 32-bit little-endian words on the LAST axis
    (the limb axis moved there and halved), as uint32."""
    a = np.moveaxis(np.asarray(arr, dtype=np.uint32), limb_axis, -1)
    pairs = a.reshape(a.shape[:-1] + (a.shape[-1] // 2, 2))
    return (pairs[..., 0] | (pairs[..., 1] << np.uint32(16))).astype(np.uint32)


def words_buffer(parts, device) -> torch.Tensor:
    """Concatenate uint32 word arrays (and small ints) into one flat int32
    device tensor, the constant buffer a kernel stages in shared memory."""
    flat = np.concatenate([np.asarray(p, dtype=np.uint32).reshape(-1) for p in parts])
    return torch.as_tensor(flat.view(np.int32).copy(), device=device)


def check_state(perm, state: torch.Tensor, widths=KERNEL_WIDTHS) -> None:
    """The shape, type and layout a permutation kernel takes, at one of the
    state `widths` it is built for."""
    n, w = perm.spec.n_limbs, perm.width
    if state.dtype != torch.int32 or state.ndim != 3 or tuple(state.shape[:2]) != (n, w):
        raise ValueError(f"state must be int32 (n_limbs={n}, width={w}, B): {state.dtype} {tuple(state.shape)}")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if w not in widths or n != KERNEL_LIMBS:
        raise ValueError(f"the kernel is built for widths {', '.join(map(str, widths))} and {KERNEL_LIMBS} "
                         f"limbs, not width {w} and {n} limbs")


def pow5_plain(spec, x: torch.Tensor) -> torch.Tensor:
    """x^5 in Montgomery form: two squarings and a product."""
    x2 = mont_mul_plain(spec, x, x)
    x4 = mont_mul_plain(spec, x2, x2)
    return mont_mul_plain(spec, x4, x)


# ---------------------------------------------------------------------------
# plain torch versions (the jnp round functions of the reference)
# ---------------------------------------------------------------------------


def _limb_tensors(perm, device):
    """The parameter arrays as int32 limb tensors on `device`."""
    names = ("round_keys", "mds", "opt_initial", "opt_full_keys", "opt_partial_keys",
             "opt_pre_sparse", "opt_w_hat", "opt_v_rest")
    return perm.tensors("limbs", device, lambda: {k: limb.tensor(getattr(perm, k), device) for k in names})


def _sum_axis(spec, prod: torch.Tensor, axis: int) -> torch.Tensor:
    """The sum mod p over `axis`, pairwise: each step adds the first half
    to the second (an odd element waits), so n terms take log2(n) steps."""
    while prod.shape[axis] > 1:
        n, half = prod.shape[axis], prod.shape[axis] // 2
        total = limb.add(spec, prod.narrow(axis, 0, half), prod.narrow(axis, half, half))
        prod = torch.cat([total, prod.narrow(axis, n - 1, 1)], dim=axis) if n % 2 else total
    return prod.select(axis, 0)


def _mds_mul(spec, mat: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """out_i = sum_j M[i][j] x_j; mat (n, w, w), state (n, w, B)."""
    return _sum_axis(spec, mont_mul_plain(spec, state[:, None], mat[..., None]), 2)


def _mat_mul_left(spec, mat: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Row vector at left: out_j = sum_i x_i M[i][j] (the optimized
    matrices are not symmetric)."""
    return _sum_axis(spec, mont_mul_plain(spec, state[:, :, None], mat[..., None]), 1)


def permute_plain(perm, state: torch.Tensor) -> torch.Tensor:
    """Plain torch K5 on (n_limbs, width, B)."""
    spec = perm.spec
    t = _limb_tensors(perm, state.device)
    keys, mds = t["round_keys"], t["mds"]
    half = perm.full_rounds // 2
    for r in range(perm.rounds):
        state = limb.add(spec, state, keys[r][..., None])
        if half <= r < half + perm.partial_rounds:
            state = torch.cat([pow5_plain(spec, state[:, :1]), state[:, 1:]], dim=1)
        else:
            state = pow5_plain(spec, state)
        state = _mds_mul(spec, mds, state)
    return state


def permute_optimized_plain(perm, state: torch.Tensor) -> torch.Tensor:
    """Plain torch K6 on (n_limbs, width, B)."""
    spec = perm.spec
    t = _limb_tensors(perm, state.device)
    fkeys, mds = t["opt_full_keys"], t["mds"]
    half = perm.full_rounds // 2

    def full_round(state, keys):
        return _mds_mul(spec, mds, limb.add(spec, pow5_plain(spec, state), keys[..., None]))

    state = limb.add(spec, state, t["opt_initial"][..., None])
    for r in range(half - 1):
        state = full_round(state, fkeys[r])
    state = limb.add(spec, pow5_plain(spec, state), fkeys[half - 1][..., None])
    state = _mat_mul_left(spec, t["opt_pre_sparse"], state)
    for r in range(perm.partial_rounds):
        head = limb.add(spec, pow5_plain(spec, state[:, :1]), t["opt_partial_keys"][r][:, None, None])
        state = torch.cat([head, state[:, 1:]], dim=1)
        out0 = _sum_axis(spec, mont_mul_plain(spec, state, t["opt_w_hat"][r][..., None]), 1)
        rest = limb.add(spec, state[:, 1:], mont_mul_plain(spec, head, t["opt_v_rest"][r][..., None]))
        state = torch.cat([out0[:, None], rest], dim=1)
    for r in range(half, perm.full_rounds - 1):
        state = full_round(state, fkeys[r])
    return _mds_mul(spec, mds, pow5_plain(spec, state))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _classic_words(perm, device) -> torch.Tensor:
    """[round keys (rounds, w, NW); MDS (w, w, NW)] as words."""
    return perm.tensors("k5", device, lambda: words_buffer(
        [words(np.moveaxis(perm.round_keys, 1, 2), 2), words(np.moveaxis(perm.mds, 0, 2), 2)], device,
    ))


def _optimized_words(perm, device) -> torch.Tensor:
    """[initial (w, NW); full keys (R_F - 1, w, NW); partial keys (R_P, NW);
    pre-sparse transposed (w, w, NW); MDS (w, w, NW); w_hat (R_P, w, NW);
    v_rest (R_P, w - 1, NW)] as words. The kernel applies pre-sparse at
    left (out_j = sum_i x_i M[i][j]): its row j here is column j of the
    matrix, so that every product the kernel runs is a row."""
    return perm.tensors("k6", device, lambda: words_buffer([
        words(perm.opt_initial, 0),
        words(np.moveaxis(perm.opt_full_keys, 1, 2), 2),
        words(perm.opt_partial_keys, 1),
        words(np.moveaxis(perm.opt_pre_sparse, 0, 2).swapaxes(0, 1), 2),
        words(np.moveaxis(perm.mds, 0, 2), 2),
        words(np.moveaxis(perm.opt_w_hat, 1, 2), 2),
        words(np.moveaxis(perm.opt_v_rest, 1, 2), 2),
    ], device))


def _launch(entry: str, kernel: build.KernelInfo, perm, state, consts, *head) -> torch.Tensor:
    check_state(perm, state)
    p_words, n0 = ntt_kernel.word_consts(perm.spec)
    out = torch.empty_like(state)
    B = state.shape[2]
    code = getattr(build.lib(), entry)(
        out.data_ptr(), state.data_ptr(), consts.data_ptr(), B, *head, perm.width,
        perm.full_rounds, perm.partial_rounds, perm.spec.n_limbs, p_words.ctypes.data, n0,
        build.stream_ptr(state),
    )
    build.check(code, f"{kernel.name}")
    kernel.count(B, state_width=perm.width)
    return out


def permute(perm, state: torch.Tensor, which: str | None = None) -> torch.Tensor:
    """Classic Poseidon on (n_limbs, width, B) (K5). On the card `which`
    ("wide", or "split" at width 3) forces a variant; by default
    `variant(B, width)` picks."""
    if device_kind(state) == "cpu":
        return permute_plain(perm, state)
    which = which or variant(state.shape[2], perm.width)
    if which not in VARIANTS:
        raise ValueError(f"K5 variant {which!r} is not one of {VARIANTS}")
    if which == "split" and perm.width != SPLIT_WIDTH:
        raise ValueError(f"K5's split variant is built for width {SPLIT_WIDTH} only, not width {perm.width}")
    return _launch("ozl_poseidon_permute", K5, perm, state, _classic_words(perm, state.device),
                   int(which == "split"))


def permute_optimized(perm, state: torch.Tensor) -> torch.Tensor:
    """Optimized Poseidon on (n_limbs, width, B) (K6); the same output as K5."""
    if device_kind(state) == "cpu":
        return permute_optimized_plain(perm, state)
    return _launch("ozl_poseidon_permute_opt", K6, perm, state, _optimized_words(perm, state.device))
