"""Device meshes over a `torch.distributed` process group.

Port of `openzl_tpu/parallel/mesh.py`. Where the reference's `Mesh` is a
1-D array of JAX devices driven by one program, the port's is one rank of
an SPMD program: every rank runs the same calls, holds its own shard and
meets the others in the mesh's two collectives. The caller initializes
the default group first, as `torchrun` or `torch.multiprocessing.spawn`
with `torch.distributed.init_process_group` does
(`openzl_tpu_torch.parallel.launch.RankPool` is one such launcher).

The collectives follow the group's backend: with NCCL, device tensors go
straight in (one rank a GPU); with gloo, they go through host copies and
come back to the rank's device (ranks on the CPU, or ranks sharing one
card). Limbs travel as their int32 tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "data_mesh", "local_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a 1-D mesh: the process group, the mesh's global
    ranks in mesh order, this rank's index among them, the axis name and
    this rank's device."""

    group: object
    ranks: tuple
    rank: int
    axis: str
    device: torch.device

    def __post_init__(self) -> None:
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh runs on CUDA devices, not {self.device}")

    @property
    def size(self) -> int:
        """The number of ranks (the reference's `mesh.devices.size`)."""
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t if self.backend == "nccl" else t.cpu()

    def all_gather(self, v: torch.Tensor) -> torch.Tensor:
        """Every rank's `v` stacked on a new trailing axis in mesh order:
        `jax.lax.all_gather(v, axis, axis=v.ndim)`."""
        src = self._send(v)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts, dim=-1).to(v.device)

    def all_to_all(self, v: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """`jax.lax.all_to_all(v, axis, split_axis, concat_axis, tiled=True)`:
        `v` is cut into `size` blocks along `split_axis`, block j goes to
        rank j, and the blocks a rank receives are concatenated along
        `concat_axis` in mesh order. `all_to_all_single` exchanges along
        dim 0, so the split axis moves to the front and back again."""
        n, nd = self.size, v.ndim
        split_axis, concat_axis = split_axis % nd, concat_axis % nd
        if split_axis == concat_axis:
            raise ValueError("split_axis and concat_axis must differ")
        if v.shape[split_axis] % n:
            raise ValueError(f"axis {split_axis} of {tuple(v.shape)} does not split into {n} blocks")
        x = self._send(v.movedim(split_axis, 0))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        # (n, k, rest): block i from rank i; k back to the split axis, then
        # the rank index merged into the concat axis as its outer factor
        y = out.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).movedim(1, split_axis + 1)
        y = y.movedim(0, concat_axis)
        shape = list(y.shape)
        merged = shape[:concat_axis] + [n * shape[concat_axis + 1]] + shape[concat_axis + 2:]
        return y.reshape(merged).to(v.device)


#: sub-groups made by `local_mesh`, by the default group and their ranks:
#: each is made once, by every rank in the same order (`new_group` is
#: collective), and a new default group gets new ones
_GROUPS: dict = {}


def _default_device() -> torch.device:
    """The rank's current CUDA device; raises where CUDA is missing."""
    return torch.device("cuda", torch.cuda.current_device())


def local_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Optional[Mesh]:
    """1-D mesh over the first n ranks of the default group (default: all).

    Every rank of the default group calls it, because a sub-group is made
    collectively; a rank outside the first n gets None. `device` is this
    rank's device, by default its current CUDA device (one rank a GPU
    under NCCL, each rank's own choice under gloo); pass "cpu" for ranks
    on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("initialize the default process group (torch.distributed) before making a mesh")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    ranks = tuple(range(n))
    if n == world:
        group = dist.group.WORLD
    else:
        key = (dist.group.WORLD, ranks)
        if key not in _GROUPS:
            _GROUPS[key] = dist.new_group(list(ranks))
        group = _GROUPS[key]
    me = dist.get_rank()
    if me not in ranks:
        return None
    device = _default_device() if device is None else torch.device(device)
    return Mesh(group, ranks, ranks.index(me), axis, device)


def data_mesh(axis: str = "data", device=None) -> Mesh:
    """Global 1-D data mesh across every rank of the default group, on
    one host or many (`init_process_group` with a TCP or file store)."""
    return local_mesh(None, axis, device)
