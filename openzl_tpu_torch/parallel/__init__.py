"""Multi-device execution on `torch.distributed`: meshes and sharded kernels.

Port of `openzl_tpu/parallel/`. The reference runs one program over a JAX
device mesh (`shard_map` with XLA collectives); here each rank of a
process group runs the same calls on its own device and shard, and the
ranks meet in all-gathers and one all-to-all (NCCL between GPUs, gloo
through host memory). `launch.RankPool` starts such ranks in spawned
processes.
"""

from .mesh import data_mesh, local_mesh
from .ops import (
    sharded_coset_intt,
    sharded_coset_ntt,
    sharded_intt,
    sharded_msm,
    sharded_msm_multi,
    sharded_ntt,
    sharded_poseidon_hash,
    sharded_transform,
)

__all__ = [
    "data_mesh",
    "local_mesh",
    "sharded_coset_intt",
    "sharded_coset_ntt",
    "sharded_intt",
    "sharded_msm",
    "sharded_msm_multi",
    "sharded_ntt",
    "sharded_poseidon_hash",
    "sharded_transform",
]
