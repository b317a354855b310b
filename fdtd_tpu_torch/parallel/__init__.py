"""The lattice split over a mesh of devices: the port of ``fdtd_tpu.parallel``
(its free-space part: BASELINE config 5).

One process drives a ``Mesh`` of ``torch.device``s, which may name one
card several times (``make_mesh(devices=["cuda:0"] * 4)``): the shards run
one after another, and the halo exchange is ``copy_`` of planes between
their tensors. ``ShardedSimulation`` plans the sharded K-tick kernel (K9,
``cuda_sharded_k``, on K2's edge planes) or the plain sharded step
(``sharded``); K8 (``cuda_sharded``) is the one-tick kernel.
"""

from .best import kernel_lateral_axis
from .cuda_sharded import make_cuda_sharded_step, plain_sharded_step
from .cuda_sharded_k import (
    collapse_state,
    extend_state,
    extract_slice,
    make_cuda_sharded_stepk,
    plain_sharded_stepk,
)
from .sharded import ShardedState, gather, make_sharded_step, shard_state
from .simulation import ShardedSimulation
from .topology import Mesh, choose_mesh_shape, make_mesh

__all__ = [
    "kernel_lateral_axis",
    "make_cuda_sharded_step",
    "plain_sharded_step",
    "collapse_state",
    "extend_state",
    "extract_slice",
    "make_cuda_sharded_stepk",
    "plain_sharded_stepk",
    "ShardedState",
    "gather",
    "make_sharded_step",
    "shard_state",
    "ShardedSimulation",
    "Mesh",
    "choose_mesh_shape",
    "make_mesh",
]
