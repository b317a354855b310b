"""The lattice split over a mesh of devices: the port of ``fdtd_tpu.parallel``
(free space, BASELINE config 5, and absorbing runs, config 3 split).

One process drives a ``Mesh`` of ``torch.device``s, which may name one
card several times (``make_mesh(devices=["cuda:0"] * 4)``): the shards run
one after another, and the halo exchange is ``copy_`` of planes between
their tensors. ``ShardedSimulation`` plans the sharded K-tick kernel (K9,
``cuda_sharded_k``, on K2's edge planes) or the plain sharded step
(``sharded``); K8 (``cuda_sharded``) is the one-tick kernel. Absorbing
runs plan the sharded K-tick CPML kernel (K10, ``cuda_sharded_cpml``, on
K4e x-side, or K10 ``blocks`` on K6 x-side) or the sharded engine
(``sharded_engine``) through ``best_sharded_absorbing_step``; a mesh that
cuts lattice z runs the kernels in a rotated frame (``rotation``).
"""

from .best import best_sharded_absorbing_step, kernel_dense, kernel_lateral_axis
from .cuda_sharded import make_cuda_sharded_step, plain_sharded_step
from .cuda_sharded_cpml import (
    collapse_pml_state,
    extend_matid,
    extend_pml_state,
    extract_sharded_dft_acc,
    init_sharded_pml_state,
    make_cuda_sharded_cpml_stepk,
    plain_sharded_cpml_stepk,
    sharded_gb_plan,
    supports_sharded_cpml,
)
from .cuda_sharded_k import (
    collapse_state,
    extend_state,
    extract_slice,
    make_cuda_sharded_stepk,
    plain_sharded_stepk,
)
from .rotation import unrotate_fields, zcut_rotation
from .sharded import ShardedState, gather, make_sharded_step, shard_state
from .sharded_engine import (
    ShardedEngineState,
    gather_engine_state,
    init_sharded_engine_state,
    make_sharded_engine_step,
    shard_engine_state,
)
from .simulation import ShardedSimulation
from .topology import Mesh, choose_mesh_shape, make_mesh

__all__ = [
    "best_sharded_absorbing_step",
    "kernel_dense",
    "kernel_lateral_axis",
    "collapse_pml_state",
    "extend_matid",
    "extend_pml_state",
    "extract_sharded_dft_acc",
    "init_sharded_pml_state",
    "make_cuda_sharded_cpml_stepk",
    "plain_sharded_cpml_stepk",
    "sharded_gb_plan",
    "supports_sharded_cpml",
    "make_cuda_sharded_step",
    "plain_sharded_step",
    "collapse_state",
    "extend_state",
    "extract_slice",
    "make_cuda_sharded_stepk",
    "plain_sharded_stepk",
    "unrotate_fields",
    "zcut_rotation",
    "ShardedEngineState",
    "gather_engine_state",
    "init_sharded_engine_state",
    "make_sharded_engine_step",
    "shard_engine_state",
    "ShardedState",
    "gather",
    "make_sharded_step",
    "shard_state",
    "ShardedSimulation",
    "Mesh",
    "choose_mesh_shape",
    "make_mesh",
]
