"""Training and serving across ranks on ``torch.distributed`` (counterpart
of ``topiaxl/parallel``): meshes of ranks, the collectives the port uses,
tensor parallelism (``sharding``), context parallelism over the K/V ring
(``context``) and the GPipe pipeline (``pipeline``)."""

from .context import make_cp_forward
from .mesh import Mesh, make_hybrid_mesh, make_mesh, mesh_from_config
from .pipeline import (
    make_pp_forward,
    make_pp_train_step,
    shard_pp_params,
    stack_dit_params,
    unstack_dit_params,
)
from .sharding import (
    batch_sharding,
    dit_param_rules,
    gather_params,
    sequence_sharding,
    shard_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_hybrid_mesh",
    "make_cp_forward",
    "mesh_from_config",
    "dit_param_rules",
    "shard_params",
    "gather_params",
    "batch_sharding",
    "sequence_sharding",
    "stack_dit_params",
    "unstack_dit_params",
    "shard_pp_params",
    "make_pp_forward",
    "make_pp_train_step",
]
