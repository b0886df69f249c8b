"""Training and serving across ranks on ``torch.distributed`` (counterpart
of ``topiaxl/parallel``): meshes of ranks, the collectives the port uses,
and context parallelism over the K/V ring. Pipeline and tensor
parallelism are not ported."""

from .context import make_cp_forward
from .mesh import Mesh, make_mesh, mesh_from_config

__all__ = ["Mesh", "make_mesh", "mesh_from_config", "make_cp_forward"]
