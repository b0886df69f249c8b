from .isosurface import extract_isosurface
from .meshproc import clean_mesh, decimate_mesh, isotropic_remesh
from .glb import write_glb
from .uv_unwrap import box_projection_uv_unwrap, compute_vertex_normal, pack_islands
from .lscm import quality_uv_unwrap
from .rasterize import rasterize_uv_atlas
from .inpaint import nearest_inpaint

__all__ = [
    "extract_isosurface",
    "clean_mesh",
    "decimate_mesh",
    "isotropic_remesh",
    "write_glb",
    "box_projection_uv_unwrap",
    "quality_uv_unwrap",
    "compute_vertex_normal",
    "pack_islands",
    "rasterize_uv_atlas",
    "nearest_inpaint",
]
