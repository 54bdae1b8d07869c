from .marching import marching_tetrahedra
from .extract import extract_mesh, mesh_sdf_fn, sdf_grid_eval
from .alt_extract import (
    get_surface_trace,
    get_surface_high_res_mesh,
    get_surface_by_grid,
    mesh_components,
    mesh_topology,
)
from .ply import write_ply, read_ply

__all__ = ["marching_tetrahedra", "extract_mesh", "mesh_sdf_fn", "sdf_grid_eval",
           "get_surface_trace", "get_surface_high_res_mesh", "get_surface_by_grid",
           "mesh_components", "mesh_topology", "write_ply", "read_ply"]
