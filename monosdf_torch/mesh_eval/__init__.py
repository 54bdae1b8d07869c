"""The mesh benchmark suites (monosdf_tpu/mesh_eval): the depth
rasterizer and the TSDF refuse on the device, culling, ICP and the ScanNet,
Replica and DTU protocols on the host."""

from .rasterize import rasterize_depth
from .cull import cull_by_frustum, cull_by_mask, apply_vertex_mask
from .tsdf import TSDFVolume, refuse_mesh
from .suites import eval_scannet, eval_replica, eval_dtu, icp_align

__all__ = [
    "rasterize_depth",
    "cull_by_frustum",
    "cull_by_mask",
    "apply_vertex_mask",
    "TSDFVolume",
    "refuse_mesh",
    "eval_scannet",
    "eval_replica",
    "eval_dtu",
    "icp_align",
]
