from .metrics import (
    chamfer_distance,
    f_score,
    mesh_metrics_3d,
    normal_consistency,
    psnr,
    sample_mesh_surface,
)

__all__ = ["chamfer_distance", "f_score", "mesh_metrics_3d", "normal_consistency", "psnr",
           "sample_mesh_surface"]
