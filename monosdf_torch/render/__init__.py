"""Result-video rendering over a reconstructed mesh (monosdf_tpu/render)."""

from .trajectory import (
    interpolate_poses,
    render_mesh_frame,
    render_trajectory,
    poses_from_cameras,
)

__all__ = [
    "interpolate_poses",
    "render_mesh_frame",
    "render_trajectory",
    "poses_from_cameras",
]
