"""Dataset converters and cue tooling (monosdf_tpu/preprocess), on the
port's own image readers and the device resize (``ops/resize.py``)."""

from .common import unit_cube_scale_mat, center_crop_resize, write_cameras
from .scannet import convert_scannet
from .nice_slam import convert_nice_slam
from .dtu_pad import pad_dtu_cues
from .highres_stitch import create_patches, merge_patches

__all__ = [
    "unit_cube_scale_mat",
    "center_crop_resize",
    "write_cameras",
    "convert_scannet",
    "convert_nice_slam",
    "pad_dtu_cues",
    "create_patches",
    "merge_patches",
]
