"""Validation dashboards, colormaps and the metrics writer (monosdf_tpu/viz)."""

from .colormap import disp_colormap, normal_to_rgb
from .plots import get_plot_data, plot, lin2img
from .tb import MetricsWriter

__all__ = [
    "disp_colormap",
    "normal_to_rgb",
    "get_plot_data",
    "plot",
    "lin2img",
    "MetricsWriter",
]
