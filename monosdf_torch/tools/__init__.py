"""Experiment-directory tools (monosdf_tpu/tools): checkpoint and plot
garbage collection, run transfer."""

from .cleanup import gc_checkpoints, gc_plots, gc_experiments

__all__ = ["gc_checkpoints", "gc_plots", "gc_experiments"]
