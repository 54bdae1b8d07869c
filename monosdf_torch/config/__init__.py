"""HOCON confs and the typed configs they build (monosdf_tpu/config)."""

from .hocon import HoconError, merge_configs, parse_hocon, parse_hocon_file
from ..models.monosdf import routed_kernels
from .schema import ExperimentConfig, build_configs, load_conf

__all__ = ["HoconError", "merge_configs", "parse_hocon", "parse_hocon_file", "ExperimentConfig",
           "build_configs", "load_conf", "routed_kernels"]
