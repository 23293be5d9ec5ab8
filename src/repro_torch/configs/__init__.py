"""Arch registry: a copy of the JAX package's configs (same names, same
published dims), so the port never imports ``repro``."""

from .base import (
    ModelConfig,
    InputShape,
    SHAPES,
    shape_applicable,
    get_config,
    list_archs,
    reduced,
    register,
)
from . import archs  # noqa: F401  (populates the registry)
