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

# the architectures of the dry run's sweep (``launch.dryrun --all``)
ASSIGNED_ARCHS = [
    "whisper-medium",
    "qwen3-moe-30b-a3b",
    "olmoe-1b-7b",
    "gemma-7b",
    "starcoder2-15b",
    "glm4-9b",
    "mistral-large-123b",
    "llava-next-mistral-7b",
    "hymba-1.5b",
    "rwkv6-7b",
]
