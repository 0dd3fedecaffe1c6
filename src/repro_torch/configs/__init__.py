from .base import ARCH_IDS, SHAPES, ArchConfig, get_config, shape_spec

__all__ = ["ArchConfig", "get_config", "ARCH_IDS", "SHAPES", "shape_spec"]
