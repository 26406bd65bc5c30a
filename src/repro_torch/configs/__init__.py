from .base import (ArchConfig, ShapeCell, SHAPES, all_configs, get_config,
                   register)
from . import archs as _archs

ALL_ARCHS = tuple(a.name for a in _archs.ALL)

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "all_configs", "get_config",
           "register", "ALL_ARCHS"]
