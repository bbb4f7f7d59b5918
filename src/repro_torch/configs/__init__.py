from .registry import ARCH_IDS, get_config, smoke_config
from .shapes import SHAPES, ShapeSpec, applicable_shapes

__all__ = [
    "ARCH_IDS",
    "get_config",
    "smoke_config",
    "SHAPES",
    "ShapeSpec",
    "applicable_shapes",
]
