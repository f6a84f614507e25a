from .base import (ARCHS, SHAPES, ModelConfig, ShapeConfig, get_config,  # noqa: F401
                   get_shape, reduced_config)
