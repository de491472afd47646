from .base import (ARCH_NAMES, SHAPES, ModelConfig, ParallelConfig,
                   ShapeConfig, TrainConfig, apply_overrides, get_config,
                   smoke_config)
