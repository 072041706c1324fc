from repro_torch.configs.base import SHAPES, SMOKE_SHAPE, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config

__all__ = ["SHAPES", "SMOKE_SHAPE", "ModelConfig", "ShapeConfig", "ARCHS",
           "get_config", "smoke_config"]
