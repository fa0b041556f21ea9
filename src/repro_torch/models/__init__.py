from . import convert, layers, model, ssm
from .config import SHAPES, ArchConfig, ShapeConfig

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "model", "layers", "ssm",
           "convert"]
