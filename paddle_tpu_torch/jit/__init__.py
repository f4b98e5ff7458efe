"""``paddle.jit`` for the port: the eager ``TrainStep`` and shape bucketing."""
from .api import TrainStep

__all__ = ["TrainStep"]
