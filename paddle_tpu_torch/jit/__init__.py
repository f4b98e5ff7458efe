"""``paddle.jit`` for the port: ``TrainStep``, the ``CompiledFunction``
graph cache it runs on, and shape bucketing."""
from .api import TrainStep
from .functionalize import CompiledFunction

__all__ = ["CompiledFunction", "TrainStep"]
