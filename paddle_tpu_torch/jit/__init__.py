"""``paddle.jit`` for the port: ``TrainStep``, the ``CompiledFunction``
graph cache it runs on, shape bucketing, and ``save``/``load`` of an
exported program (``serialization``)."""
from .api import TrainStep
from .functionalize import CompiledFunction
from .serialization import TranslatedLayer, load, save

__all__ = ["CompiledFunction", "TrainStep", "TranslatedLayer", "load", "save"]
