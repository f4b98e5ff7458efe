"""``paddle.vision`` for the port: the models (``vision.models``) and the
detection ops (``vision.ops``)."""
from . import models, ops

__all__ = ["models", "ops"]
