"""``paddle.vision`` for the port: the models (``vision.models``)."""
from . import models

__all__ = ["models"]
