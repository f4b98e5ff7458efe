"""``paddle.vision`` for the port: the models (``vision.models``, their
names exported here too, as in the JAX package), the detection ops
(``vision.ops``), the transforms (``vision.transforms``) and the datasets
(``vision.datasets``)."""
from . import datasets, models, ops, transforms
from .models import *  # noqa: F401,F403
from .models import __all__ as _models
from .models import resnet, segdet, small

__all__ = ["datasets", "models", "ops", "resnet", "segdet", "small",
           "transforms"] + list(_models)
