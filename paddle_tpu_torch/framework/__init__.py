"""``paddle.framework`` for the port: ``save``/``load`` (``io``)."""
from .io import load, save

__all__ = ["load", "save"]
