"""``paddle.optimizer`` for the port: Adam and AdamW."""
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "Optimizer"]
