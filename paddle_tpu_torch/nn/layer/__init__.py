"""Layers of the port that route through its AMP-aware functionals."""
from .common import LayerNorm, Linear, RMSNorm
from .loss import CrossEntropyLoss

__all__ = ["CrossEntropyLoss", "LayerNorm", "Linear", "RMSNorm"]
