"""Layers of the port that route through its AMP-aware functionals."""
from .common import Dropout, Embedding, LayerNorm, Linear, RMSNorm
from .loss import CrossEntropyLoss

__all__ = ["CrossEntropyLoss", "Dropout", "Embedding", "LayerNorm",
           "Linear", "RMSNorm"]
