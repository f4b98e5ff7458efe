"""Layers of the port that route through its AMP-aware functionals."""
from .common import LayerNorm, Linear, RMSNorm

__all__ = ["LayerNorm", "Linear", "RMSNorm"]
