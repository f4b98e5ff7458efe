"""Functional ops of the port (``paddle.nn.functional`` parity, ported subset)."""
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, linear
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "dropout", "flash_attention", "layer_norm",
           "linear", "rms_norm", "scaled_dot_product_attention"]
