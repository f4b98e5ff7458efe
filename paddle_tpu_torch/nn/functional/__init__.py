"""Functional ops of the port (``paddle.nn.functional`` parity, ported subset)."""
# the flash_attention submodule first, then the function of the same name
# bound over it, as in the JAX package: F.flash_attention(...) is the
# function, and ``from ...nn.functional.flash_attention import
# flashmask_attention`` finds the module through sys.modules
from .flash_attention import (calc_reduced_attn_scores, flash_attn_qkvpacked,
                              flash_attn_unpadded,
                              flash_attn_varlen_qkvpacked,
                              flashmask_attention, fused_softmax_mask,
                              fused_softmax_mask_upper_triangle)
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .conv import conv1d, conv2d, conv3d
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import batch_norm, layer_norm, rms_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d
from ...ops.activation import gelu, relu, tanh

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "batch_norm",
           "calc_reduced_attn_scores", "conv1d", "conv2d", "conv3d",
           "cross_entropy", "dropout", "embedding", "flash_attention",
           "flash_attn_qkvpacked", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "fused_softmax_mask", "fused_softmax_mask_upper_triangle", "gelu",
           "layer_norm", "linear", "max_pool2d", "relu", "rms_norm",
           "scaled_dot_product_attention", "softmax_with_cross_entropy",
           "tanh"]
