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
from .common import dropout, linear
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["calc_reduced_attn_scores", "cross_entropy", "dropout",
           "flash_attention", "flash_attn_qkvpacked", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "fused_softmax_mask", "fused_softmax_mask_upper_triangle",
           "layer_norm", "linear", "rms_norm", "scaled_dot_product_attention",
           "softmax_with_cross_entropy"]
