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
from .common import (dropout, embedding, interpolate, label_smooth, linear,
                     one_hot, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy_with_logits, cross_entropy,
                   softmax_with_cross_entropy)
from .norm import batch_norm, group_norm, instance_norm, layer_norm, rms_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool2d,
                      max_pool2d)
from ...ops.activation import (celu, elu, gelu, hardshrink, hardsigmoid,
                               hardswish, hardtanh, leaky_relu, log_sigmoid,
                               log_softmax, maxout, mish, prelu, relu, relu6,
                               rrelu, selu, sigmoid, silu, softmax, softplus,
                               softshrink, softsign, tanh, tanhshrink,
                               thresholded_relu)

swish = silu

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d", "avg_pool2d",
           "batch_norm", "binary_cross_entropy_with_logits",
           "calc_reduced_attn_scores", "celu", "conv1d", "conv1d_transpose",
           "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
           "cross_entropy", "dropout", "elu", "embedding", "flash_attention",
           "flash_attn_qkvpacked", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "fused_softmax_mask", "fused_softmax_mask_upper_triangle", "gelu",
           "group_norm", "instance_norm",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "interpolate", "label_smooth", "layer_norm", "leaky_relu",
           "linear", "log_sigmoid", "log_softmax", "max_pool2d", "maxout",
           "mish", "one_hot", "prelu", "relu", "relu6", "rms_norm", "rrelu",
           "scaled_dot_product_attention", "selu", "sigmoid", "silu",
           "softmax", "softmax_with_cross_entropy", "softplus", "softshrink",
           "softsign", "swish", "tanh", "tanhshrink", "thresholded_relu",
           "upsample"]
