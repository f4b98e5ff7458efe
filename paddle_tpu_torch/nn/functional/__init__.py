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
from .common import (alpha_dropout, bilinear, channel_shuffle,
                     cosine_similarity, dropout, dropout2d, dropout3d,
                     embedding, fold, interpolate, label_smooth, linear,
                     normalize, one_hot, pad, pixel_shuffle, pixel_unshuffle,
                     unfold, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy, binary_cross_entropy_with_logits,
                   cross_entropy, ctc_loss, hinge_embedding_loss, kl_div,
                   l1_loss, log_loss, margin_ranking_loss, mse_loss, nll_loss,
                   sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm, rms_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
from ...ops.activation import (celu, elu, gelu, hardshrink, hardsigmoid,
                               hardswish, hardtanh, leaky_relu, log_sigmoid,
                               log_softmax, maxout, mish, prelu, relu, relu6,
                               rrelu, selu, sigmoid, silu, softmax, softplus,
                               softshrink, softsign, tanh, tanhshrink,
                               thresholded_relu)

swish = silu

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "alpha_dropout", "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "batch_norm", "bilinear", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "calc_reduced_attn_scores",
           "celu", "channel_shuffle", "conv1d", "conv1d_transpose", "conv2d",
           "conv2d_transpose", "conv3d", "conv3d_transpose",
           "cosine_similarity", "cross_entropy", "ctc_loss", "dropout",
           "dropout2d", "dropout3d", "elu", "embedding", "flash_attention",
           "flash_attn_qkvpacked", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention", "fold",
           "fused_softmax_mask", "fused_softmax_mask_upper_triangle", "gelu",
           "group_norm", "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
           "hinge_embedding_loss", "instance_norm", "interpolate", "kl_div",
           "l1_loss", "label_smooth", "layer_norm", "leaky_relu", "linear",
           "local_response_norm", "log_loss", "log_sigmoid", "log_softmax",
           "margin_ranking_loss", "max_pool1d", "max_pool2d", "max_pool3d",
           "maxout", "mish", "mse_loss", "nll_loss", "normalize", "one_hot",
           "pad", "pixel_shuffle", "pixel_unshuffle", "prelu", "relu", "relu6",
           "rms_norm", "rrelu", "scaled_dot_product_attention", "selu",
           "sigmoid", "sigmoid_focal_loss", "silu", "smooth_l1_loss",
           "softmax", "softmax_with_cross_entropy", "softplus", "softshrink",
           "softsign", "square_error_cost", "swish", "tanh", "tanhshrink",
           "thresholded_relu", "triplet_margin_loss", "unfold", "upsample"]
