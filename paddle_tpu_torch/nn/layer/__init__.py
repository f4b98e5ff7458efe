"""Layers of the port, every one a ``Layer``, routed through its AMP-aware
functionals."""
from .activation import (CELU, ELU, GELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         SELU, SiLU, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (Dropout, Embedding, Flatten, Identity, LayerNorm, Linear,
                     RMSNorm)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layers import Layer
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool2D,
                      MaxPool2D)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "CELU", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "SpectralNorm",
           "CrossEntropyLoss", "Dropout", "ELU", "Embedding", "Flatten",
           "GELU", "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
           "Identity", "Layer", "LayerDict", "LayerList", "LayerNorm",
           "LeakyReLU", "Linear", "LogSigmoid", "LogSoftmax", "MaxPool2D",
           "Maxout", "Mish", "MultiHeadAttention", "PReLU", "ParameterList",
           "RMSNorm", "RReLU", "ReLU", "ReLU6", "SELU", "Sequential", "SiLU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "SyncBatchNorm", "Tanh", "Tanhshrink",
           "ThresholdedReLU", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
