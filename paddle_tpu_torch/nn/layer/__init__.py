"""Layers of the port, every one a ``Layer``, routed through its AMP-aware
functionals."""
from .activation import (CELU, ELU, GELU, Hardshrink, Hardsigmoid,
                         Hardswish, Hardtanh, LeakyReLU, LogSigmoid,
                         LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU,
                         SELU, SiLU, Sigmoid, Silu, Softmax, Softplus,
                         Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                         ThresholdedReLU)
from .common import (AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity,
                     Dropout, Dropout2D, Dropout3D, Embedding, Flatten, Fold,
                     Identity, LayerNorm, Linear, Pad1D, Pad2D, Pad3D,
                     PixelShuffle, PixelUnshuffle, RMSNorm, Unfold, Upsample,
                     UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .layers import Layer
from .loss import (BCELoss, BCEWithLogitsLoss, CTCLoss, CrossEntropyLoss,
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MSELoss,
                   MarginRankingLoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,
                  SimpleRNN, SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AlphaDropout", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BCELoss",
           "BCEWithLogitsLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "BiRNN", "Bilinear", "CELU", "CTCLoss",
           "ChannelShuffle", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "CosineSimilarity",
           "CrossEntropyLoss", "Dropout", "Dropout2D", "Dropout3D", "ELU",
           "Embedding", "Flatten", "Fold", "GELU", "GRU", "GRUCell",
           "GroupNorm", "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
           "HingeEmbeddingLoss", "Identity", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "KLDivLoss", "L1Loss", "LSTM",
           "LSTMCell", "Layer", "LayerDict", "LayerList", "LayerNorm",
           "LeakyReLU", "Linear", "LocalResponseNorm", "LogSigmoid",
           "LogSoftmax", "MSELoss", "MarginRankingLoss", "MaxPool1D",
           "MaxPool2D", "MaxPool3D", "Maxout", "Mish", "MultiHeadAttention",
           "NLLLoss", "PReLU", "Pad1D", "Pad2D", "Pad3D", "ParameterList",
           "PixelShuffle", "PixelUnshuffle", "RMSNorm", "RNN", "RNNCellBase",
           "RReLU", "ReLU", "ReLU6", "SELU", "Sequential", "SiLU", "Sigmoid",
           "Silu", "SimpleRNN", "SimpleRNNCell", "SmoothL1Loss", "Softmax",
           "Softplus", "Softshrink", "Softsign", "SpectralNorm", "Swish",
           "SyncBatchNorm", "Tanh", "Tanhshrink", "ThresholdedReLU",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "TripletMarginLoss", "Unfold", "Upsample", "UpsamplingBilinear2D",
           "UpsamplingNearest2D", "ZeroPad2D"]
