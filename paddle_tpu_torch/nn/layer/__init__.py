"""Layers of the port that route through its AMP-aware functionals."""
from .activation import ReLU, ReLU6, SiLU, Sigmoid, Silu, Softplus
from .common import Dropout, Embedding, Flatten, LayerNorm, Linear, RMSNorm
from .container import LayerList, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool2D,
                      MaxPool2D)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Conv1D", "Conv2D", "Conv3D", "CrossEntropyLoss",
           "Dropout", "Embedding", "Flatten", "LayerList", "LayerNorm",
           "Linear", "MaxPool2D", "ReLU", "ReLU6", "RMSNorm", "Sequential",
           "SiLU", "Sigmoid", "Silu", "Softplus", "SyncBatchNorm"]
