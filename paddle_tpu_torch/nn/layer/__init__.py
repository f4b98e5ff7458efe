"""Layers of the port that route through its AMP-aware functionals."""
from .activation import ReLU
from .common import Dropout, Embedding, Flatten, LayerNorm, Linear, RMSNorm
from .container import Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm)
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv2D", "Conv3D",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten",
           "LayerNorm", "Linear", "MaxPool2D", "ReLU", "RMSNorm",
           "Sequential", "SyncBatchNorm"]
