"""Neural-network building blocks of the port: the layers (linear,
embedding, normalization, convolution, pooling, containers), the gradient
clips (``nn.ClipGradBy*``) and ``CrossEntropyLoss``."""
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, GradientClipBase,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, Conv1D, Conv2D, Conv3D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten, LayerNorm,
                    Linear, MaxPool2D, ReLU, RMSNorm, Sequential,
                    SyncBatchNorm)

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ClipGradBase",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Conv1D", "Conv2D", "Conv3D", "CrossEntropyLoss", "Dropout",
           "Embedding", "Flatten", "GradientClipBase",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "LayerNorm", "Linear", "MaxPool2D", "ReLU",
           "RMSNorm", "Sequential", "SyncBatchNorm"]
