"""Neural-network building blocks of the port: the layers (linear,
embedding, normalization, convolution, pooling, containers), the gradient
clips (``nn.ClipGradBy*``) and ``CrossEntropyLoss``."""
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, GradientClipBase,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                    BatchNorm3D, Conv1D, Conv2D, Conv3D, CrossEntropyLoss,
                    Dropout, Embedding, Flatten, LayerList, LayerNorm, Linear,
                    MaxPool2D, ReLU, ReLU6, RMSNorm, Sequential, SiLU,
                    Sigmoid, Silu, Softplus, SyncBatchNorm)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "ClipGradBase", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv1D", "Conv2D", "Conv3D",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten",
           "GradientClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "LayerList",
           "LayerNorm", "Linear", "MaxPool2D", "ReLU", "ReLU6", "RMSNorm",
           "Sequential", "SiLU", "Sigmoid", "Silu", "Softplus",
           "SyncBatchNorm"]


def __getattr__(name):
    if name == "Layer":
        raise NotImplementedError(
            "paddle_tpu_torch.nn.Layer is not ported yet (ROADMAP.md, queue "
            "1 item 1, the top level's leftovers): the port's layers are "
            "torch.nn.Module s")
    raise AttributeError(f"module 'paddle_tpu_torch.nn' has no attribute "
                         f"{name!r}")
