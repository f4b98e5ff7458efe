"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with its options fixed at construction."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self._args = dict(ignore_index=ignore_index, reduction=reduction,
                          soft_label=soft_label, axis=axis,
                          use_softmax=use_softmax,
                          label_smoothing=label_smoothing)

    def forward(self, input, label):
        return F.cross_entropy(input, label, weight=self._weight,
                               **self._args)
