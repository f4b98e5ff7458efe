"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): each the
functional of its name with its options fixed at construction, the loss a
``paddle.Tensor``."""
from __future__ import annotations


from ...core.tensor import wrap
from .. import functional as F
from .layers import Layer

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CTCLoss", "CrossEntropyLoss",
           "HingeEmbeddingLoss", "KLDivLoss", "L1Loss", "MSELoss",
           "MarginRankingLoss", "NLLLoss", "SmoothL1Loss",
           "TripletMarginLoss"]


class CrossEntropyLoss(Layer):
    """``F.cross_entropy`` with its options fixed at construction; the
    loss comes back as a ``paddle.Tensor`` (``loss.numpy()``, ``.item()``
    as in Paddle)."""

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
        return wrap(F.cross_entropy(input, label, weight=self._weight,
                                    **self._args))


class _Loss(Layer):
    """A loss layer over ``F.<_fn>``: ``forward(*inputs)`` passes the
    inputs, then ``_args`` (positionally, as the JAX layers pass them)."""
    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, *inputs):
        return wrap(getattr(F, self._fn)(*inputs, *self._args))


class MSELoss(_Loss):
    _fn = "mse_loss"

    def __init__(self, reduction="mean"):
        super().__init__(reduction)


class L1Loss(_Loss):
    _fn = "l1_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction, delta)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight, reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight, reduction, pos_weight)


class NLLLoss(_Loss):
    _fn = "nll_loss"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight, ignore_index, reduction)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction, log_target)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin, p, epsilon, swap, reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin, reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank, self._reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return wrap(F.ctc_loss(log_probs, labels, input_lengths,
                               label_lengths, self._blank, self._reduction,
                               norm_by_times))
