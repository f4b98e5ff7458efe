"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``): softmax
cross entropy in full, ``softmax_with_cross_entropy`` and
``binary_cross_entropy_with_logits``."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["binary_cross_entropy_with_logits", "cross_entropy",
           "softmax_with_cross_entropy"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Softmax cross entropy of ``input`` over ``axis``, as the JAX package
    computes it. Hard labels index the class axis (a trailing size-1 axis
    is squeezed); soft labels (``soft_label``, or float labels of the
    input's shape) are distributions. ``use_softmax=False`` takes ``input``
    as probabilities (``log(max(p, 1e-12))``). Hard labels: 0 where the
    label is ``ignore_index``; ``label_smoothing`` mixes the one-hot
    target with the uniform one; class ``weight`` scales each label's
    term, and ``mean`` divides by the summed weights of the valid labels
    (their count without weights, at least 1e-12). ``reduction`` is
    ``mean``, ``sum`` or ``none``. Under AMP it computes in f32 (op
    ``cross_entropy``, black list); outside AMP in the input's dtype."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy reduction {reduction!r}: mean, sum "
                         f"or none")
    z, w = cast_inputs("cross_entropy", input, weight)
    y = label
    logp = (TF.log_softmax(z, dim=axis) if use_softmax
            else torch.log(torch.clamp_min(z, 1e-12)))
    if soft_label or (y.dim() == z.dim() and y.shape == z.shape
                      and y.is_floating_point()):
        yy = y
        if label_smoothing > 0:
            yy = yy * (1 - label_smoothing) + label_smoothing / z.shape[axis]
        out = -torch.sum(yy * logp, dim=axis)
        return _reduce(out, reduction)
    if y.is_floating_point():
        raise TypeError("cross_entropy takes integer hard labels (or pass "
                        "soft_label=True)")
    yy = y
    if yy.dim() == z.dim() and yy.shape[axis] == 1:
        yy = yy.squeeze(axis)
    ax = axis % z.dim()
    valid = yy != ignore_index
    # an ignored label indexes class 0 instead: its term is zeroed below
    idx = torch.where(valid, yy, 0)
    if label_smoothing > 0:
        k = z.shape[ax]
        onehot = TF.one_hot(idx, k).to(logp.dtype).movedim(-1, ax)
        sm = onehot * (1 - label_smoothing) + label_smoothing / k
        out = -torch.sum(sm * logp, dim=ax)
    else:
        out = -logp.gather(ax, idx.unsqueeze(ax)).squeeze(ax)
    out = torch.where(valid, out, 0.0)
    if w is not None:
        wy = w[idx]
        if reduction == "mean":
            return torch.sum(out * wy) / torch.clamp_min(
                torch.sum(wy * valid.to(logp.dtype)), 1e-12)
        if reduction == "sum":
            return torch.sum(out * wy)
        return out * wy
    if reduction == "mean":
        return out.sum() / torch.clamp_min(valid.to(logp.dtype).sum(), 1e-12)
    if reduction == "sum":
        return out.sum()
    return out


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Per-example cross entropy with the class axis kept (size 1), and the
    softmax beside it when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, TF.softmax(logits, dim=axis)
    return loss


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """Sigmoid cross entropy of ``logit`` against ``label`` in the JAX
    function's stable form: ``max(z, 0) - z·y + log(1 + exp(-|z|))``, and
    with ``pos_weight`` ``(1 - y)·z + ((pw - 1)·y + 1)·(log(1 +
    exp(-|z|)) + max(-z, 0))``; times ``weight`` when given; ``reduction``
    ``mean``, ``sum`` or ``none``. Op ``bce_with_logits``: f32 under AMP
    (black list)."""
    z, y, w, pw = cast_inputs("bce_with_logits", logit, label, weight,
                              pos_weight)
    # |z| with jnp.abs's gradient (1 at 0, where torch's abs gives 0), and
    # torch.maximum, which splits a tie's gradient as jnp.maximum does
    soft = torch.log1p(torch.exp(-torch.where(z >= 0, z, -z)))
    zero = z.new_zeros(())
    if pw is not None:
        out = (1 - y) * z + ((pw - 1) * y + 1) * (soft
                                                  + torch.maximum(-z, zero))
    else:
        out = torch.maximum(z, zero) - z * y + soft
    if w is not None:
        out = out * w
    return _reduce(out, reduction)
