"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``): softmax
cross entropy in full, ``softmax_with_cross_entropy``, the binary cross
entropies, the regression losses (``mse_loss``, ``square_error_cost``,
``l1_loss``, ``smooth_l1_loss``, ``log_loss``), ``nll_loss``, ``kl_div``,
the margin losses (``margin_ranking_loss``, ``hinge_embedding_loss``,
``triplet_margin_loss``), ``sigmoid_focal_loss`` and ``ctc_loss``, each as
the JAX function computes it.

``ctc_loss`` is the JAX log-space forward pass, one step a time frame, in
torch ops; its gradient is autograd's through that pass, as JAX's is
through its ``lax.scan``. torch's native ``ctc_loss`` does not serve: its
backward assumes its input is a ``log_softmax`` output, and on raw
log-probabilities its gradient is not this function's
(``tests/test_torch_losses.py`` holds both). ``nll_loss`` zeroes an
``ignore_index`` label's term, upstream Paddle's meaning; the JAX function
gathers at the ignored index out of range and returns NaN there
(ROADMAP.md, divergences inside the reference)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs
from ...core.tensor import plain

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cross_entropy", "ctc_loss", "hinge_embedding_loss", "kl_div",
           "l1_loss", "log_loss", "margin_ranking_loss", "mse_loss",
           "nll_loss", "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss"]


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
    # plain: a Tensor's softmax/log_softmax methods are Paddle's, which
    # torch's functional forms call
    z, w = cast_inputs("cross_entropy", plain(input), weight)
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
        return loss, TF.softmax(plain(logits), dim=axis)
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
    soft = _softplus_abs(z)
    zero = z.new_zeros(())
    if pw is not None:
        out = (1 - y) * z + ((pw - 1) * y + 1) * (soft
                                                  + torch.maximum(-z, zero))
    else:
        out = torch.maximum(z, zero) - z * y + soft
    if w is not None:
        out = out * w
    return _reduce(out, reduction)


def _softplus_abs(z):
    """``log(1 + exp(-|z|))`` with ``jnp.abs``'s gradient at 0."""
    return torch.log1p(torch.exp(-torch.where(z >= 0, z, -z)))


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """Huber's loss times ``delta``, as Paddle scales it."""
    d = input - label
    ad = torch.abs(d)
    out = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(out * delta, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """Cross entropy of probabilities, each log taken at least 1e-12."""
    out = -(label * torch.log(torch.clamp_min(input, 1e-12))
            + (1 - label) * torch.log(torch.clamp_min(1 - input, 1e-12)))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """The negative log-likelihood of ``label`` under ``input`` (``[N, C]``
    or ``[N, C, d...]`` log-probabilities), times the label's ``weight``;
    0 where the label is ``ignore_index``. ``mean`` divides by the summed
    weights of the valid labels (at least 1e-12)."""
    c = input.shape[1]
    lp = input.movedim(1, -1).reshape(-1, c) if input.dim() > 2 else input
    y = label.reshape(-1)
    valid = y != ignore_index
    idx = torch.where(valid, y, 0)
    picked = lp.gather(1, idx[:, None])[:, 0]
    w = weight[idx] if weight is not None else torch.ones_like(picked)
    v = valid.to(lp.dtype)
    out = -picked * w * v
    if reduction == "mean":
        return out.sum() / torch.clamp_min((w * v).sum(), 1e-12)
    if reduction == "sum":
        return out.sum()
    return out.reshape(label.shape)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    """``label · (log label − input)`` (``exp(label)·(label − input)`` with
    ``log_target``); ``batchmean`` divides the sum by the batch."""
    if log_target:
        out = torch.exp(label) * (label - input)
    else:
        out = label * (torch.log(torch.clamp_min(label, 1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp_min(-label * (input - other) + margin, 0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    out = torch.where(label == 1, input, torch.clamp_min(margin - input, 0.0))
    return _reduce(out, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """``max(d(a, pos) − d(a, neg) + margin, 0)`` with ``d`` the ``p``-norm
    of the difference (``epsilon`` is read nowhere, as in JAX)."""
    def dist(a, b):
        return torch.sum(torch.abs(a - b) ** p, dim=-1) ** (1 / p)

    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dist(input, positive) - dn + margin, 0.0),
                   reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """The focal loss ``a_t · (1 − p_t)^gamma · CE`` on the sigmoid of
    ``logit``, over ``normalizer`` when given."""
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0.0) - logit * label + _softplus_abs(logit)
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


_CTC_NEG = -1e30


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC's negative log-likelihood of ``labels`` (``[B, S]``, lengths
    ``label_lengths``) under ``log_probs`` (``[T, B, C]``, lengths
    ``input_lengths``): the log-space forward pass over the blank-extended
    labels, with the alpha read at each sequence's last frame. ``mean``
    divides each loss by its label length (at least 1) and averages;
    ``norm_by_times`` is read nowhere, as in JAX."""
    lp = log_probs
    t_len, b, _ = lp.shape
    s = labels.shape[1]
    dev = lp.device
    labels = labels.to(device=dev, dtype=torch.long)
    in_len = torch.as_tensor(input_lengths, device=dev).long()
    lab_len = torch.as_tensor(label_lengths, device=dev).long()
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    neg = lp.new_full((), _CTC_NEG)
    first_lab = torch.where(lab_len > 0, lp[0].gather(1, ext[:, 1:2])[:, 0],
                            neg)
    alpha = torch.cat([lp[0, :, blank, None], first_lab[:, None],
                       lp.new_full((b, 2 * s - 1), _CTC_NEG)], dim=1)
    same_as_2back = torch.cat([torch.ones(b, 2, dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = lp.new_full((b, 1), _CTC_NEG)
    pad2 = lp.new_full((b, 2), _CTC_NEG)
    alphas = [alpha]
    for t in range(1, t_len):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(same_as_2back, neg,
                         torch.cat([pad2, alpha[:, :-2]], dim=1))
        alpha = (torch.logaddexp(torch.logaddexp(alpha, a1), a2)
                 + lp[t].gather(1, ext))
        alphas.append(alpha)
    all_alphas = torch.stack(alphas)  # [T, B, 2S + 1]
    t_idx = torch.clamp(in_len - 1, 0, t_len - 1)
    at_t = all_alphas.gather(
        0, t_idx[None, :, None].expand(1, b, 2 * s + 1))[0]
    last = 2 * lab_len + 1
    pos1 = at_t.gather(1, torch.clamp(last - 1, 0, 2 * s)[:, None])[:, 0]
    pos2 = at_t.gather(1, torch.clamp(last - 2, 0, 2 * s)[:, None])[:, 0]
    loss = -torch.logaddexp(pos1, torch.where(lab_len > 0, pos2, neg))
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(lab_len.to(loss.dtype), 1.0))
    if reduction == "sum":
        return loss.sum()
    return loss
