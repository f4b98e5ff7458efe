"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``): softmax
cross entropy over hard integer labels, the case
``GPTPretrainingCriterion`` reaches."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "mean"):
    """Softmax cross entropy of ``input`` logits over the last axis against
    integer ``label``, as the JAX package computes it: ``-log_softmax`` at
    the label, 0 where the label is ``ignore_index``, the sum divided by the
    count of valid labels. Under AMP O2 it computes in f32 (op
    ``cross_entropy``, black list); outside AMP in the logits' dtype. Other
    reductions, class weights, soft labels and label smoothing are not
    ported (ROADMAP.md, queue 1)."""
    if reduction != "mean":
        raise NotImplementedError(
            f"cross_entropy reduction {reduction!r} is not ported yet "
            "(ROADMAP.md, queue 1)")
    if label.is_floating_point():
        raise TypeError("cross_entropy takes integer labels")
    (z,) = cast_inputs("cross_entropy", input)
    logp = TF.log_softmax(z, dim=-1)
    valid = label != ignore_index
    picked = logp.gather(-1, torch.where(valid, label, 0).unsqueeze(-1))
    out = torch.where(valid, -picked.squeeze(-1), 0.0)
    return out.sum() / valid.to(logp.dtype).sum().clamp_min(1e-12)
