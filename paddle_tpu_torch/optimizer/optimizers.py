"""Adam and AdamW (port of ``paddle_tpu/optimizer/optimizers.py``).

The JAX package's update rule, step for step. Moments are f32. The update
is computed in f32 from the parameter read in its own dtype and is stored
back in the parameter's dtype: there is no separate f32 master copy, so a
bf16 parameter rounds at every update (and AdamW's decoupled decay rounds
it once more before the Adam step). ``torch.optim.AdamW`` keeps its
moments in the parameter's dtype, which is not this rule. A step updates
all parameters at once through ``ops/cuda/adamw.py``: the multi-tensor
kernel for CUDA parameters, its plain per-tensor version for CPU ones.

Not ported, each raising ``NotImplementedError``: ``amsgrad``,
``lazy_mode``, ``lr_ratio`` and ``apply_decay_param_fun`` (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

from ..device import DEFAULT_DEVICE
from ..ops.cuda import adamw
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


def _unported(name: str):
    return NotImplementedError(f"{name} is not ported yet (ROADMAP.md, "
                               "queue 1)")


class Adam(Optimizer):
    _accum_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, amsgrad=False, *,
                 device=DEFAULT_DEVICE):
        if lazy_mode:
            raise _unported("lazy_mode")
        if amsgrad:
            raise _unported("amsgrad")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._coeff = 0.0

    def _update(self, live, lr):
        params = [p for _, p in live]
        adamw.adamw_update(
            params, [p.grad for p in params],
            [self._get_accumulator("moment1", i, p) for i, p in live],
            [self._get_accumulator("moment2", i, p) for i, p in live],
            lr, self._step_tensor, beta1=self._beta1, beta2=self._beta2,
            eps=self._eps, coeff=self._coeff,
            weight_decay=self._weight_decay, device=self._device)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p ← p·(1 − lr·decay)`` in f32,
    stored in the parameter's dtype, then the Adam step. Decay applies to
    every parameter, as in the JAX package when no
    ``apply_decay_param_fun`` is given."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, amsgrad=False, *, device=DEFAULT_DEVICE):
        if lr_ratio is not None:
            raise _unported("lr_ratio")
        if apply_decay_param_fun is not None:
            raise _unported("apply_decay_param_fun")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, amsgrad, device=device)
        self._coeff = float(weight_decay)
