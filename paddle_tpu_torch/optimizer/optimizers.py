"""The optimizers (port of ``paddle_tpu/optimizer/optimizers.py``): SGD,
Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax, Lamb and LBFGS.

Each follows the JAX package's update rule step for step: f32
accumulators, and the result stored back in the parameter's dtype with no
f32 master copy, so a bf16 parameter rounds at every update. The LR is
the optimizer's f32 device scalar (times the parameter's factors), as the
JAX ``TrainStep`` traces it: where jnp multiplies a low-precision gradient
by that f32 LR the product is f32, and the port upcasts explicitly (torch
would keep a 0-d tensor's product in the gradient's dtype). A Python
scalar times a low-precision tensor stays in its dtype in both packages;
jnp rounds the scalar to that dtype first, torch computes with it in
f32, so such products may differ by an ulp of that dtype.

Adam and AdamW update every parameter at once through
``ops/cuda/adamw.py``, and Momentum through ``ops/cuda/momentum.py``: the
multi-tensor kernel for CUDA parameters, its plain per-tensor version for
CPU ones, with each tensor's LR and L2 coefficient (AdamW's decoupled decay
and ``amsgrad``), and the GradScaler's overflow skip read on the device.
The other optimizers are torch ops per parameter (the JAX versions are
jnp, which XLA fuses; none is a Pallas kernel).
``LBFGS.step(closure)`` runs eagerly and reads values to the host, as the
JAX one does; ``TrainStep`` cannot drive it in either package.

``lazy_mode``, ``multi_precision`` and ``use_multi_tensor`` are accepted
and read nowhere, as in the JAX package. AdamW's
``apply_decay_param_fun`` is given ``p.param_name`` where the JAX package
gives ``p.name`` (torch reserves ``Tensor.name``): the port's models name
each parameter by its qualified state-dict key (the JAX package names them
by a process-wide counter).
"""
from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE
from ..ops.cuda import adamw
from ..ops.cuda.momentum import momentum_update
from .optimizer import Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
           "Adadelta", "Adamax", "Lamb", "LBFGS"]


def _store(p, value: torch.Tensor) -> None:
    """``p ← value`` rounded to ``p``'s dtype."""
    p.copy_(value.to(p.dtype))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = self._decayed_grad(p, g, weight_decay)
        _store(p, p.float() - lr * gv.float())


class Momentum(Optimizer):
    _accum_names = ["velocity"]
    _skips_in_update = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, entries, lr):
        params, grads, vels, factors, wds = ([] for _ in range(5))
        for i, p, g, group in entries:
            params.append(p)
            grads.append(g)
            vels.append(self._get_accumulator("velocity", i, p))
            factors.append(self._lr_factors(p, group))
            wds.append(self._l2_coeff(p, self._group_weight_decay(group)))
        momentum_update(
            params, grads, vels, lr, momentum=self._momentum,
            nesterov=self._nesterov, weight_decay=wds, lr_factors=factors,
            found_inf=self._skip_if, device=self._device)


class Adam(Optimizer):
    _accum_names = ["moment1", "moment2"]
    _skips_in_update = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 use_multi_tensor=False, amsgrad=False, name=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        self._multi_precision = multi_precision
        if amsgrad:
            self._accum_names = self._accum_names + ["moment2_max"]

    def _decay_args(self, p, group):
        """``(extra LR factors, decoupled decay, L2 coefficient or None)``
        of ``p``: Adam's L2 decay only."""
        return (), 0.0, self._l2_coeff(p, self._group_weight_decay(group))

    def _update(self, entries, lr):
        params, grads, m, v, vmax, factors, coeffs, wds = ([] for _ in
                                                          range(8))
        for i, p, g, group in entries:
            extra, coeff, wd = self._decay_args(p, group)
            params.append(p)
            grads.append(g)
            m.append(self._get_accumulator("moment1", i, p))
            v.append(self._get_accumulator("moment2", i, p))
            if self._amsgrad:
                vmax.append(self._get_accumulator("moment2_max", i, p))
            factors.append(self._lr_factors(p, group) + extra)
            coeffs.append(coeff)
            wds.append(wd)
        adamw.adamw_update(
            params, grads, m, v, lr, self._step_tensor, beta1=self._beta1,
            beta2=self._beta2, eps=self._eps, coeff=coeffs,
            weight_decay=wds, lr_factors=factors,
            max_exp_avg_sqs=vmax if self._amsgrad else None,
            found_inf=self._skip_if, device=self._device)


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p ← p·(1 − lr·decay)`` in f32,
    stored in the parameter's dtype, then the Adam step. ``lr_ratio(p)``
    scales a parameter's LR; ``apply_decay_param_fun(p.param_name)`` False
    leaves it undecayed. As in the JAX package, a group's
    ``weight_decay`` is not read: the decay is the constructor's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, amsgrad=False,
                 name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name, device=device)
        self._coeff = float(getattr(weight_decay, "coeff", weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decay_args(self, p, group):
        extra = () if self._lr_ratio is None \
            else (float(self._lr_ratio(p)),)
        decay = self._coeff
        if self._apply_decay_param_fun is not None \
                and not self._apply_decay_param_fun(
                    getattr(p, "param_name", None)):
            decay = 0.0
        return extra, decay, None


class Adagrad(Optimizer):
    _accum_names = ["moment"]

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _prime_accumulators(self):
        for i, p in enumerate(self._parameter_list):
            if p.requires_grad:
                self._get_accumulator("moment", i, p, fill=self._init_acc)

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = self._decayed_grad(p, g, weight_decay)
        acc = self._get_accumulator("moment", i, p, fill=self._init_acc)
        acc_new = acc + gv * gv
        acc.copy_(acc_new)
        _store(p, p.float() - lr * gv.float() / (acc_new.sqrt() + self._eps))


class RMSProp(Optimizer):
    _accum_names = ["mean_square", "mean_grad", "momentum"]

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = self._decayed_grad(p, g, weight_decay)
        rho = self._rho
        ms = self._get_accumulator("mean_square", i, p)
        ms_new = rho * ms + (1 - rho) * gv * gv
        ms.copy_(ms_new)
        if self._centered:
            mg = self._get_accumulator("mean_grad", i, p)
            mg_new = rho * mg + (1 - rho) * gv
            mg.copy_(mg_new)
            denom = torch.sqrt(ms_new - mg_new * mg_new + self._eps)
        else:
            denom = torch.sqrt(ms_new + self._eps)
        mom = self._get_accumulator("momentum", i, p)
        mom_new = self._momentum * mom + lr * gv.float() / denom
        mom.copy_(mom_new)
        _store(p, p.float() - mom_new)


class Adadelta(Optimizer):
    _accum_names = ["avg_squared_grad", "avg_squared_update"]

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._rho, self._eps = rho, epsilon

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = self._decayed_grad(p, g, weight_decay)
        rho, eps = self._rho, self._eps
        ag = self._get_accumulator("avg_squared_grad", i, p)
        au = self._get_accumulator("avg_squared_update", i, p)
        ag_new = rho * ag + (1 - rho) * gv * gv
        update = -torch.sqrt((au + eps) / (ag_new + eps)) * gv
        au_new = rho * au + (1 - rho) * update * update
        ag.copy_(ag_new)
        au.copy_(au_new)
        _store(p, p.float() + lr * update)


class Adamax(Optimizer):
    _accum_names = ["moment", "inf_norm"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = self._decayed_grad(p, g, weight_decay)
        m = self._get_accumulator("moment", i, p)
        u = self._get_accumulator("inf_norm", i, p)
        t = self._step_tensor.float()
        m_new = self._beta1 * m + (1 - self._beta1) * gv
        u_new = torch.maximum(self._beta2 * u, torch.abs(gv))
        m.copy_(m_new)
        u.copy_(u_new)
        _store(p, p.float() - lr / (1 - self._beta1 ** t) * m_new
               / (u_new + self._eps))


class Lamb(Optimizer):
    _accum_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, *, device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device=device)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _apply_one(self, i, p, g, lr, weight_decay):
        gv = g.float()
        m = self._get_accumulator("moment1", i, p)
        v = self._get_accumulator("moment2", i, p)
        t = self._step_tensor.float()
        m_new = self._beta1 * m + (1 - self._beta1) * gv
        v_new = self._beta2 * v + (1 - self._beta2) * gv * gv
        m.copy_(m_new)
        v.copy_(v_new)
        mhat = m_new / (1 - self._beta1 ** t)
        vhat = v_new / (1 - self._beta2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._eps)
        decay = self._lamb_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            decay = 0.0
        p32 = p.float()
        update = r + decay * p32
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        u_norm = torch.sqrt(torch.sum(update * update))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        _store(p, p32 - lr * trust * update)


class LBFGS(Optimizer):
    """Limited-memory BFGS through a closure that re-evaluates the loss
    (and its gradients). Runs eagerly and reads values to the host, as the
    JAX one does."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 device=DEFAULT_DEVICE):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device=device)
        self._max_iter = max_iter
        self._history_size = history_size
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = []  # (s, y, rho) flat vectors

    def _flat_params(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._parameter_list])

    def _flat_grads(self) -> torch.Tensor:
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in self._parameter_list])

    @torch.no_grad()
    def _assign_flat(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def step(self, closure):
        lr = self.get_lr()
        with torch.enable_grad():
            loss = closure()
        g = self._flat_grads()
        x = self._flat_params()
        for _ in range(self._max_iter):
            if float(torch.max(torch.abs(g))) < self._tol_grad:
                break
            # two-loop recursion
            q = g
            alphas = []
            for s, y, rho in reversed(self._history):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if self._history:
                s, y, _ = self._history[-1]
                gamma = torch.dot(s, y) / torch.clamp_min(torch.dot(y, y),
                                                          1e-10)
            else:
                gamma = 1.0
            z = gamma * q
            for (s, y, rho), a in zip(self._history, reversed(alphas)):
                b = rho * torch.dot(y, z)
                z = z + s * (a - b)
            d = -z
            x_new = x + lr * d
            self._assign_flat(x_new)
            self.clear_grad()
            with torch.enable_grad():
                loss = closure()
            g_new = self._flat_grads()
            s_vec = x_new - x
            y_vec = g_new - g
            sy = torch.dot(s_vec, y_vec)
            if float(sy) > 1e-10:
                self._history.append((s_vec, y_vec, 1.0 / sy))
                if len(self._history) > self._history_size:
                    self._history.pop(0)
            if float(torch.max(torch.abs(x_new - x))) < self._tol_change:
                break
            x, g = x_new, g_new
        return loss
