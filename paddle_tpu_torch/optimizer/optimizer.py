"""Optimizer base (port of ``paddle_tpu/optimizer/optimizer.py``).

The update runs over the parameters' own storage, in place under
``no_grad``. Accumulators are f32 whatever the parameter's dtype, as
``_get_accumulator`` makes them. The learning rate and the step count live
in device scalars: the LR scalar is refreshed only when ``get_lr()``
changes, so a constant-LR step sends nothing from the host, and the bias
correction reads the step count on the device. A step inside a CUDA graph
capture must find the LR scalar current (``TrainStep`` refreshes it before
each call): a refresh captured into the graph would replay a stale LR. The
LR scalar is f32, as the JAX ``TrainStep``'s traced LR cell is, so an
update rule follows the dtypes jnp gives its expressions with that f32
LR: a low-precision gradient times the LR is an f32 product.

As in the JAX package:

- ``learning_rate`` is a float or an ``optimizer.lr`` scheduler, whose
  ``step()`` the caller drives; ``set_lr`` raises under a scheduler;
- ``parameters`` is a list of parameters or of groups, dicts with
  ``"params"`` and optionally ``"learning_rate"`` (a factor on the LR) and
  ``"weight_decay"``;
- a parameter's LR is ``lr × optimize_attr["learning_rate"] × group
  "learning_rate"``, one f32 multiply each; its L2 coefficient comes from
  the optimizer's (or its group's) ``weight_decay``, overridden by its own
  ``regularizer`` (``Optimizer._decayed_grad``). The port reads
  ``optimize_attr``, ``regularizer`` and ``need_clip`` from the
  ``nn.Parameter`` with ``getattr`` defaults;
- ``grad_clip`` (``nn.ClipGradBy*``) is applied to the gradients before the
  update;
- ``state_dict`` holds the accumulators, ``"@step"`` and, under a
  scheduler, ``"LR_Scheduler"``.

The port keys accumulators by the parameter's index in the flat parameter
list (``"<index>_<name>"``), where the JAX package keys them by its
process-wide parameter names. An ``amp.GradScaler`` hands the optimizer
its unscaled f32 gradients (``_set_grad``) and the overflow flag
(``_skip_if``), under which a step changes no parameter, accumulator or
step count.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.cuda.adamw import tensor_lr
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    _accum_names: List[str] = []
    # whether ``_update`` honours ``_skip_if`` itself (the AdamW kernel):
    # else ``step`` snapshots every cell and selects the old values back
    _skips_in_update = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, *,
                 device=DEFAULT_DEVICE):
        if parameters is None:
            raise ValueError("parameters must be provided (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"optimizer.lr scheduler, got "
                            f"{type(learning_rate).__name__}")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = [dict(g, params=list(g["params"]))
                                  for g in params]
            params = [p for g in self._param_groups for p in g["params"]]
        else:
            self._param_groups = [{"params": params}]
        self._device = resolve_device(device)
        for p in params:
            if p.device.type != self._device.type:
                raise ValueError(f"a parameter lies on {p.device}, the "
                                 f"optimizer was asked for {self._device}")
        self._parameter_list = params
        self._index = {id(p): i for i, p in enumerate(params)}
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        dev = params[0].device if params else self._device
        self._step_tensor = torch.zeros((), dtype=torch.int32, device=dev)
        self._lr_cell = torch.zeros((), dtype=torch.float32, device=dev)
        self._lr_host = None
        # gradients handed over by GradScaler.unscale_, by id(parameter)
        self._grads: Dict[int, torch.Tensor] = {}
        # the overflow flag of GradScaler.step, a device bool, or None
        self._skip_if = None

    # ------------------------------------------------ lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler

    def _device_lr(self) -> torch.Tensor:
        """The LR as an f32 device scalar, written only when it changed;
        raises if it changed while a CUDA graph is being captured."""
        lr = self.get_lr()
        if lr != self._lr_host:
            if self._lr_cell.is_cuda and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the learning rate changed inside a CUDA graph capture: "
                    "refresh it before the capture (TrainStep does)")
            self._lr_cell.fill_(lr)
            self._lr_host = lr
        return self._lr_cell

    @staticmethod
    def _lr_factors(p, group) -> tuple:
        """The factors on the LR for ``p`` in ``group``, in the JAX order:
        its ``optimize_attr`` learning rate, then its group's."""
        attr = getattr(p, "optimize_attr", None) or {}
        return (float(attr.get("learning_rate", 1.0)),
                float(group.get("learning_rate", 1.0)))

    def _param_lr(self, lr: torch.Tensor, p, group) -> torch.Tensor:
        return tensor_lr(lr, self._lr_factors(p, group))

    # ------------------------------------------------ accumulators
    def _get_accumulator(self, name: str, index: int, param: torch.Tensor,
                         fill: float = 0.0) -> torch.Tensor:
        store = self._accumulators.setdefault(name, {})
        if index not in store:
            store[index] = torch.full(param.shape, fill, dtype=torch.float32,
                                      device=param.device)
        return store[index]

    def _prime_accumulators(self) -> None:
        """Every accumulator made now (a skipped step's snapshot must hold
        the cells the step will write)."""
        for i, p in enumerate(self._parameter_list):
            if p.requires_grad:
                for name in self._accum_names:
                    self._get_accumulator(name, i, p)

    def _state_cells(self) -> List[torch.Tensor]:
        return [t for store in self._accumulators.values()
                for t in store.values()]

    # ------------------------------------------------ gradients
    def _grad_of(self, p):
        """The gradient the next step reads: the one a GradScaler handed
        over, else ``p.grad``."""
        g = self._grads.get(id(p))
        return p.grad if g is None else g

    def _set_grad(self, p, g: torch.Tensor) -> None:
        self._grads[id(p)] = g

    @staticmethod
    def _l2_coeff(p, weight_decay):
        """The L2 coefficient of ``p``: from ``weight_decay`` (a float or a
        regularizer), overridden by ``p.regularizer``; None when
        ``weight_decay`` is None."""
        if weight_decay is None:
            return None
        coeff = getattr(weight_decay, "coeff", weight_decay)
        reg = getattr(p, "regularizer", None)
        if reg is not None:
            coeff = getattr(reg, "coeff", coeff)
        return float(coeff)

    @classmethod
    def _decayed_grad(cls, p, g, weight_decay):
        """L2 decay folded into the gradient: ``g + coeff · p``
        (:meth:`_l2_coeff`); ``g`` when ``weight_decay`` is None."""
        coeff = cls._l2_coeff(p, weight_decay)
        return g if coeff is None else g + coeff * p

    def _group_weight_decay(self, group):
        return group.get("weight_decay", self._weight_decay)

    # ------------------------------------------------ core
    def _collect(self) -> list:
        """``(index, parameter, gradient, group)`` of every trainable
        parameter that has a gradient, group by group."""
        out = []
        for group in self._param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                g = self._grad_of(p)
                if g is not None:
                    out.append((self._index[id(p)], p, g, group))
        return out

    @torch.no_grad()
    def step(self) -> None:
        entries = self._collect()
        if self._grad_clip is not None and entries:
            clipped = self._grad_clip([(p, g) for _, p, g, _ in entries])
            entries = [(i, p, g, group) for (i, _, _, group), (p, g)
                       in zip(entries, clipped)]
        skip = self._skip_if
        old_step = self._step_tensor.clone() if skip is not None else None
        self._step_tensor += 1
        lr = self._device_lr()
        if entries and skip is not None and not self._skips_in_update:
            self._prime_accumulators()
            cells = [p for p in self._parameter_list if p.requires_grad]
            cells += self._state_cells()
            old = [c.clone() for c in cells]
            self._update(entries, lr)
            for c, o in zip(cells, old):
                c.copy_(torch.where(skip, o, c))
        elif entries:
            self._update(entries, lr)
        if old_step is not None:
            self._step_tensor.copy_(torch.where(skip, old_step,
                                                self._step_tensor))

    def _update(self, entries, lr: torch.Tensor) -> None:
        """Update every ``(index, parameter, gradient, group)`` of
        ``entries``: by default one ``_apply_one`` each."""
        for i, p, g, group in entries:
            self._apply_one(i, p, g, self._param_lr(lr, p, group),
                            self._group_weight_decay(group))

    def _apply_one(self, index, p, g, lr, weight_decay) -> None:
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, self._grad_of(p)) for p in self._parameter_list]

    def clear_grad(self, set_to_zero: bool = False) -> None:
        """Drop every gradient (``set_to_zero``: zero it in place
        instead)."""
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None
        self._grads = {}

    clear_gradients = clear_grad

    # ------------------------------------------------ state dict
    def state_dict(self) -> dict:
        """Accumulators under ``"<parameter index>_<name>"``, the step
        count under ``"@step"``, the scheduler's state under
        ``"LR_Scheduler"``."""
        out = {f"{i}_{name}": t for name, store in self._accumulators.items()
               for i, t in sorted(store.items())}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = int(self._step_tensor.item())
        return out

    @torch.no_grad()
    def set_state_dict(self, state: dict) -> None:
        """Restore what :meth:`state_dict` gave."""
        for key, value in state.items():
            index, sep, name = key.partition("_")
            if not sep or not index.isdigit():
                continue
            i = int(index)
            if i >= len(self._parameter_list):
                raise KeyError(f"{key}: no parameter {i}")
            cell = self._get_accumulator(name, i, self._parameter_list[i])
            cell.copy_(torch.as_tensor(value))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(dict(state["LR_Scheduler"]))
        if "@step" in state:
            self._step_tensor.fill_(int(state["@step"]))
