"""Optimizer base (port of ``paddle_tpu/optimizer/optimizer.py``).

The update runs over the parameters' own storage, in place under
``no_grad``. Accumulators are f32 whatever the parameter's dtype, as
``_get_accumulator`` makes them. The learning rate and the step count live
in device scalars: the LR scalar is refreshed only when ``get_lr()``
changes, so a constant-LR step sends nothing from the host, and the bias
correction reads the step count on the device. A step inside a CUDA graph
capture must find the LR scalar current (``TrainStep`` refreshes it before
each call): a refresh captured into the graph would replay a stale LR.

Not ported, each raising ``NotImplementedError``: learning-rate scheduler
objects (``optimizer/lr.py``), ``grad_clip`` and parameter groups
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["Optimizer"]


class Optimizer:
    _accum_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, *,
                 device=DEFAULT_DEVICE):
        if parameters is None:
            raise ValueError("parameters must be provided (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate scheduler objects (optimizer/lr.py) are not "
                "ported yet (ROADMAP.md, queue 1); pass a float")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP.md, queue 1)")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            raise NotImplementedError(
                "parameter groups are not ported yet (ROADMAP.md, queue 1)")
        self._device = resolve_device(device)
        for p in params:
            if p.device.type != self._device.type:
                raise ValueError(f"a parameter lies on {p.device}, the "
                                 f"optimizer was asked for {self._device}")
        self._parameter_list = params
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {
            name: {} for name in self._accum_names}
        dev = params[0].device if params else self._device
        self._step_tensor = torch.zeros((), dtype=torch.int32, device=dev)
        self._lr_cell = torch.zeros((), dtype=torch.float32, device=dev)
        self._lr_host = None

    # ------------------------------------------------ lr
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

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

    # ------------------------------------------------ accumulators
    def _get_accumulator(self, name: str, index: int,
                         param: torch.Tensor) -> torch.Tensor:
        store = self._accumulators[name]
        if index not in store:
            store[index] = torch.zeros(param.shape, dtype=torch.float32,
                                       device=param.device)
        return store[index]

    # ------------------------------------------------ core
    @torch.no_grad()
    def step(self) -> None:
        self._step_tensor += 1
        lr = self._device_lr()
        live = [(i, p) for i, p in enumerate(self._parameter_list)
                if p.grad is not None and p.requires_grad]
        if live:
            self._update(live, lr)

    def _update(self, live, lr) -> None:
        """Update every ``(index, parameter)`` of ``live`` from its
        ``.grad``."""
        raise NotImplementedError

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None

    # ------------------------------------------------ state dict
    def state_dict(self) -> dict:
        """Accumulators under ``"<parameter index>_<name>"`` and the step
        count under ``"@step"``."""
        out = {f"{i}_{name}": t for name, store in self._accumulators.items()
               for i, t in sorted(store.items())}
        out["@step"] = int(self._step_tensor.item())
        return out
