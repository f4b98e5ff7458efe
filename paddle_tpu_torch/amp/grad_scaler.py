"""Dynamic loss scaling (port of ``paddle_tpu/amp/grad_scaler.py``).

The scale, the good and bad step counts and ``found_inf`` are device
cells, as in the JAX package, and no call reads one to the host: the
overflow check, the skip and the scale's update are device ops, so a
scaled step runs eagerly without a synchronization and is captured whole
into a CUDA graph (``jit.TrainStep``, ``jit.functionalize``).

- :meth:`GradScaler.unscale_` multiplies each gradient by ``1/scale`` in
  f32, as jnp promotes a bf16 or fp16 gradient times an f32 array, and
  sets ``found_inf`` if any result is not finite. The f32 gradients go to
  the optimizer beside the parameters' own ``.grad`` (which torch keeps in
  the parameter's dtype) and are what its next ``step`` reads.
- :meth:`GradScaler.step` skips the update on overflow: parameters,
  accumulators and the step count keep their bits. ``Adam``/``AdamW``
  pass the flag to the AdamW kernel, which reads it on the device and
  writes nothing; every other optimizer snapshots its cells and selects
  the old values back (``torch.where``), as the JAX step does.
- :meth:`GradScaler.update` applies one scale transition per step and is
  idempotent until the next ``step``.

Not ported: the JAX ``unscale_``'s ``numerics.nonfinite_grad`` fault point
and numerics witness (``observability/numerics.py`` has no port).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["GradScaler", "check_finite_and_unscale", "update_loss_scaling"]


def _unscale(grads, inv: torch.Tensor):
    """``(g·inv in f32 for each g, whether any is not finite)``, device
    values."""
    found = torch.zeros((), dtype=torch.bool, device=inv.device)
    out = []
    for g in grads:
        u = g.float() * inv
        found |= ~torch.isfinite(u).all()
        out.append(u)
    return out, found


class GradScaler:
    """``paddle.amp.GradScaler``: the loss scaled by a dynamic scale, the
    gradients unscaled and checked before the optimizer's step, the step
    skipped on overflow. The cells lie on ``device`` (default CUDA; the
    loss and the gradients must lie there too)."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True,
                 *, device=DEFAULT_DEVICE):
        self._enable = enable
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        dev = resolve_device(device)
        self._scale = torch.full((), float(init_loss_scaling),
                                 dtype=torch.float32, device=dev)
        self._good_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self._bad_steps = torch.zeros((), dtype=torch.int32, device=dev)
        self._found_inf = torch.zeros((), dtype=torch.bool, device=dev)
        self._already_unscaled = False
        self._pending_update = False

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self._scale.device.type:
            raise ValueError(f"the scaler's cells lie on "
                             f"{self._scale.device}, a tensor on {t.device}")

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def get_loss_scaling(self) -> torch.Tensor:
        """The scale, a copy of the device cell."""
        return self._scale.clone()

    def set_init_loss_scaling(self, v) -> None:
        self._scale.fill_(float(v))

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss × scale``, in f32 (jnp promotes a low-precision loss)."""
        if not self._enable:
            return loss
        self._check(loss)
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Each gradient the optimizer will read, times ``1/scale`` in f32;
        ``found_inf`` set if any is not finite. Once per step."""
        if not self._enable or self._already_unscaled:
            return
        params = [p for p in optimizer._parameter_list
                  if optimizer._grad_of(p) is not None]
        if params:
            self._check(params[0])
            grads, found = _unscale([optimizer._grad_of(p) for p in params],
                                    1.0 / self._scale)
            for p, g in zip(params, grads):
                optimizer._set_grad(p, g)
            self._found_inf.copy_(found)
        else:
            self._found_inf.fill_(False)
        self._already_unscaled = True

    def step(self, optimizer) -> None:
        """Unscale (unless done), then the optimizer's step, skipped on the
        device where ``found_inf`` is set."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        optimizer._skip_if = self._found_inf
        try:
            optimizer.step()
        finally:
            optimizer._skip_if = None
        self._already_unscaled = False
        self._pending_update = True

    @torch.no_grad()
    def _update_scale(self, found: torch.Tensor) -> None:
        good = torch.where(found, 0, self._good_steps + 1)
        bad = torch.where(found, self._bad_steps + 1, 0)
        grow = good >= self._incr_every
        shrink = bad >= self._decr_every
        new_scale = torch.where(
            shrink, torch.clamp_min(self._scale * self._decr_ratio, 1.0),
            torch.where(grow, self._scale * self._incr_ratio, self._scale))
        self._good_steps.copy_(torch.where(grow, 0, good))
        self._bad_steps.copy_(torch.where(shrink, 0, bad))
        self._scale.copy_(new_scale)

    def update(self) -> None:
        """One scale transition after a ``step`` (the canonical sequence is
        ``step`` then ``update``); idempotent between steps."""
        if self._enable and self._use_dynamic and self._pending_update:
            self._update_scale(self._found_inf)
            self._pending_update = False

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def state_dict(self) -> dict:
        """The scale and step counts (device cells) and the ratios."""
        return {"scale": self._scale,
                "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore the scale and step counts (tensors, arrays or numbers);
        the ratios stay as constructed, as in the JAX package."""
        for key in ("scale", "good_steps", "bad_steps"):
            if key not in state:
                continue
            value = torch.as_tensor(state[key])
            cell = getattr(self, "_" + key)
            cell.copy_(value.reshape(()).to(cell.dtype))


def check_finite_and_unscale(xs: Sequence[torch.Tensor], scale,
                             name=None):
    """Each of ``xs`` times ``1/scale`` (f32) and whether any result is
    not finite, a ``(1,)`` bool tensor (the reference op
    ``check_finite_and_unscale_``)."""
    s = torch.as_tensor(scale, dtype=torch.float32).reshape(())
    outs, found = _unscale(xs, 1.0 / s)
    return outs, found.reshape(1)


def update_loss_scaling(xs, found_infinite, prev_loss_scaling, in_good_steps,
                        in_bad_steps, incr_every_n_steps=1000,
                        decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                        decr_ratio=0.5, stop_update=False, name=None):
    """The dynamic loss-scale state machine (the reference op
    ``update_loss_scaling_``): ``(xs zeroed where found, scale, good,
    bad)``, each of the last three a ``(1,)`` tensor."""
    found = torch.as_tensor(found_infinite).reshape(()).bool()
    scale = torch.as_tensor(prev_loss_scaling).reshape(())
    good = torch.as_tensor(in_good_steps).reshape(()).int()
    bad = torch.as_tensor(in_bad_steps).reshape(()).int()
    bad_n = torch.where(found, bad + 1, 0)
    good_n = torch.where(found, 0, good + 1)
    scale_n = torch.where(found & (bad_n >= decr_every_n_nan_or_inf),
                          torch.clamp_min(scale * decr_ratio, 1.0), scale)
    bad_n = torch.where(bad_n >= decr_every_n_nan_or_inf, 0, bad_n)
    scale_n = torch.where(~found & (good_n >= incr_every_n_steps),
                          scale_n * incr_ratio, scale_n)
    good_n = torch.where(good_n >= incr_every_n_steps, 0, good_n)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in
            (torch.as_tensor(x) for x in xs)]
    return outs, scale_n.reshape(1), good_n.reshape(1), bad_n.reshape(1)
