"""``paddle.jit.save``/``paddle.jit.load`` for the port (port of
``paddle_tpu/jit/serialization.py``).

The JAX package serializes a layer's forward as a StableHLO module
(``jax.export``) beside its parameters. The port exports it with
``torch.export`` and saves the ``ExportedProgram``:

- ``<path>.pdiparams``: the layer's ``state_dict`` through
  ``framework.io`` (the JAX package's pickle layout);
- ``<path>.pdmodel``: ``torch.export.save`` of the program (it carries its
  own copy of the weights; :func:`load` fills them from ``.pdiparams``);
- ``<path>.pdmeta``: a pickle with JAX's keys: ``class``,
  ``has_program``, ``quantize``, ``n_inputs``, ``input_shapes`` (``None``
  for a dynamic dim), ``dynamic_axes`` and ``dynamic_ranks``; and, with a
  program, the port's own ``linear_weights``: the state-dict names of the
  layer's ``nn.Linear`` weights, which torch stores ``[out, in]`` and the
  JAX package ``[in, out]``. An exported program holds no ``nn.Linear``
  modules any more, so this is the only record of which tensors a
  checkpoint in the reference's layout holds transposed
  (``inference.Predictor.swap_weights``). :func:`load` refuses a program
  whose ``.pdmeta`` lacks it rather than guess.

An ``InputSpec`` dim of ``None`` exports as a symbolic dim. As in JAX,
symbols go by rank: the first ``None`` dim of every input shares ``"b"``
(the batch axis), the second ``"s"`` (the sequence axis), and so on, so
``InputSpec([None, None])`` gives one program for a whole (batch × seq)
grid. torch specializes sizes 0 and 1, so the example inputs the export
traces carry size 2 and up on every dynamic axis. A seq dim's upper bound
is the model's ``max_position_embeddings`` where it has one.

Attention stays one node a layer in the exported graph: K1's forward is
the registered operator ``paddle_tpu_torch::flash_attention_fwd``
(``ops/cuda/flash_attention.py``), which this module imports, so a load in
a fresh process finds it. The export runs in eval mode without autograd.
A program exported on one device is saved for the CPU and moved at load
(``torch.export.passes.move_to_device_pass``) to the device asked for.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
from typing import Dict, Optional

import torch
from torch.export.passes import move_to_device_pass

from ..device import DEFAULT_DEVICE, resolve_device
from ..framework import io as fio
from ..ops.cuda import flash_attention  # noqa: F401 — registers K1's op
from ..static import InputSpec

__all__ = ["save", "load", "TranslatedLayer"]

_SYM_NAMES = ("b", "s", "d2", "d3")


def _rank_name(rank: int) -> str:
    return _SYM_NAMES[rank] if rank < len(_SYM_NAMES) else f"d{rank}"


def _rank_max(layer, rank: int) -> Optional[int]:
    """The largest size the model takes on the rank's axis: a sequence
    (rank 1) is bounded by ``max_position_embeddings``."""
    if rank != 1:
        return None
    cfg = getattr(layer, "config", None)
    n = int(getattr(cfg, "max_position_embeddings", 0) or 0)
    return n or None


def _layer_device(layer) -> torch.device:
    for t in layer.parameters():
        return t.device
    return torch.device("cpu")


def _export(layer, input_spec):
    """``(ExportedProgram, meta entries)`` of ``layer`` over the specs."""
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    n_ranks = max([sum(d is None for d in s.shape) for s in specs] or [0])
    dims = []
    for r in range(n_ranks):
        top = _rank_max(layer, r)
        dims.append(torch.export.Dim(_rank_name(r), min=1, max=top)
                    if top else torch.export.Dim(_rank_name(r), min=1))
    dev = _layer_device(layer)
    examples, dynamic, dynamic_axes, dynamic_ranks = [], [], [], []
    for i, spec in enumerate(specs):
        shape, axes, rank = [], {}, 0
        for ax, d in enumerate(spec.shape):
            if d is None:
                axes[ax] = dims[rank]
                dynamic_axes.append((i, ax))
                dynamic_ranks.append((i, ax, rank))
                # distinct sizes of 2 and up: torch specializes 0 and 1,
                # and two axes of equal size would share one symbol
                top = _rank_max(layer, rank)
                shape.append(min(2 + rank, top) if top else 2 + rank)
                rank += 1
            else:
                shape.append(d)
        examples.append(torch.zeros(shape, dtype=spec.dtype, device=dev))
        dynamic.append(axes or None)
    modes = [(m, m.training) for m in layer.modules()]
    layer.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(layer, tuple(examples),
                                     dynamic_shapes=tuple(dynamic))
    finally:
        for m, was_training in modes:
            m.training = was_training
    if dev.type != "cpu":
        ep = move_to_device_pass(ep, "cpu")
    meta = {
        "n_inputs": len(specs),
        "input_shapes": [(list(s.shape), str(s.dtype).replace("torch.", ""))
                         for s in specs],
        "dynamic_axes": dynamic_axes,
        "dynamic_ranks": dynamic_ranks,
    }
    return ep, meta


def linear_weights(layer) -> set:
    """The state-dict names of ``layer``'s ``nn.Linear`` weights."""
    names = set(layer.state_dict())
    return {f"{name}.weight" for name, mod in layer.named_modules()
            if isinstance(mod, torch.nn.Linear)} & names


def save(layer, path, input_spec=None, **configs) -> None:
    """Save ``layer``'s parameters and, with ``input_spec`` (a list of
    ``InputSpec`` or example tensors), its exported forward."""
    if configs.pop("quantize", None):
        raise NotImplementedError(
            "jit.save(quantize=...): weight-only quantization is not ported "
            "yet (ROADMAP.md, queue 1, quantization/)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fio.save(layer.state_dict(), path + ".pdiparams")
    meta = {"class": type(layer).__name__, "has_program": False,
            "quantize": None}
    if input_spec is not None:
        ep, entries = _export(layer, input_spec)
        with open(path + ".pdmodel", "wb") as f:
            torch.export.save(ep, f)
        meta["has_program"] = True
        meta.update(entries)
        meta["linear_weights"] = sorted(linear_weights(layer))
    with open(path + ".pdmeta", "wb") as f:
        pickle.dump(meta, f)


class TranslatedLayer:
    """A loaded exported program (reference ``jit/translated_layer.py``):
    ``module`` is the program's ``torch.fx.GraphModule`` on ``device``,
    whose parameters are the ones every call reads; ``linear_weights`` the
    names of the parameters that were ``nn.Linear`` weights;
    ``_content_hash`` is the sha256 of the ``.pdmodel`` bytes."""

    def __init__(self, exported, meta: dict, device: torch.device):
        self._exported = exported
        self.module = exported.module()
        self._meta = meta
        self.device = device
        self._content_hash: Optional[str] = None
        self.training = False
        self._dtypes = [getattr(torch, d) for _, d in
                        meta.get("input_shapes") or []]
        self.linear_weights = frozenset(meta["linear_weights"])

    @property
    def _params(self) -> Dict[str, torch.Tensor]:
        """The program's parameters and buffers, by state-dict name (the
        live tensors, not copies)."""
        return dict(self.module.state_dict(keep_vars=True))

    def as_inputs(self, args) -> list:
        """``args`` (arrays or tensors) as tensors on the program's device
        in the exported dtypes."""
        out = []
        for i, a in enumerate(args):
            dtype = self._dtypes[i] if i < len(self._dtypes) else None
            out.append(torch.as_tensor(a, dtype=dtype, device=self.device))
        return out

    def __call__(self, *args):
        with torch.inference_mode():
            return self.module(*self.as_inputs(args))

    forward = __call__

    def eval(self) -> "TranslatedLayer":
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self._params.items()}


def load(path, device=DEFAULT_DEVICE, **configs):
    """Load what :func:`save` wrote on ``device`` (default CUDA; raises
    without it unless ``device="cpu"``): a :class:`TranslatedLayer` when
    the save carried a program, else the state dict."""
    dev = resolve_device(device)
    state = fio.load(path + ".pdiparams")
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    if not meta.get("has_program"):
        return {k: v.to(dev) for k, v in state.items()}
    if "linear_weights" not in meta:
        raise ValueError(
            f"{path}.pdmeta has no 'linear_weights': it was written before "
            f"jit.save recorded which parameters are Linear weights, so a "
            f"checkpoint in the reference's layout could not be read into "
            f"it; save the model again")
    with open(path + ".pdmodel", "rb") as f:
        raw = f.read()
    ep = move_to_device_pass(torch.export.load(io.BytesIO(raw)), dev)
    layer = TranslatedLayer(ep, meta, dev)
    layer._content_hash = hashlib.sha256(raw).hexdigest()
    live = layer._params
    missing = sorted(set(live) - set(state))
    if missing:
        raise KeyError(f"jit.load: {path}.pdiparams lacks {missing[:5]}")
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(state[name])
    return layer
