"""``paddle.summary``: a layer-by-layer model summary (port of
``paddle_tpu/hapi/model_summary.py``; reference:
python/paddle/hapi/model_summary.py). One dry forward with forward hooks
records each leaf module's output shape and parameter count; returns
``{'total_params', 'trainable_params'}`` as the reference does and logs
the table."""
from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["summary"]


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _device_of(net) -> torch.device:
    for p in net.parameters():
        return p.device
    return torch.device("cpu")


@torch.no_grad()
def summary(net, input_size=None, dtypes=None, input=None) -> dict:
    """The reference ``paddle.summary(net, input_size)``: a dry run's
    shape and parameter table. ``input_size`` is a batch shape (or a list
    of them for several inputs), run as zeros on the network's device;
    ``input``, a ready tensor, wins over it. Trainable parameters are
    those that require a gradient."""
    rows = []
    handles = []

    def attach(layer):
        if list(layer.children()):
            return

        def hook(lay, inputs, output):
            y = output[0] if isinstance(output, (list, tuple)) else output
            own = list(lay.parameters(recurse=False))
            rows.append((type(lay).__name__, list(np.shape(y)),
                         int(sum(p.numel() for p in own)),
                         int(sum(p.numel() for p in own
                                 if p.requires_grad))))

        handles.append(layer.register_forward_hook(hook))

    for sub in net.modules():
        attach(sub)

    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = (list(input_size) if isinstance(input_size[0], (list, tuple))
                 else [list(input_size)])
        np_dtypes = list(dtypes or ["float32"] * len(sizes))
        dev = _device_of(net)
        args = [torch.from_numpy(np.zeros(s, np.dtype(d))).to(dev)
                for s, d in zip(sizes, np_dtypes)]
    else:
        args = [input]

    was_training = net.training
    net.eval()
    try:
        net(*args)
    finally:
        if was_training:
            net.train()
        for h in handles:
            h.remove()

    total = int(sum(p.numel() for p in net.parameters()))
    trainable = int(sum(p.numel() for p in net.parameters()
                        if p.requires_grad))
    log = logging.getLogger("paddle_tpu_torch")
    log.info("%-22s %-22s %12s", "Layer (type)", "Output Shape", "Param #")
    for name, shape, n_params, _ in rows:
        log.info("%-22s %-22s %12d", name, shape, n_params)
    log.info("Total params: %d  Trainable params: %d  Non-trainable: %d",
             total, trainable, total - trainable)
    return {"total_params": total, "trainable_params": trainable}
