"""Multi-tensor Adam/AdamW: the hand-written CUDA kernel and its plain
version.

No Pallas counterpart: the JAX package writes Adam and AdamW
(``paddle_tpu/optimizer/optimizers.py``) in jnp, and its ``TrainStep``
hands the update to XLA, which fuses it into the step's one program.
``csrc/adamw.cu`` is that fusion for the port: one pass over many
parameters in one launch (one per :data:`MAX_TENSORS` tensors of one
dtype), each element's p, g, m and v read once. Its source comment states
its design and bound.

:func:`adamw_update` launches the kernel for CUDA tensors or raises — no
fallback — and runs the plain version, :func:`adamw_reference`, for CPU
tensors. The plain version is the optimizer's per-tensor chain of torch
ops, and the kernel computes it bit for bit: f32 moments, no master copy,
AdamW's decay rounded to the parameter's dtype before the Adam step,
Adam's L2 decay folded into the gradient in the parameter's dtype. The
bias corrections ``1 - beta ** t`` and AdamW's ``1 - lr * coeff`` are
device scalars computed once per update by the plain version's own torch
ops, so the kernel reads the same bits. :data:`launches` counts kernel
launches, and only those.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from . import _build

__all__ = ["adamw_update", "adamw_reference", "build", "launches",
           "MAX_TENSORS"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: tensors one launch takes (``kMaxTensors`` in ``csrc/adamw.cu``)
MAX_TENSORS = 64
_THREADS = 256
# a block's share of its tensor, 8 vectors of 4 elements a thread, and the
# most blocks one tensor gets (its blocks grid-stride over the rest)
_BLOCK_ELEMS = _THREADS * 4 * 8
_MAX_BLOCKS = 2048

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_fn: Optional[object] = None


class _TensorList(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_TENSORS),
                ("g", ctypes.c_void_p * MAX_TENSORS),
                ("m", ctypes.c_void_p * MAX_TENSORS),
                ("v", ctypes.c_void_p * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("block_start", ctypes.c_int * (MAX_TENSORS + 1)),
                ("count", ctypes.c_int)]


class _Scalars(ctypes.Structure):
    _fields_ = [("lr", ctypes.c_void_p), ("bc1", ctypes.c_void_p),
                ("bc2", ctypes.c_void_p), ("decay", ctypes.c_void_p),
                ("beta1", ctypes.c_float), ("beta2", ctypes.c_float),
                ("one_minus_beta1", ctypes.c_float),
                ("one_minus_beta2", ctypes.c_float),
                ("eps", ctypes.c_float), ("weight_decay", ctypes.c_float),
                ("has_decay", ctypes.c_int), ("has_l2", ctypes.c_int)]


def _corrections(lr, step, beta1, beta2, coeff):
    """``(1 - beta1**t, 1 - beta2**t, 1 - lr*coeff or None)`` as device
    scalars, by the plain version's torch ops."""
    t = step.float()
    decay = (1 - lr * coeff) if coeff else None
    return 1 - beta1 ** t, 1 - beta2 ** t, decay


def adamw_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    exp_avgs: Sequence[torch.Tensor],
                    exp_avg_sqs: Sequence[torch.Tensor],
                    lr: torch.Tensor, step: torch.Tensor, *, beta1: float,
                    beta2: float, eps: float, coeff: float = 0.0,
                    weight_decay=None) -> None:
    """The plain version: the JAX ``Adam``/``AdamW`` rule as a chain of
    torch ops per tensor, in place. ``lr`` is the f32 LR scalar, ``step``
    the step count after this step's increment; ``coeff`` is AdamW's
    decoupled decay (0: none), ``weight_decay`` Adam's L2 decay (None:
    none)."""
    bc1, bc2, decay = _corrections(lr, step, beta1, beta2, coeff)
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if decay is not None:
            p.copy_((p.float() * decay).to(p.dtype))
        if weight_decay is not None:
            g = g + float(weight_decay) * p
        gv = g.float()
        m.mul_(beta1).add_((1 - beta1) * gv)
        v.mul_(beta2).add_((1 - beta2) * gv * gv)
        mhat = m / bc1
        vhat = v / bc2
        p.copy_((p.float() - lr * mhat / (vhat.sqrt() + eps)).to(p.dtype))


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("adamw")
        lib.paddle_adamw_max_tensors.argtypes = []
        lib.paddle_adamw_max_tensors.restype = ctypes.c_int
        if lib.paddle_adamw_max_tensors() != MAX_TENSORS:
            raise RuntimeError("csrc/adamw.cu's kMaxTensors differs from "
                               "MAX_TENSORS: the tensor lists would not "
                               "match")
        fn = lib.paddle_adamw
        ptr = ctypes.c_void_p
        # tensor list, scalars, dtype, stream
        fn.argtypes = [ctypes.POINTER(_TensorList),
                       ctypes.POINTER(_Scalars), ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _kernel()


def _check(params, grads, exp_avgs, exp_avg_sqs, lr, step, device):
    """The device the update runs on, after checking the four lists and
    the two scalars."""
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)):
        raise ValueError("params, grads and both moment lists must have one "
                         "entry per parameter")
    dev = resolve_device(device)
    if params and (lr.device != params[0].device
                   or step.device != params[0].device):
        raise ValueError(f"the LR ({lr.device}) and step ({step.device}) "
                         f"scalars must lie with the parameters "
                         f"({params[0].device})")
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"shapes differ: p {tuple(p.shape)}, g "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                             f"{tuple(v.shape)}")
        if any(t.device != p.device for t in (g, m, v)) \
                or p.device.type != dev.type:
            raise ValueError(f"a parameter lies on {p.device}, the update "
                             f"was asked for {dev}")
    return dev


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 exp_avgs: Sequence[torch.Tensor],
                 exp_avg_sqs: Sequence[torch.Tensor],
                 lr: torch.Tensor, step: torch.Tensor, *, beta1: float,
                 beta2: float, eps: float, coeff: float = 0.0,
                 weight_decay=None, device=DEFAULT_DEVICE) -> None:
    """One Adam/AdamW update of every ``(p, g, m, v)``, in place, as
    :func:`adamw_reference` computes it. ``device`` is where the caller
    means to run (default CUDA); the tensors must lie there. On CUDA the
    kernel launches (once per :data:`MAX_TENSORS` tensors of one dtype) or
    this raises; on the CPU the plain version runs."""
    dev = _check(params, grads, exp_avgs, exp_avg_sqs, lr, step, device)
    if dev.type == "cpu":
        adamw_reference(params, grads, exp_avgs, exp_avg_sqs, lr, step,
                        beta1=beta1, beta2=beta2, eps=eps, coeff=coeff,
                        weight_decay=weight_decay)
        return
    groups = {}
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        if p.dtype not in _DTYPES or g.dtype != p.dtype:
            raise TypeError(f"the AdamW kernel takes float32 or bfloat16 "
                            f"parameters with gradients of their dtype, got "
                            f"{p.dtype} and {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("the AdamW kernel keeps f32 moments")
        if not all(t.is_contiguous() for t in (p, g, m, v)):
            raise ValueError("the AdamW kernel takes contiguous tensors")
        if p.numel():
            groups.setdefault(p.dtype, []).append((p, g, m, v))
    if not groups:
        return
    bc1, bc2, decay = _corrections(lr, step, beta1, beta2, coeff)
    scalars = _Scalars(
        lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        decay.data_ptr() if decay is not None else None,
        beta1, beta2, 1 - beta1, 1 - beta2, eps,
        0.0 if weight_decay is None else float(weight_decay),
        int(decay is not None), int(weight_decay is not None))
    fn = _kernel()
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for dtype, entries in groups.items():
            for i in range(0, len(entries), MAX_TENSORS):
                _launch(fn, entries[i:i + MAX_TENSORS], scalars,
                        _DTYPES[dtype], stream)


def _launch(fn, entries, scalars, dtype_code, stream):
    global launches
    tl = _TensorList()
    blocks = 0
    for j, (p, g, m, v) in enumerate(entries):
        n = p.numel()
        tl.p[j], tl.g[j] = p.data_ptr(), g.data_ptr()
        tl.m[j], tl.v[j] = m.data_ptr(), v.data_ptr()
        tl.n[j] = n
        tl.block_start[j] = blocks
        blocks += min(math.ceil(n / _BLOCK_ELEMS), _MAX_BLOCKS)
    tl.block_start[len(entries)] = blocks
    tl.count = len(entries)
    err = fn(ctypes.byref(tl), ctypes.byref(scalars), dtype_code, stream)
    if err != 0:
        raise RuntimeError(f"AdamW kernel launch failed: cudaError {err}")
    launches += 1
