"""Multi-tensor Momentum: the hand-written CUDA kernel and its plain
version.

No Pallas counterpart: the JAX package writes Momentum
(``paddle_tpu/optimizer/optimizers.py`` ``Momentum._apply_one``) in jnp,
and its ``TrainStep`` hands the update to XLA, which fuses it into the
step's one program. ``csrc/momentum.cu`` is that fusion for the port, as
``csrc/adamw.cu`` is for Adam: one pass over many parameters in one launch
(one per :data:`MAX_TENSORS` tensors of one parameter and gradient dtype),
each element's p, g and v read once. Its source comment states its design
and bound.

:func:`momentum_update` launches the kernel for CUDA tensors or raises —
no fallback — and runs the plain version, :func:`momentum_reference`, for
CPU tensors. The plain version is the optimizer's per-tensor chain of
torch ops, and the kernel computes it bit for bit: the L2 decay folded
into the gradient in the parameter's dtype, an f32 velocity, Nesterov's
look-ahead, and the step taken in f32 and stored in the parameter's dtype
(no master copy). Each tensor has its own LR (the LR times its group's and
its ``optimize_attr``'s factors, a device scalar made by the plain
version's own torch ops, one table entry per distinct factors) and its own
L2 coefficient. Given ``found_inf``, a device flag, the kernel leaves every
p and v untouched where it is set; the plain version snapshots and
selects. Parameters may be float32, bfloat16 or float16, their gradients
of their dtype or float32 (an unscaled gradient). :data:`launches` counts
kernel launches, and only those. The packing rules (tensor lists in the
launch parameters, blocks a tensor, the LR table) are
``ops/cuda/adamw.py``'s, and so is the update's form as one operator,
``paddle_tpu_torch::momentum``, whose schema declares the parameter and
velocity lists it writes, called while the op-interception tier is on.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ...core import hooks
from ...device import DEFAULT_DEVICE
from . import _build, _registry
from .adamw import (_DTYPES, _PARAM_LIMIT, MAX_TENSORS, _factors,
                    _per_tensor, check_update, fill_blocks, pack_factors,
                    slot_table, tensor_lr, unpack_decay, unpack_factors)

__all__ = ["momentum_update", "momentum_reference", "build", "launches",
           "MAX_TENSORS", "momentum_op"]

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_fn: Optional[object] = None


class _TensorList(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_TENSORS),
                ("g", ctypes.c_void_p * MAX_TENSORS),
                ("v", ctypes.c_void_p * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("wd", ctypes.c_float * MAX_TENSORS),
                ("block_start", ctypes.c_int * (MAX_TENSORS + 1)),
                ("l2_mask", ctypes.c_ulonglong),
                ("slot", ctypes.c_ubyte * MAX_TENSORS),
                ("count", ctypes.c_int)]


class _Scalars(ctypes.Structure):
    _fields_ = [("lr", ctypes.c_void_p), ("found_inf", ctypes.c_void_p),
                ("mu", ctypes.c_float), ("nesterov", ctypes.c_int)]


def momentum_reference(params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       velocities: Sequence[torch.Tensor],
                       lr: torch.Tensor, *, momentum: float,
                       nesterov: bool = False, weight_decay=None,
                       lr_factors=None, found_inf=None) -> None:
    """The plain version: the JAX ``Momentum`` rule as a chain of torch
    ops per tensor, in place. ``lr`` is the f32 LR scalar; ``weight_decay``
    the L2 coefficient (None: none), one value or one per tensor;
    ``lr_factors`` a tuple of LR factors per tensor; where the device flag
    ``found_inf`` is set nothing changes (snapshot and select)."""
    n = len(params)
    wds = _per_tensor(weight_decay, n, "weight_decay")
    factors = _factors(lr_factors, n)
    for p, g, vel, wd, fs in zip(params, grads, velocities, wds, factors):
        old = (p.clone(), vel.clone()) if found_inf is not None else None
        lr_t = tensor_lr(lr, fs)
        gv = g if wd is None else g + float(wd) * p
        v_new = momentum * vel + gv
        vel.copy_(v_new)
        update = gv + momentum * v_new if nesterov else v_new
        p.copy_((p.float() - lr_t * update).to(p.dtype))
        if old is not None:
            p.copy_(torch.where(found_inf, old[0], p))
            vel.copy_(torch.where(found_inf, old[1], vel))


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("momentum")
        for name in ("paddle_momentum_max_tensors",
                     "paddle_momentum_param_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if lib.paddle_momentum_max_tensors() != MAX_TENSORS:
            raise RuntimeError("csrc/momentum.cu's kMaxTensors differs from "
                               "MAX_TENSORS: the tensor lists would not "
                               "match")
        size = ctypes.sizeof(_TensorList) + ctypes.sizeof(_Scalars)
        if lib.paddle_momentum_param_bytes() != size or size > _PARAM_LIMIT:
            raise RuntimeError(
                f"the Momentum launch parameters differ between "
                f"csrc/momentum.cu ({lib.paddle_momentum_param_bytes()} "
                f"bytes) and the wrapper ({size}), or pass {_PARAM_LIMIT}")
        fn = lib.paddle_momentum
        # tensor list, scalars, dtype, gradient dtype, stream
        fn.argtypes = [ctypes.POINTER(_TensorList),
                       ctypes.POINTER(_Scalars), ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _kernel()


def momentum_update(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    velocities: Sequence[torch.Tensor],
                    lr: torch.Tensor, *, momentum: float,
                    nesterov: bool = False, weight_decay=None,
                    lr_factors=None, found_inf=None,
                    device=DEFAULT_DEVICE) -> None:
    """One Momentum update of every ``(p, g, v)``, in place, as
    :func:`momentum_reference` computes it (the same arguments).
    ``device`` is where the caller means to run (default CUDA); the
    tensors must lie there. Under interception it calls the operator
    ``paddle_tpu_torch::momentum``, otherwise what its kernels run: on
    CUDA the kernel launches (once per :data:`MAX_TENSORS` tensors of one
    parameter and gradient dtype) or this raises; on the CPU the plain
    version runs."""
    dev = check_update({"params": params, "grads": grads,
                        "velocities": velocities}, device, LR=lr,
                       found_inf=found_inf)
    n = len(params)
    wds = _per_tensor(weight_decay, n, "weight_decay")
    factors = _factors(lr_factors, n)
    if hooks.active():
        # the operator only under interception, as AdamW's
        momentum_op(list(params), list(grads), list(velocities), lr,
                    found_inf, float(momentum), bool(nesterov),
                    [0.0 if w is None else float(w) for w in wds],
                    [w is not None for w in wds], *pack_factors(factors))
    elif dev.type == "cuda":
        _launch_all(params, grads, velocities, lr, found_inf, momentum,
                    nesterov, wds, factors)
    else:
        momentum_reference(params, grads, velocities, lr, momentum=momentum,
                           nesterov=nesterov, weight_decay=wds,
                           lr_factors=factors, found_inf=found_inf)


def _op_cpu(params, grads, velocities, lr, found_inf, momentum, nesterov,
            weight_decay, has_weight_decay, factor_values, factor_counts):
    momentum_reference(
        params, grads, velocities, lr, momentum=momentum, nesterov=nesterov,
        weight_decay=unpack_decay(weight_decay, has_weight_decay),
        lr_factors=unpack_factors(factor_values, factor_counts),
        found_inf=found_inf)


def _op_cuda(params, grads, velocities, lr, found_inf, momentum, nesterov,
             weight_decay, has_weight_decay, factor_values, factor_counts):
    _launch_all(params, grads, velocities, lr, found_inf, momentum, nesterov,
                unpack_decay(weight_decay, has_weight_decay),
                unpack_factors(factor_values, factor_counts))


def _op_fake(*args):
    return None


momentum_op = _registry.define(
    "momentum(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] velocities, "
    "Tensor lr, Tensor? found_inf, float momentum, bool nesterov, "
    "float[] weight_decay, bool[] has_weight_decay, float[] factor_values, "
    "int[] factor_counts) -> ()",
    cuda=_op_cuda, cpu=_op_cpu, fake=_op_fake)


def _launch_all(params, grads, velocities, lr, found_inf, momentum, nesterov,
                wds, factors):
    """The kernel's launches over every tensor, once per
    :data:`MAX_TENSORS` tensors of one parameter and gradient dtype: the
    operator's CUDA kernel, and the update's outside interception."""
    groups, slots = {}, {}
    for i, (p, g, vel) in enumerate(zip(params, grads, velocities)):
        if p.dtype not in _DTYPES or g.dtype not in (p.dtype, torch.float32):
            raise TypeError(f"the Momentum kernel takes float32, bfloat16 or "
                            f"float16 parameters with gradients of their "
                            f"dtype or float32, got {p.dtype} and {g.dtype}")
        if vel.dtype != torch.float32:
            raise TypeError("the Momentum kernel keeps an f32 velocity")
        if not (p.is_contiguous() and g.is_contiguous()
                and vel.is_contiguous()):
            raise ValueError("the Momentum kernel takes contiguous tensors")
        if p.numel():
            key = tuple(f for f in factors[i] if f != 1.0)
            slot = slots.setdefault(key, len(slots))
            groups.setdefault((p.dtype, g.dtype), []).append(
                (p, g, vel, slot, wds[i]))
    if not groups:
        return
    lr_tab = slot_table([tensor_lr(lr, fs) for fs in slots])
    scalars = _Scalars(lr_tab.data_ptr(),
                       found_inf.data_ptr() if found_inf is not None
                       else None, momentum, int(bool(nesterov)))
    fn = _kernel()
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for (dtype, gdtype), entries in groups.items():
            for i in range(0, len(entries), MAX_TENSORS):
                _launch(fn, entries[i:i + MAX_TENSORS], scalars,
                        _DTYPES[dtype], _DTYPES[gdtype], stream)


def _launch(fn, entries, scalars, dtype_code, gdtype_code, stream):
    global launches
    hooks.check_launch("momentum")
    tl = _TensorList()
    for j, (p, g, vel, slot, wd) in enumerate(entries):
        tl.p[j], tl.g[j], tl.v[j] = p.data_ptr(), g.data_ptr(), vel.data_ptr()
        tl.slot[j] = slot
        if wd is not None:
            tl.l2_mask |= 1 << j
            tl.wd[j] = float(wd)
    fill_blocks(tl, [e[0].numel() for e in entries])
    err = fn(ctypes.byref(tl), ctypes.byref(scalars), dtype_code,
             gdtype_code, stream)
    if err != 0:
        raise RuntimeError(f"Momentum kernel launch failed: cudaError {err}")
    launches += 1
