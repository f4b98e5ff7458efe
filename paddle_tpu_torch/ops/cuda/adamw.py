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
Adam's L2 decay folded into the gradient in the parameter's dtype. Each
tensor has its own LR (the LR times its group's, its ``optimize_attr``'s
and ``lr_ratio``'s factors), its own decoupled decay coefficient (0 where
``apply_decay_param_fun`` says no) and its own L2 coefficient. The bias
corrections ``1 - beta ** t``, each distinct tensor LR and each
``1 - lr_t * coeff_t`` are device scalars computed once per update by the
plain version's own torch ops, so the kernel reads the same bits (from a
small table, one entry per distinct factors and coefficient).

Two more modes: ``amsgrad`` (a fifth list, the running max of the second
moment), and the overflow skip: given ``found_inf``, a device flag, the
kernel reads it and leaves every p, m, v and max untouched where it is
set, so ``GradScaler.step`` needs no snapshot; the plain version
snapshots and selects, as the JAX ``GradScaler`` does. Parameters may be
float32, bfloat16 or float16, their gradients of their dtype or float32
(an unscaled gradient). :data:`launches` counts kernel launches, and only
those.

The update is one operator of torch's dispatcher,
``paddle_tpu_torch::adamw`` (``ops/cuda/_registry.py``): its CUDA kernel
launches the kernel, its CPU kernel runs the plain version, and its schema
declares the parameter and state lists it writes (``Tensor(a!)[]``), so
the op-interception tier sees an optimizer step as one op and observes
the tensors it wrote. Outside interception the wrapper runs what the
operator's kernels run, directly: the dispatcher's boxing of the lists
costs an eager call hundreds of µs of host time.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from ...core import hooks
from ...device import DEFAULT_DEVICE, resolve_device
from . import _build, _registry

__all__ = ["adamw_update", "adamw_reference", "build", "launches",
           "MAX_TENSORS", "adamw_op", "check_update", "fill_blocks",
           "pack_factors", "slot_table", "tensor_lr", "unpack_decay",
           "unpack_factors"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: tensors one launch takes (``kMaxTensors`` in ``csrc/adamw.cu``)
MAX_TENSORS = 64
_THREADS = 256
# a block's share of its tensor, 8 vectors of 4 elements a thread, and the
# most blocks one tensor gets (its blocks grid-stride over the rest)
_BLOCK_ELEMS = _THREADS * 4 * 8
_MAX_BLOCKS = 2048
# the kernel's parameter space
_PARAM_LIMIT = 4096

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_fn: Optional[object] = None


class _TensorList(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_TENSORS),
                ("g", ctypes.c_void_p * MAX_TENSORS),
                ("m", ctypes.c_void_p * MAX_TENSORS),
                ("v", ctypes.c_void_p * MAX_TENSORS),
                ("vmax", ctypes.c_void_p * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("wd", ctypes.c_float * MAX_TENSORS),
                ("block_start", ctypes.c_int * (MAX_TENSORS + 1)),
                ("decay_mask", ctypes.c_ulonglong),
                ("l2_mask", ctypes.c_ulonglong),
                ("slot", ctypes.c_ubyte * MAX_TENSORS),
                ("count", ctypes.c_int)]


class _Scalars(ctypes.Structure):
    _fields_ = [("lr", ctypes.c_void_p), ("decay", ctypes.c_void_p),
                ("bc1", ctypes.c_void_p), ("bc2", ctypes.c_void_p),
                ("found_inf", ctypes.c_void_p),
                ("beta1", ctypes.c_float), ("beta2", ctypes.c_float),
                ("one_minus_beta1", ctypes.c_float),
                ("one_minus_beta2", ctypes.c_float),
                ("eps", ctypes.c_float), ("amsgrad", ctypes.c_int)]


def _per_tensor(value, n: int, what: str) -> list:
    """``value`` given once for all ``n`` tensors, or one per tensor."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{what}: {len(value)} entries for {n} tensors")
        return list(value)
    return [value] * n


def _factors(lr_factors, n: int) -> list:
    """One tuple of LR factors a tensor (none by default)."""
    if lr_factors is None:
        return [()] * n
    return _per_tensor(list(lr_factors), n, "lr_factors")


def tensor_lr(lr: torch.Tensor, factors) -> torch.Tensor:
    """A tensor's LR: the LR scalar times each factor in turn (its group's
    ``learning_rate``, its ``optimize_attr``'s, ``lr_ratio``'s), one f32
    multiply each as the JAX rule does them; a factor of 1 is exact and
    skipped."""
    for f in factors:
        if f != 1.0:
            lr = lr * f
    return lr


def _bias_corrections(step, beta1, beta2):
    """``(1 - beta1**t, 1 - beta2**t)`` as device scalars, by the plain
    version's torch ops."""
    t = step.float()
    return 1 - beta1 ** t, 1 - beta2 ** t


def adamw_reference(params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor],
                    exp_avgs: Sequence[torch.Tensor],
                    exp_avg_sqs: Sequence[torch.Tensor],
                    lr: torch.Tensor, step: torch.Tensor, *, beta1: float,
                    beta2: float, eps: float, coeff=0.0,
                    weight_decay=None, lr_factors=None,
                    max_exp_avg_sqs=None, found_inf=None) -> None:
    """The plain version: the JAX ``Adam``/``AdamW`` rule as a chain of
    torch ops per tensor, in place. ``lr`` is the f32 LR scalar, ``step``
    the step count after this step's increment; ``coeff`` is AdamW's
    decoupled decay (0: none), ``weight_decay`` Adam's L2 decay (None:
    none), each one value or one per tensor; ``lr_factors`` a tuple of LR
    factors per tensor; ``max_exp_avg_sqs`` the amsgrad maxima; where the
    device flag ``found_inf`` is set nothing changes (snapshot and
    select)."""
    n = len(params)
    coeffs = _per_tensor(coeff, n, "coeff")
    wds = _per_tensor(weight_decay, n, "weight_decay")
    factors = _factors(lr_factors, n)
    vmaxes = max_exp_avg_sqs if max_exp_avg_sqs is not None else [None] * n
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    for p, g, m, v, vmax, c, wd, fs in zip(params, grads, exp_avgs,
                                           exp_avg_sqs, vmaxes, coeffs, wds,
                                           factors):
        cells = [t for t in (p, m, v, vmax) if t is not None]
        old = [t.clone() for t in cells] if found_inf is not None else None
        lr_t = tensor_lr(lr, fs)
        if c:
            p.copy_((p.float() * (1 - lr_t * c)).to(p.dtype))
        if wd is not None:
            g = g + float(wd) * p
        gv = g.float()
        m.mul_(beta1).add_((1 - beta1) * gv)
        v.mul_(beta2).add_((1 - beta2) * gv * gv)
        mhat = m / bc1
        if vmax is not None:
            torch.maximum(vmax, v, out=vmax)
            vhat = vmax / bc2
        else:
            vhat = v / bc2
        p.copy_((p.float() - lr_t * mhat / (vhat.sqrt() + eps)).to(p.dtype))
        if old is not None:
            for t, o in zip(cells, old):
                t.copy_(torch.where(found_inf, o, t))


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("adamw")
        for name in ("paddle_adamw_max_tensors", "paddle_adamw_param_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if lib.paddle_adamw_max_tensors() != MAX_TENSORS:
            raise RuntimeError("csrc/adamw.cu's kMaxTensors differs from "
                               "MAX_TENSORS: the tensor lists would not "
                               "match")
        size = ctypes.sizeof(_TensorList) + ctypes.sizeof(_Scalars)
        if lib.paddle_adamw_param_bytes() != size or size > _PARAM_LIMIT:
            raise RuntimeError(f"the AdamW launch parameters differ between "
                               f"csrc/adamw.cu ({lib.paddle_adamw_param_bytes()}"
                               f" bytes) and the wrapper ({size}), or pass "
                               f"{_PARAM_LIMIT}")
        fn = lib.paddle_adamw
        ptr = ctypes.c_void_p
        # tensor list, scalars, dtype, gradient dtype, stream
        fn.argtypes = [ctypes.POINTER(_TensorList),
                       ctypes.POINTER(_Scalars), ctypes.c_int, ctypes.c_int,
                       ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load the kernel now instead of at its first launch."""
    _kernel()


def slot_table(values) -> torch.Tensor:
    """Device scalars stacked into the table a kernel indexes by slot (one
    entry needs no stack); raises past the kernels' 256 slots."""
    if len(values) > 256:
        raise ValueError(f"{len(values)} distinct LR factors and decay "
                         f"coefficients; the kernel's table holds 256")
    return torch.stack(values) if len(values) > 1 else values[0].reshape(1)


def check_update(lists, device, **scalars) -> torch.device:
    """The device a multi-tensor update runs on, after checking it: every
    list of ``lists`` (``{name: list}``, the parameters first; a None list
    is absent) has one entry a parameter at its shape and on its device,
    of ``device`` 's type, and each named device scalar (None: absent) lies
    with the parameters; ``found_inf`` is a one-element bool tensor."""
    named = {k: v for k, v in lists.items() if v is not None}
    params = next(iter(named.values()))
    for name, ts in named.items():
        if len(ts) != len(params):
            raise ValueError(f"{name} must have one entry per parameter")
    dev = resolve_device(device)
    if params:
        where = params[0].device
        for name, t in scalars.items():
            if t is not None and t.device != where:
                raise ValueError(f"the {name} scalar ({t.device}) must lie "
                                 f"with the parameters ({where})")
    found_inf = scalars.get("found_inf")
    if found_inf is not None and (found_inf.dtype != torch.bool
                                  or found_inf.numel() != 1):
        raise ValueError("found_inf must be a one-element bool tensor")
    for i, p in enumerate(params):
        group = [ts[i] for ts in named.values()]
        if any(t.shape != p.shape for t in group):
            raise ValueError(f"shapes differ: p {tuple(p.shape)}, others "
                             f"{[tuple(t.shape) for t in group[1:]]}")
        if any(t.device != p.device for t in group) \
                or p.device.type != dev.type:
            raise ValueError(f"a parameter lies on {p.device}, the update "
                             f"was asked for {dev}")
    return dev


def fill_blocks(tl, numels) -> None:
    """The block layout of a launch's tensor list: tensor j owns blocks
    ``[block_start[j], block_start[j + 1])``, one per ``_BLOCK_ELEMS``
    elements up to ``_MAX_BLOCKS`` (they grid-stride over the rest)."""
    blocks = 0
    for j, n in enumerate(numels):
        tl.n[j] = n
        tl.block_start[j] = blocks
        blocks += min(math.ceil(n / _BLOCK_ELEMS), _MAX_BLOCKS)
    tl.block_start[len(numels)] = blocks
    tl.count = len(numels)


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 exp_avgs: Sequence[torch.Tensor],
                 exp_avg_sqs: Sequence[torch.Tensor],
                 lr: torch.Tensor, step: torch.Tensor, *, beta1: float,
                 beta2: float, eps: float, coeff=0.0,
                 weight_decay=None, lr_factors=None, max_exp_avg_sqs=None,
                 found_inf=None, device=DEFAULT_DEVICE) -> None:
    """One Adam/AdamW update of every ``(p, g, m, v)``, in place, as
    :func:`adamw_reference` computes it (the same arguments). ``device``
    is where the caller means to run (default CUDA); the tensors must lie
    there. Under interception it calls the operator
    ``paddle_tpu_torch::adamw``, otherwise what its kernels run: on CUDA
    the kernel launches (once per :data:`MAX_TENSORS` tensors of one
    parameter and gradient dtype) or this raises; on the CPU the plain
    version runs."""
    dev = check_update({"params": params, "grads": grads,
                        "exp_avgs": exp_avgs, "exp_avg_sqs": exp_avg_sqs,
                        "max_exp_avg_sqs": max_exp_avg_sqs}, device, LR=lr,
                       step=step, found_inf=found_inf)
    n = len(params)
    coeffs = _per_tensor(coeff, n, "coeff")
    wds = _per_tensor(weight_decay, n, "weight_decay")
    factors = _factors(lr_factors, n)
    if hooks.active():
        # under interception the slots see the update as one op; the
        # dispatcher boxes every tensor of its lists, which costs an eager
        # call hundreds of µs of host time, so only then
        adamw_op(list(params), list(grads), list(exp_avgs),
                 list(exp_avg_sqs), list(max_exp_avg_sqs or ()), lr, step,
                 found_inf, float(beta1), float(beta2), float(eps),
                 [float(c or 0.0) for c in coeffs],
                 [0.0 if w is None else float(w) for w in wds],
                 [w is not None for w in wds], *pack_factors(factors))
    elif dev.type == "cuda":
        _launch_all(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs,
                    lr, step, found_inf, beta1, beta2, eps, coeffs, wds,
                    factors)
    else:
        adamw_reference(params, grads, exp_avgs, exp_avg_sqs, lr, step,
                        beta1=beta1, beta2=beta2, eps=eps, coeff=coeffs,
                        weight_decay=wds, lr_factors=factors,
                        max_exp_avg_sqs=max_exp_avg_sqs, found_inf=found_inf)


def pack_factors(factors) -> tuple:
    """Per-tensor LR factor tuples as an operator takes them: the factors
    in one flat list and each tensor's count."""
    return ([float(f) for fs in factors for f in fs],
            [len(fs) for fs in factors])


def unpack_factors(flat, counts) -> list:
    """The inverse of :func:`pack_factors`."""
    out, at = [], 0
    for c in counts:
        out.append(tuple(flat[at:at + c]))
        at += c
    return out


def unpack_decay(weight_decay, has_weight_decay) -> list:
    """An operator's L2 coefficients back to one value or None a tensor."""
    return [w if has else None
            for w, has in zip(weight_decay, has_weight_decay)]


def _op_cpu(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, lr, step,
            found_inf, beta1, beta2, eps, coeff, weight_decay,
            has_weight_decay, factor_values, factor_counts):
    adamw_reference(params, grads, exp_avgs, exp_avg_sqs, lr, step,
                    beta1=beta1, beta2=beta2, eps=eps, coeff=coeff,
                    weight_decay=unpack_decay(weight_decay, has_weight_decay),
                    lr_factors=unpack_factors(factor_values, factor_counts),
                    max_exp_avg_sqs=max_exp_avg_sqs or None,
                    found_inf=found_inf)


def _op_cuda(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs, lr,
             step, found_inf, beta1, beta2, eps, coeff, weight_decay,
             has_weight_decay, factor_values, factor_counts):
    _launch_all(params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs or None,
                lr, step, found_inf, beta1, beta2, eps, coeff,
                unpack_decay(weight_decay, has_weight_decay),
                unpack_factors(factor_values, factor_counts))


def _op_fake(*args):
    return None


adamw_op = _registry.define(
    "adamw(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] exp_avgs, "
    "Tensor(c!)[] exp_avg_sqs, Tensor(d!)[] max_exp_avg_sqs, Tensor lr, "
    "Tensor step, Tensor? found_inf, float beta1, float beta2, float eps, "
    "float[] coeff, float[] weight_decay, bool[] has_weight_decay, "
    "float[] factor_values, int[] factor_counts) -> ()",
    cuda=_op_cuda, cpu=_op_cpu, fake=_op_fake)


def _launch_all(params, grads, exp_avgs, exp_avg_sqs, vmaxes, lr, step,
                found_inf, beta1, beta2, eps, coeffs, wds, factors):
    """The kernel's launches over every tensor, once per
    :data:`MAX_TENSORS` tensors of one parameter and gradient dtype: the
    operator's CUDA kernel, and the update's outside interception."""
    groups = {}
    slots = {}
    for i, (p, g, m, v) in enumerate(zip(params, grads, exp_avgs,
                                         exp_avg_sqs)):
        if p.dtype not in _DTYPES or g.dtype not in (p.dtype, torch.float32):
            raise TypeError(f"the AdamW kernel takes float32, bfloat16 or "
                            f"float16 parameters with gradients of their "
                            f"dtype or float32, got {p.dtype} and {g.dtype}")
        vm = vmaxes[i] if vmaxes is not None else None
        if any(t.dtype != torch.float32 for t in (m, v, vm) if t is not None):
            raise TypeError("the AdamW kernel keeps f32 moments")
        if not all(t.is_contiguous() for t in (p, g, m, v, vm)
                   if t is not None):
            raise ValueError("the AdamW kernel takes contiguous tensors")
        if p.numel():
            key = (tuple(f for f in factors[i] if f != 1.0), coeffs[i] or 0.0)
            slot = slots.setdefault(key, len(slots))
            groups.setdefault((p.dtype, g.dtype), []).append(
                (p, g, m, v, vm, slot, coeffs[i], wds[i]))
    if not groups:
        return
    # the tables: each slot's LR and 1 - lr_t * coeff_t, by the plain
    # version's ops
    lrs = [tensor_lr(lr, fs) for fs, _ in slots]
    lr_tab = slot_table(lrs)
    decay_tab = slot_table([(1 - lr_t * c) if c else lr_t
                            for lr_t, (_, c) in zip(lrs, slots)])
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    scalars = _Scalars(
        lr_tab.data_ptr(), decay_tab.data_ptr(), bc1.data_ptr(),
        bc2.data_ptr(), found_inf.data_ptr() if found_inf is not None
        else None, beta1, beta2, 1 - beta1, 1 - beta2, eps,
        int(vmaxes is not None))
    fn = _kernel()
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for (dtype, gdtype), entries in groups.items():
            for i in range(0, len(entries), MAX_TENSORS):
                _launch(fn, entries[i:i + MAX_TENSORS], scalars,
                        _DTYPES[dtype], _DTYPES[gdtype], stream)


def _launch(fn, entries, scalars, dtype_code, gdtype_code, stream):
    global launches
    hooks.check_launch("adamw")
    tl = _TensorList()
    for j, (p, g, m, v, vm, slot, c, wd) in enumerate(entries):
        tl.p[j], tl.g[j] = p.data_ptr(), g.data_ptr()
        tl.m[j], tl.v[j] = m.data_ptr(), v.data_ptr()
        tl.vmax[j] = vm.data_ptr() if vm is not None else None
        tl.slot[j] = slot
        if c:
            tl.decay_mask |= 1 << j
        if wd is not None:
            tl.l2_mask |= 1 << j
            tl.wd[j] = float(wd)
    fill_blocks(tl, [e[0].numel() for e in entries])
    err = fn(ctypes.byref(tl), ctypes.byref(scalars), dtype_code,
             gdtype_code, stream)
    if err != 0:
        raise RuntimeError(f"AdamW kernel launch failed: cudaError {err}")
    launches += 1
