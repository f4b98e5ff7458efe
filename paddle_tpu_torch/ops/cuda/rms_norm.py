"""RMSNorm: the hand-written CUDA forward kernel (K4), its plain version and
its gradient.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``. K4,
``csrc/rms_norm.cu``, replaces ``_rms_kernel`` (launched by
``_rms_norm_fwd``): ``y = x * rsqrt(mean(x²) + eps) * w`` over the last
dim, in f32, stored in x's dtype. Its source comment states its design and
bound.

:func:`rms_norm_fwd` launches K4 for CUDA tensors or raises — no fallback
— and runs the plain version, :func:`rms_norm_reference`, for CPU
tensors. :data:`launches` counts kernel launches, and only those. The
gradient, :class:`RMSNormFunction`, is the JAX ``_bwd`` line for line in
plain torch: the JAX backward is jnp, not Pallas, so it has no kernel to
port. The JAX ``available()``/``self_test`` downgrade is not carried over.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from . import _build

__all__ = ["rms_norm_fwd", "rms_norm_reference", "rms_norm_value",
           "RMSNormFunction", "build", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: K4 launches so far (plain-version calls are not counted)
launches = 0

_fn: Optional[object] = None


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """The plain version of K4 (``_rms_kernel``): x and w upcast to f32,
    ``y = x * rsqrt(mean(x²) + eps)``, then ``y * w``, stored in x's
    dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rms_norm").paddle_rms_norm_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x w out | x_dtype w_dtype | rows d ldx | eps | stream
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i64, i64, i64,
                       ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def build() -> None:
    """Build and load K4 now instead of at its first launch."""
    _kernel()


def _check(x, w, device):
    """The device the call runs on, after checking shapes and placement."""
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rms_norm takes x [..., d] and w [d], got x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    dev = resolve_device(device)
    if x.device.type != dev.type or w.device != x.device:
        raise ValueError(f"x lies on {x.device} and w on {w.device}, the "
                         f"call asked for {dev}")
    return dev


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
    """RMSNorm over the last dim as the Pallas ``_rms_norm_fwd`` computes
    it: ``[..., d]`` in, the same shape and dtype out. ``device`` is where
    the caller means to run (default CUDA); the tensors must lie there. On
    CUDA K4 launches or this raises; on the CPU the plain version runs."""
    dev = _check(x, w, device)
    if dev.type == "cpu":
        return rms_norm_reference(x, w, eps)
    return _launch(x, w, float(eps))


def _launch(x, w, eps):
    global launches
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16, got x {x.dtype}, "
                        f"w {w.dtype}")
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # rows of x may be strided (a view when the leading dims collapse);
    # the last dim must be contiguous
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    w = w.contiguous()
    rows = x2.shape[0]
    ldx = x2.stride(0) if rows > 1 else d
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], _DTYPES[w.dtype], rows, d, ldx, eps,
                 stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError {err}")
    launches += 1
    return out


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm, the counterpart of the Pallas custom VJP
    (``_fwd``/``_bwd``): the forward runs K4 (the plain version for CPU
    tensors) and saves (x, w); the backward is ``_bwd`` in plain torch, in
    f32, dx cast to x's dtype and dw to w's."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps, device=x.device)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(ms + ctx.eps)
        xn = xf * inv
        dw = (gf * xn).sum(dim=tuple(range(x.dim() - 1))).to(w.dtype)
        gw = gf * wf
        # d/dx [x * inv]: inv * g - xn * mean(g*xn) * inv
        dx = inv * (gw - xn * (gw * xn).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dw, None


def rms_norm_value(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """Differentiable fused RMSNorm (the Pallas ``rms_norm_value``): K4
    forward on CUDA, the plain version on the CPU, the ``_bwd`` gradient
    either way."""
    _check(x, w, device)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return rms_norm_fwd(x, w, eps, device=x.device)
    return RMSNormFunction.apply(x, w, float(eps))
