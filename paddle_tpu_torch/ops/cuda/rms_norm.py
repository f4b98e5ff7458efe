"""RMSNorm: the hand-written CUDA forward kernel (K4), the hand-written
backward kernel, their plain versions and the autograd function.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``. Both kernels are in
``csrc/rms_norm.cu``, whose source comment states their design and bounds:

- K4 replaces ``_rms_kernel`` (launched by ``_rms_norm_fwd``):
  ``y = x * rsqrt(mean(x²) + eps) * w`` over the last dim, in f32, stored
  in x's dtype;
- the backward kernel is the counterpart of the jnp ``_bwd`` of the custom
  VJP, which has no Pallas kernel (XLA fuses it): dx in x's dtype and dw in
  w's, from the residuals (x, w) and the output gradient. It makes two
  launches a call, the second summing the blocks' dw partials in a fixed
  order, so dw is the same bits on every run.

:func:`rms_norm_fwd` and :func:`rms_norm_bwd` launch their kernels for CUDA
tensors or raise — no fallback — and run the plain versions,
:func:`rms_norm_reference` and :func:`rms_norm_bwd_reference`, for CPU
tensors. :data:`launches` and :data:`bwd_launches` count kernel launches,
and only those. The JAX ``available()``/``self_test`` downgrade is not
carried over.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from . import _build

__all__ = ["rms_norm_fwd", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_bwd_reference", "rms_norm_value", "RMSNormFunction",
           "build", "launches", "bwd_launches", "BWD_LAUNCHES_PER_CALL"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: K4 launches so far (plain-version calls are not counted)
launches = 0
#: backward kernel launches so far, two a call (plain-version calls are not
#: counted)
bwd_launches = 0
#: the backward's launches a call: dx with the blocks' dw partials, then dw
BWD_LAUNCHES_PER_CALL = 2

_lib: Optional[object] = None


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """The plain version of K4 (``_rms_kernel``): x and w upcast to f32,
    ``y = x * rsqrt(mean(x²) + eps)``, then ``y * w``, stored in x's
    dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def rms_norm_bwd_reference(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                           eps: float = 1e-6):
    """The plain version of the backward kernel, the JAX ``_bwd`` line for
    line: in f32 (in float64 for float64 inputs, the card's exact
    reference), ``dx = inv * (g*w - xn * mean(g*w*xn))`` cast to x's dtype
    and ``dw = sum over rows of g*xn`` cast to w's, where
    ``inv = rsqrt(mean(x²) + eps)`` and ``xn = x * inv``. Returns
    ``(dx, dw)``."""
    xf, gf, wf = (t.to(torch.promote_types(t.dtype, torch.float32))
                  for t in (x, g, w))
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    xn = xf * inv
    dw = (gf * xn).sum(dim=tuple(range(x.dim() - 1))).to(w.dtype)
    gw = gf * wf
    # d/dx [x * inv]: inv * g - xn * mean(g*xn) * inv
    dx = inv * (gw - xn * (gw * xn).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dw


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("rms_norm")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x w out | x_dtype w_dtype | rows d ldx | eps | stream
        lib.paddle_rms_norm_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i64, i64,
                                            i64, ctypes.c_float, ptr]
        # x w g dx dw partial | x_dtype w_dtype | rows d ldx ldg | blocks |
        # eps | stream
        lib.paddle_rms_norm_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                            i32, i64, i64, i64, i64, i32,
                                            ctypes.c_float, ptr]
        for fn in (lib.paddle_rms_norm_fwd, lib.paddle_rms_norm_bwd,
                   lib.paddle_rms_norm_bwd_blocks_per_sm):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Build and load both kernels now instead of at their first launch."""
    _library()


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


def _rows(t: torch.Tensor, d: int) -> tuple:
    """``t`` as ``[rows, d]`` rows a kernel reads, and their stride: a view
    where the last dim is contiguous and the rows do not overlap, else a
    copy."""
    t2 = t.reshape(-1, d)
    if t2.stride(1) != 1 or (t2.shape[0] > 1 and t2.stride(0) < d):
        t2 = t2.contiguous()
    return t2, (t2.stride(0) if t2.shape[0] > 1 else d)


def _dtype_codes(x, w):
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"the RMSNorm kernels take float32 or bfloat16, got "
                        f"x {x.dtype}, w {w.dtype}")
    return _DTYPES[x.dtype], _DTYPES[w.dtype]


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
    x_code, w_code = _dtype_codes(x, w)
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    # rows of x may be strided (a view when the leading dims collapse)
    x2, ldx = _rows(x, d)
    w = w.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.paddle_rms_norm_fwd(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), x_code, w_code,
            x2.shape[0], d, ldx, eps, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError {err}")
    launches += 1
    return out


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                 eps: float = 1e-6, *, device=DEFAULT_DEVICE) -> tuple:
    """The RMSNorm gradient, ``(dx, dw)``, as the JAX ``_bwd`` computes it
    from the residuals (x, w) and the output gradient ``g`` (x's shape and
    dtype): dx in x's dtype, dw in w's. On CUDA the backward kernel
    launches (two launches) or this raises; on the CPU the plain version
    runs."""
    dev = _check(x, w, device)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be x's shape on x's device, got g "
                         f"{tuple(g.shape)} on {g.device}, x "
                         f"{tuple(x.shape)} on {x.device}")
    if dev.type == "cpu":
        return rms_norm_bwd_reference(x, w, g, eps)
    return _launch_bwd(x, w, g, float(eps))


def _launch_bwd(x, w, g, eps):
    global bwd_launches
    x_code, w_code = _dtype_codes(x, w)
    if g.dtype != x.dtype:
        raise TypeError(f"the RMSNorm backward takes g in x's dtype "
                        f"{x.dtype}, got {g.dtype}")
    d = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, torch.zeros(d, dtype=w.dtype, device=x.device)
    x2, ldx = _rows(x, d)
    g2, ldg = _rows(g, d)
    w = w.contiguous()
    rows = x2.shape[0]
    lib = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    # the blocks' dw partials, made on the current stream for this call
    blocks = min(rows, lib.paddle_rms_norm_bwd_blocks_per_sm() * sms)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dw = torch.empty(d, dtype=w.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.paddle_rms_norm_bwd(
            x2.data_ptr(), w.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), x_code, w_code, rows, d, ldx,
            ldg, blocks, eps, stream)
    if err != 0:
        raise RuntimeError(f"rms_norm backward kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += BWD_LAUNCHES_PER_CALL
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """Differentiable RMSNorm, the counterpart of the Pallas custom VJP
    (``_fwd``/``_bwd``): the forward runs K4 and saves (x, w); the backward
    runs the backward kernel (the plain versions for CPU tensors), dx in
    x's dtype and dw in w's."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps, device=x.device)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g, ctx.eps, device=x.device)
        return dx, dw, None


def rms_norm_value(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """Differentiable fused RMSNorm (the Pallas ``rms_norm_value``): K4 and
    the backward kernel on CUDA, their plain versions on the CPU."""
    _check(x, w, device)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return rms_norm_fwd(x, w, eps, device=x.device)
    return RMSNormFunction.apply(x, w, float(eps))
