"""FlashMask attention, forward and backward: the hand-written CUDA kernels
and their plain versions.

Port of ``paddle_tpu/ops/pallas/flashmask.py``. The mask is column
compressed: ``startend_row_indices`` ``[B, Hm, Sk, ncol]`` (Hm in {1, H},
Hm = 1 broadcast over the heads) gives, for every key column, the query
rows it hides. The documented layouts, and the only ones accepted:

- causal, ncol 1: ``[LTS]`` — rows >= LTS hidden (plus causal);
- causal, ncol 2: ``[LTS, LTE]`` — rows in [LTS, LTE) hidden (plus causal);
- non-causal, ncol 4: ``[LTS, LTE, UTS, UTE]`` — rows in [LTS, LTE) or in
  [UTS, UTE) hidden.

Three kernels replace the three Pallas bodies, each in two sources that
:func:`kernel_for` picks by dtype; each source states its design and
bound. All six run on the tensor cores with wgmma, fed by TMA, and walk a
list of the tiles the mask leaves live, built by each block before its
loop (``csrc/flashmask_sm90_common.cuh``); bfloat16 and float16 go in as
they are (one instantiation each of the ``*_sm90`` sources), float32 in
3×TF32 (each product as three TF32 products, f32 accuracy):

- K5 replaces ``_fm_fwd_kernel`` (launched by ``_fm_fwd``): O and the row
  logsumexp (``csrc/flashmask_fwd_sm90.cu``, ``csrc/flashmask_fwd_tf32.cu``);
- K6 and K7 replace ``_fm_bwd_dq_kernel`` and ``_fm_bwd_dkv_kernel``
  (both launched by ``_fm_bwd``): the dQ pass
  (``csrc/flashmask_dq_sm90.cu``, ``csrc/flashmask_dq_tf32.cu``) and the
  dK/dV pass (``csrc/flashmask_dkv_sm90.cu``, ``csrc/flashmask_dkv_tf32.cu``).

The tensor-core kernels (the third field of :data:`SOURCES`) read q, k, v
(and dO) through TMA, with K1's operand rule and copies
(``flash_attention.tma_aligned``, ``flash_attention.tma_copies``), and
count the tiles they compute when given a counter (:func:`fwd_tiles`,
:func:`bwd_tiles`).

A fully masked row gives O = 0 and lse = -1e30 + log(1e-30), as the
Pallas kernel does (the XLA route of the JAX entry point gives the mean of
v there instead). Each wrapper launches its kernel for CUDA tensors or
raises — no fallback — and runs the plain PyTorch version for CPU tensors,
through a registered operator: ``paddle_tpu_torch::flashmask_fwd`` (K5,
:func:`flashmask_fwd_op`) and ``paddle_tpu_torch::flashmask_bwd`` (K6 and
K7, :func:`flashmask_bwd_op`), each with a CPU kernel (the plain version)
and a fake, so the op-interception tier (``core/hooks.py``) sees each call
as one op and ``torch.export`` keeps it as one node.
:data:`fwd_launches` (K5), :data:`dq_launches` (K6) and
:data:`dkv_launches` (K7) count kernel launches, and only those; they are
apart from K1–K3's counters. Layout is ``[batch, seq, heads, head_dim]``;
causal is top-left (``q_pos >= k_pos``) as in the Pallas kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ...core import hooks
from ...device import DEFAULT_DEVICE
from . import _build, _registry
from .flash_attention import (_DTYPE_OF, NEG_INF, _check, _compute_type,
                              _check_kernel_inputs, _check_shape, _delta,
                              _for_tma, _raise_launch, _resolve, _strides)

__all__ = ["flashmask_fwd", "flashmask_fwd_op", "flashmask_bwd_op",
           "flashmask_fwd_reference", "flashmask_bwd",
           "flashmask_bwd_reference", "flashmask_value", "FlashMaskFunction",
           "prepare_indices", "disallowed", "build", "bwd_launch_args",
           "run_bwd_pass", "fwd_tiles", "bwd_tiles", "kernel_for", "SOURCES",
           "fwd_launches", "dq_launches", "dkv_launches"]

# the index layouts accepted, as the number of columns by ``causal``
_LAYOUTS = {True: (1, 2), False: (4,)}
# the dtypes K5-K7 take, and their codes in the C entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: K5 launches so far (plain-version calls are not counted)
fwd_launches = 0
#: K6 (dQ pass) launches so far
dq_launches = 0
#: K7 (dK/dV pass) launches so far
dkv_launches = 0

#: kernel name -> (source in ``csrc/``, C entry point, whether the kernel
#: runs on the tensor cores: reads q, k, v and dO through TMA tensor maps
#: and takes a tile counter)
SOURCES = {
    "fwd_sm90": ("flashmask_fwd_sm90", "paddle_flashmask_fwd_sm90", True),
    "fwd_tf32": ("flashmask_fwd_tf32", "paddle_flashmask_fwd_tf32", True),
    "bwd_dq_sm90": ("flashmask_dq_sm90", "paddle_flashmask_bwd_dq_sm90",
                    True),
    "bwd_dq_tf32": ("flashmask_dq_tf32", "paddle_flashmask_bwd_dq_tf32",
                    True),
    "bwd_dkv_sm90": ("flashmask_dkv_sm90", "paddle_flashmask_bwd_dkv_sm90",
                     True),
    "bwd_dkv_tf32": ("flashmask_dkv_tf32", "paddle_flashmask_bwd_dkv_tf32",
                     True),
}

_fns: Dict[str, object] = {}


# ---------------------------------------------------------------- the mask


def prepare_indices(startend_row_indices, q, k, causal: bool) -> torch.Tensor:
    """``startend_row_indices`` checked against q ``[B, Sq, H, D]`` and k
    ``[B, Sk, H, D]`` and returned as a contiguous int32 tensor on q's
    device (the one copy, made only where the input is not that already).
    Raises ``ValueError`` on a shape or layout outside the documented
    ones, ``TypeError`` on indices that are not integers."""
    idx = torch.as_tensor(startend_row_indices)
    if (idx.dtype.is_floating_point or idx.dtype.is_complex
            or idx.dtype == torch.bool):
        raise TypeError(f"startend_row_indices must be integers, got "
                        f"{idx.dtype}")
    b, _, h, _ = q.shape
    if idx.dim() != 4:
        raise ValueError(f"startend_row_indices must be [batch, 1 or heads, "
                         f"key_len, ncol], got shape {tuple(idx.shape)}")
    ib, hm, sk, ncol = idx.shape
    if ib != b or hm not in (1, h) or sk != k.shape[1]:
        raise ValueError(
            f"startend_row_indices {tuple(idx.shape)} does not fit q "
            f"{tuple(q.shape)} and k {tuple(k.shape)}: want [{b}, 1 or {h}, "
            f"{k.shape[1]}, ncol]")
    if ncol not in _LAYOUTS[bool(causal)]:
        raise ValueError(
            f"startend_row_indices with {ncol} columns and causal={causal} "
            f"is not a documented layout: causal takes 1 ([LTS]) or 2 "
            f"([LTS, LTE]) columns, non-causal takes 4 ([LTS, LTE, UTS, "
            f"UTE])")
    return idx.to(device=q.device, dtype=torch.int32).contiguous()


def disallowed(idx: torch.Tensor, sq: int, sk: int,
               causal: bool) -> torch.Tensor:
    """The dense ``[B, Hm, Sq, Sk]`` bool mask of the (q, k) pairs the
    indices (a :func:`prepare_indices` result) and the causal diagonal
    hide: what the Pallas ``_tile_mask`` computes tile by tile."""
    rows = torch.arange(sq, device=idx.device).view(1, 1, sq, 1)
    col = [idx[..., c].unsqueeze(2) for c in range(idx.shape[-1])]
    if idx.shape[-1] == 1:
        hidden = rows >= col[0]
    else:
        hidden = (rows >= col[0]) & (rows < col[1])
        if idx.shape[-1] == 4:
            hidden |= (rows >= col[2]) & (rows < col[3])
    if causal:
        hidden = hidden | (rows < torch.arange(sk, device=idx.device))
    return hidden


# ---------------------------------------------------------- plain versions


def flashmask_fwd_reference(q, k, v, idx, causal: bool,
                            scale: float) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The plain version of K5: ``(o [B,Sq,H,D] in q's dtype, lse [B,H,1,Sq]
    f32)``, in f32 over the whole score matrix (in float64 for float64
    inputs, lse too). P is zeroed where the mask hides a pair (not where
    its value underflows), and the denominator is clamped at 1e-30, so a
    fully masked row gives O = 0 and lse = -1e30 + log(1e-30), as the
    Pallas kernel does."""
    f = torch.promote_types(q.dtype, torch.float32)
    hide = disallowed(idx, q.shape[1], k.shape[1], causal)
    s = torch.einsum("bshd,bthd->bhst", q.to(f), k.to(f)) * scale
    s = torch.where(hide, NEG_INF, s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(hide, 0.0, torch.exp(s - m))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhst,bthd->bshd", p, v.to(f))
    o = o / den.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(den)).transpose(-1, -2)
    return o.to(q.dtype), lse


def flashmask_bwd_reference(q, k, v, o, lse, do, idx, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """The plain version of K6 and K7: ``(dq, dk, dv)`` in the dtypes of q,
    k and v, with P = exp(s − lse) recomputed in f32 (in float64 for
    float64 inputs) and zeroed where the mask hides a pair; dS = P∘(dO·Vᵀ − Δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q,
    dV = Pᵀ·dO."""
    f = torch.promote_types(q.dtype, torch.float32)
    hide = disallowed(idx, q.shape[1], k.shape[1], causal)
    s = torch.einsum("bshd,bthd->bhst", q.to(f), k.to(f)) * scale
    p = torch.where(hide, 0.0, torch.exp(s - lse.to(f).transpose(-1, -2)))
    dof = do.to(f)
    dp = torch.einsum("bshd,bthd->bhst", dof, v.to(f))
    # Δ = rowsum(dO∘O) as _delta forms it, [B, H, Sq, 1]
    ds = p * (dp - (dof * o.to(f)).sum(-1).transpose(1, 2)[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, k.to(f)) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.to(f)) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels


def kernel_for(pass_name: str, dtype: torch.dtype) -> str:
    """The kernel (a key of :data:`SOURCES`) that runs ``pass_name``
    (``"fwd"``, ``"bwd_dq"`` or ``"bwd_dkv"``) for ``dtype``: K5, K6 and
    K7 on the tensor cores, in the 16-bit type for bfloat16 and float16
    (``*_sm90``), in 3×TF32 for float32 (``*_tf32``)."""
    if dtype not in _DTYPES:
        raise TypeError(f"the kernels take float32, bfloat16 or float16, "
                        f"got {dtype}")
    if pass_name not in ("fwd", "bwd_dq", "bwd_dkv"):
        raise ValueError(f"no pass {pass_name!r}")
    return pass_name + ("_tf32" if dtype == torch.float32 else "_sm90")


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, symbol, tensor_cores = SOURCES[name]
        fn = getattr(_build.load(source), symbol)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        # ... | dtype B Sq Sk H D Hm ncol | strides | causal scale stream
        # a tensor-core kernel takes a tiles pointer after its outputs
        if name.startswith("fwd"):
            # q k v idx o lse (tiles) | 8 ints | 9 strides | tail
            fn.argtypes = ([ptr] * (6 + tensor_cores) + [i32] * 8 + [i64] * 9
                           + [i32, f32, ptr])
        else:
            # q k v do lse delta idx dq dk dv (tiles) | 8 ints | 12 strides
            # | tail
            fn.argtypes = ([ptr] * (10 + tensor_cores) + [i32] * 8
                           + [i64] * 12 + [i32, f32, ptr])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build() -> None:
    """Build and load K5, K6 and K7 now (their six sources compile in
    parallel) instead of at their first launch."""
    _build.build_all(sorted({source for source, _, _ in SOURCES.values()}))
    for name in SOURCES:
        _kernel(name)


def _index_args(idx):
    return idx.data_ptr(), idx.shape[1], idx.shape[3]


def flashmask_fwd(q, k, v, startend_row_indices, causal: bool, scale: float,
                  *, device=DEFAULT_DEVICE) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Masked attention forward over ``[B, S, H, D]``: ``(o, lse)`` as the
    Pallas ``_fm_fwd`` returns them. ``device`` is where the caller means
    to run (default CUDA); the tensors must lie there. On CUDA K5 launches
    or this raises; on the CPU the plain version runs."""
    _check(q, k, v)
    _resolve(q, device, 0.0, None)
    idx = prepare_indices(startend_row_indices, q, k, causal)
    return flashmask_fwd_op(q, k, v, idx, bool(causal), float(scale))


def _fwd_op_cuda(q, k, v, idx, causal, scale):
    """K5 as a registered operator, ``paddle_tpu_torch::flashmask_fwd``:
    ``(o, lse)`` over :func:`prepare_indices`' ``idx``. For CUDA tensors K5
    launches or this raises; for CPU tensors the plain version runs."""
    return _launch_fwd(q, k, v, idx, causal, scale)


def _fwd_op_cpu(q, k, v, idx, causal, scale):
    o, lse = flashmask_fwd_reference(q, k, v, idx, causal, scale)
    return o.contiguous(), lse.contiguous()


def _fwd_op_fake(q, k, v, idx, causal, scale):
    b, sq, h, d = q.shape
    return (q.new_empty((b, sq, h, d)),
            q.new_empty((b, h, 1, sq), dtype=_compute_type(q)))


flashmask_fwd_op = _registry.define(
    "flashmask_fwd(Tensor q, Tensor k, Tensor v, Tensor idx, bool "
    "causal, float scale) -> (Tensor, Tensor)",
    cuda=_fwd_op_cuda, cpu=_fwd_op_cpu, fake=_fwd_op_fake)


def _launch_fwd(q, k, v, idx, causal, scale):
    global fwd_launches
    o, lse = _run_fwd(q, k, v, idx, causal, scale)
    fwd_launches += 1
    return o, lse


def _run_fwd(q, k, v, idx, causal, scale, tiles=None):
    """One launch of K5 for ``q``'s dtype; ``tiles``, a zeroed int32 pair
    on the device, takes the kernel's tile counts."""
    hooks.check_launch("flashmask_fwd")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs((q, k, v), d, _DTYPES)
    _check_shape(b, sq, sk, h)
    name = kernel_for("fwd", q.dtype)
    extra = ()
    if SOURCES[name][2]:
        q, k, v = (_for_tma(t) for t in (q, k, v))
        extra = (None if tiles is None else tiles.data_ptr(),)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    fn = _kernel(name)
    idx_ptr, hm, ncol = _index_args(idx)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), idx_ptr,
                 o.data_ptr(), lse.data_ptr(), *extra, _DTYPES[q.dtype], b,
                 sq, sk, h, d, hm, ncol, *_strides(q, k, v), int(causal),
                 scale, stream)
    if err != 0:
        _raise_launch("flashmask_fwd", err)
    return o, lse


def fwd_tiles(q, k, v, startend_row_indices, causal: bool,
              scale: float) -> Tuple[int, int]:
    """``(live, bound)``: the k tiles K5's blocks computed and the k tiles
    within their causal bound, summed over the blocks (64-key tiles, or
    32-key ones for float32 at D = 128), from one launch on CUDA tensors
    with the kernel's tile counter on. Not counted in
    :data:`fwd_launches`: the counted path is :func:`flashmask_fwd`."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("only the kernel on CUDA counts its tiles")
    idx = prepare_indices(startend_row_indices, q, k, causal)
    tiles = torch.zeros(2, dtype=torch.int32, device=q.device)
    _run_fwd(q, k, v, idx, bool(causal), float(scale), tiles)
    live, bound = tiles.tolist()
    return live, bound


def flashmask_bwd(q, k, v, o, lse, do, startend_row_indices, causal: bool,
                  scale: float, *, device=DEFAULT_DEVICE
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked attention backward: ``(dq, dk, dv)`` as the Pallas
    ``_fm_bwd`` returns them, from the forward's ``o`` and ``lse`` and the
    output gradient ``do``. Δ = rowsum(dO∘O) is plain torch; on CUDA K6
    (dQ) and K7 (dK, dV) launch or this raises; on the CPU the plain
    version runs."""
    _check(q, k, v)
    if do.shape != o.shape or o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    _resolve(q, device, 0.0, None)
    idx = prepare_indices(startend_row_indices, q, k, causal)
    return flashmask_bwd_op(q, k, v, o, lse, do, idx, bool(causal),
                            float(scale))


def _bwd_op_cuda(q, k, v, o, lse, do, idx, causal, scale):
    """K6 and K7 as one registered operator,
    ``paddle_tpu_torch::flashmask_bwd``: ``(dq, dk, dv)``. For CUDA tensors
    K6 then K7 launch or this raises; for CPU tensors the plain version
    runs."""
    args, (dq, dk, dv, *_) = bwd_launch_args(q, k, v, o, lse, do, idx,
                                             causal, scale)
    _launch_bwd(args, q.device)
    return dq, dk, dv


def _bwd_op_cpu(q, k, v, o, lse, do, idx, causal, scale):
    return tuple(t.contiguous() for t in flashmask_bwd_reference(
        q, k, v, o, lse, do, idx, causal, scale))


def _bwd_op_fake(q, k, v, o, lse, do, idx, causal, scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


flashmask_bwd_op = _registry.define(
    "flashmask_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor "
    "lse, Tensor do, Tensor idx, bool causal, float scale) -> "
    "(Tensor, Tensor, Tensor)",
    cuda=_bwd_op_cuda, cpu=_bwd_op_cpu, fake=_bwd_op_fake)


def bwd_launch_args(q, k, v, o, lse, do, idx, causal, scale):
    """Checks the backward's CUDA inputs (``idx`` from
    :func:`prepare_indices`) and returns ``(args, (dq, dk, dv, *keep))``:
    the argument list of each pass (``args["bwd_dq"]``,
    ``args["bwd_dkv"]``), Δ computed and the outputs allocated; ``keep``
    holds what else the arguments point to, to be kept alive until the
    launches. :func:`run_bwd_pass` launches one pass on it (for timing one
    kernel alone); :func:`flashmask_bwd` launches both."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs((q, k, v, do), d, _DTYPES)
    _check_shape(b, sq, sk, h)
    if do.dtype != q.dtype:
        raise TypeError(f"do must have q's dtype {q.dtype}, got {do.dtype}")
    if (lse.shape != (b, h, 1, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("lse must be the forward's contiguous "
                         "[B, H, 1, Sq] float32 tensor")
    delta = _delta(o, do)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device)
    idx_ptr, hm, ncol = _index_args(idx)
    # q, k, v and dO as each pass's kernel reads them: a tensor-core kernel
    # gets copies of what TMA cannot read in place, made once and shared;
    # the others read the tensors as they are
    plain, tma, args = (q, k, v, do), None, {}
    for name in ("bwd_dq", "bwd_dkv"):
        ops = plain
        if SOURCES[kernel_for(name, q.dtype)][2]:
            if tma is None:
                tma = tuple(_for_tma(t) for t in plain)
            ops = tma
        args[name] = (ops[0].data_ptr(), ops[1].data_ptr(),
                      ops[2].data_ptr(), ops[3].data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), idx_ptr, dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq,
                      sk, h, d, hm, ncol, *_strides(*ops), int(causal),
                      scale)
    # delta and any TMA copies must outlive the launches: they ride along
    # with the outputs
    return args, (dq, dk, dv, delta, *(tma or ()))


def run_bwd_pass(name: str, args, device, tiles=None) -> None:
    """Launch K6 (``"bwd_dq"``) or K7 (``"bwd_dkv"``) on
    :func:`bwd_launch_args`' arguments, the kernel for their dtype; raises
    if the launch fails. ``tiles``, a zeroed int32 pair on the device, takes
    a tensor-core kernel's tile counts. Not counted: the counted path is
    :func:`flashmask_bwd`."""
    hooks.check_launch(f"flashmask {name}")
    pass_args = args[name]
    kernel = kernel_for(name, _DTYPE_OF[pass_args[10]])  # [10]: dtype
    if SOURCES[kernel][2]:
        pass_args = (*pass_args[:10],
                     None if tiles is None else tiles.data_ptr(),
                     *pass_args[10:])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(kernel)(*pass_args, stream)
    if err != 0:
        _raise_launch(f"flashmask {name}", err)


def bwd_tiles(q, k, v, o, lse, do, startend_row_indices, causal: bool,
              scale: float) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``(dq_tiles, dkv_tiles)``, each ``(live, bound)``: the k tiles K6's
    blocks computed and those within their causal bound, then the q tiles
    K7's blocks computed and those within theirs, summed over the blocks,
    from one launch of each kernel on CUDA tensors with its tile counter
    on. Not counted in :data:`dq_launches` or :data:`dkv_launches`: the
    counted path is :func:`flashmask_bwd`."""
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("only the kernels on CUDA count their tiles")
    idx = prepare_indices(startend_row_indices, q, k, causal)
    args, keep = bwd_launch_args(q, k, v, o, lse, do, idx, bool(causal),
                                 float(scale))
    counts = []
    for name in ("bwd_dq", "bwd_dkv"):
        tiles = torch.zeros(2, dtype=torch.int32, device=q.device)
        run_bwd_pass(name, args, q.device, tiles)
        live, bound = tiles.tolist()
        counts.append((live, bound))
    del keep  # tolist() waited for the launches that read it
    return counts[0], counts[1]


def _launch_bwd(args, device) -> None:
    global dq_launches, dkv_launches
    run_bwd_pass("bwd_dq", args, device)
    dq_launches += 1
    run_bwd_pass("bwd_dkv", args, device)
    dkv_launches += 1


# ---------------------------------------------------------------- autograd


class FlashMaskFunction(torch.autograd.Function):
    """Differentiable masked attention, the counterpart of the Pallas
    ``flashmask_value`` custom VJP: the forward runs K5 and saves ``(q, k,
    v, idx, o, lse)``; the backward runs K6 and K7 on them (plain versions
    for CPU tensors). ``idx`` is a :func:`prepare_indices` result."""

    @staticmethod
    def forward(ctx, q, k, v, idx, causal, scale):
        o, lse = flashmask_fwd(q, k, v, idx, causal, scale, device=q.device)
        ctx.save_for_backward(q, k, v, idx, o, lse)
        ctx.args = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, idx, o, lse = ctx.saved_tensors
        causal, scale = ctx.args
        dq, dk, dv = flashmask_bwd(q, k, v, o, lse, do.contiguous(), idx,
                                   causal, scale, device=q.device)
        return dq, dk, dv, None, None, None


def flashmask_value(q, k, v, startend_row_indices, causal: bool = True,
                    scale: float = 1.0, *,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Differentiable masked attention (the Pallas ``flashmask_value``):
    the output ``[B, Sq, H, D]`` in q's dtype. ``device`` is where the
    caller means to run (default CUDA); the tensors must lie there."""
    _check(q, k, v)
    _resolve(q, device, 0.0, None)
    idx = prepare_indices(startend_row_indices, q, k, causal)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flashmask_fwd(q, k, v, idx, causal, scale, device=q.device)[0]
    return FlashMaskFunction.apply(q, k, v, idx, bool(causal), float(scale))
