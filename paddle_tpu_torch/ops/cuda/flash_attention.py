"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain versions.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``. Three kernels replace
the three Pallas bodies; each source comment states its design and bound:

- K1 replaces ``_fwd_kernel`` (launched by ``_flash_fwd``): O and the row
  logsumexp, with in-kernel dropout;
- K2 and K3 replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (both
  launched by ``_flash_bwd``): the dQ pass and the dK/dV pass of the
  two-pass recompute backward.

Each kernel has one version per dtype (:func:`kernel_for`), and every
one runs on the tensor cores with wgmma, fed by TMA: bfloat16 and float16
K1–K3 in ``csrc/flash_attention_fwd_sm90.cu``,
``csrc/flash_attention_dq_sm90.cu`` and
``csrc/flash_attention_dkv_sm90.cu`` (one instantiation each over the
element type, as the Pallas kernels are dtype-generic); float32 K1–K3 in
``csrc/flash_attention_fwd_tf32.cu``, ``csrc/flash_attention_dq_tf32.cu``
and ``csrc/flash_attention_dkv_tf32.cu``, in 3×TF32 (each product a·b as
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi of TF32 parts, summed in f32, which keeps
the f32 path's precision where one TF32 product would not). TMA reads an
operand only from a 16-byte aligned base with strides that are multiples
of 16 bytes (:func:`tma_aligned`); the wrapper gives the kernels that read
through TMA (:data:`TMA_KERNELS`) a contiguous copy of any other operand and
counts it in :data:`tma_copies`.

Each wrapper launches its kernel for CUDA tensors or raises — no
fallback — and runs the plain PyTorch version for CPU tensors. K1's
forward is the registered operator ``paddle_tpu_torch::flash_attention_fwd``
(:func:`flash_attention_fwd_op`: CUDA runs the kernel, the CPU the plain
version, and a fake version gives the shapes), so ``torch.export`` keeps it
as one node of an exported graph (``jit.save``) instead of tracing the
plain version. The plain
versions materialize the probabilities; the CPU tests hold them against
the Pallas kernels in interpret mode and the on-card checks hold the
kernels against them. :data:`launches` (K1), :data:`dq_launches` (K2) and
:data:`dkv_launches` (K3) count kernel launches, and only those.

Dropout is the Pallas ``_dropout_mask`` hash, bit for bit: a murmur3
finalizer of ``(seed, b, h, iq, ik, row, col)`` in wrapping uint32, where
``iq``/``ik`` are the Pallas tile ids and ``row``/``col`` the positions
inside the tile. The tiles are the Pallas ones (:func:`blocks`), whatever
tiles the CUDA kernels use, so the forward, the dQ pass and the dK/dV
pass replay one mask, the one the JAX package draws for the same seed.
The seed is a ``(1,)`` int32 tensor on the tensors' device; the kernels
read it there, so no launch waits on the host.

Layout is the JAX package's ``[batch, seq, heads, head_dim]``; causal is
top-left (``q_pos >= k_pos``) as in the Pallas kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...device import DEFAULT_DEVICE, resolve_device
from . import _build

__all__ = ["flash_attention_fwd", "flash_attention_fwd_op",
           "flash_attention_fwd_reference",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_value", "FlashAttentionFunction", "dropout_keep",
           "blocks", "build", "bwd_launch_args", "run_bwd_pass", "launches",
           "dq_launches", "dkv_launches", "dropout_launches", "tma_copies",
           "kernel_for", "tma_aligned", "SOURCES", "TMA_KERNELS",
           "HEAD_DIMS", "NEG_INF", "BLOCK_Q", "BLOCK_K"]

NEG_INF = -1e30
#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: the Pallas kernels' default tiles, on which the dropout mask depends
BLOCK_Q, BLOCK_K = 256, 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_DTYPE_OF = {code: dtype for dtype, code in _DTYPES.items()}

#: K1 launches so far (plain-version calls are not counted)
launches = 0
#: K2 (dQ pass) launches so far
dq_launches = 0
#: K3 (dK/dV pass) launches so far
dkv_launches = 0
#: launches with dropout on, by kernel (a subset of the three counts above)
dropout_launches = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
#: operands copied because TMA could not read them in place
tma_copies = 0

#: kernel name -> (source in ``csrc/``, C entry point, whether the kernel
#: reads q, k, v and dO through TMA tensor maps)
SOURCES = {
    "fwd_sm90": ("flash_attention_fwd_sm90",
                 "paddle_flash_attention_fwd_sm90", True),
    "fwd_tf32": ("flash_attention_fwd_tf32",
                 "paddle_flash_attention_fwd_tf32", True),
    "bwd_dq_sm90": ("flash_attention_dq_sm90",
                    "paddle_flash_attention_bwd_dq_sm90", True),
    "bwd_dq_tf32": ("flash_attention_dq_tf32",
                    "paddle_flash_attention_bwd_dq_tf32", True),
    "bwd_dkv_sm90": ("flash_attention_dkv_sm90",
                     "paddle_flash_attention_bwd_dkv_sm90", True),
    "bwd_dkv_tf32": ("flash_attention_dkv_tf32",
                     "paddle_flash_attention_bwd_dkv_tf32", True),
}
#: the kernels that read q, k, v (and dO) through TMA tensor maps
TMA_KERNELS = frozenset(name for name, (_, _, tma) in SOURCES.items() if tma)
# the C entry points' status when a TMA tensor map cannot be encoded
_ERR_TENSOR_MAP = 9001

_fns: Dict[str, object] = {}
_zero_seeds: Dict[torch.device, torch.Tensor] = {}

_U32 = 0xFFFFFFFF
# the multipliers of the Pallas hash: b, h, iq, ik; then row and col reuse
# the first two
_MIX = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
_FNV = 0x01000193


# ---------------------------------------------------------------- tiling


def blocks(sq: int, sk: int, block_q: int = BLOCK_Q,
           block_k: int = BLOCK_K) -> Tuple[int, int]:
    """The Pallas tiling (``_blocks``): each block is halved until it
    divides its sequence length."""
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    while sq % block_q:
        block_q //= 2
    while sk % block_k:
        block_k //= 2
    return max(block_q, 1), max(block_k, 1)


def _threshold(p: float) -> int:
    """Keep iff the hash is at most this; computed in Python doubles, as
    the Pallas kernel computes it."""
    return int((1.0 - p) * 0xFFFFFFFF)


# ---------------------------------------------------------------- dropout


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c``: the constant is split into 16-bit halves so that no product
    leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def dropout_keep(seed: torch.Tensor, b, h, rows: int, cols: int,
                 block_q: int, block_k: int, p: float) -> torch.Tensor:
    """The plain version of the Pallas ``_dropout_mask`` at global
    positions: ``keep[..., r, c]`` (``r < rows``, ``c < cols``) is
    ``hash(seed, b, h, r // block_q, c // block_k, r % block_q,
    c % block_k) <= uint32((1 - p) * 0xFFFFFFFF)``.

    ``seed`` is a ``(1,)`` int32 tensor. ``b`` and ``h`` are ints or int64
    tensors that broadcast against ``[rows, cols]``: ``[B, 1, 1, 1]`` and
    ``[1, H, 1, 1]`` give a ``[B, H, rows, cols]`` mask. Every step is
    exact uint32 arithmetic carried in int64."""
    dev = seed.device
    key = seed.reshape(()).to(torch.int64) & _U32
    for part, mult in ((b, _MIX[0]), (h, _MIX[1])):
        part = torch.as_tensor(part, dtype=torch.int64, device=dev)
        key = _mul32(key ^ _mul32(part, mult), _FNV)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    key = _mul32(key ^ _mul32(r // block_q, _MIX[2]), _FNV)
    key = _mul32(key ^ _mul32(c // block_k, _MIX[3]), _FNV)
    x = _mul32(r % block_q, _MIX[0]) ^ _mul32(c % block_k, _MIX[1]) ^ key
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x <= _threshold(p)


def _keep_bhqk(seed, b, h, sq, sk, block_q, block_k, p):
    """``[B, H, Sq, Sk]`` keep mask over the Pallas tiles of (sq, sk)."""
    bq, bk = blocks(sq, sk, block_q, block_k)
    dev = seed.device
    return dropout_keep(
        seed, torch.arange(b, device=dev).view(b, 1, 1, 1),
        torch.arange(h, device=dev).view(1, h, 1, 1), sq, sk, bq, bk, p)


def _zero_seed(device: torch.device) -> torch.Tensor:
    seed = _zero_seeds.get(device)
    if seed is None:
        # a normal tensor even when first made under inference_mode, so a
        # later training step may save it for backward
        with torch.inference_mode(False):
            seed = _zero_seeds[device] = torch.zeros(1, dtype=torch.int32,
                                                     device=device)
    return seed


# ---------------------------------------------------------- plain versions


def _compute_type(q) -> torch.dtype:
    """The plain versions compute in f32, and in float64 for float64
    inputs (the on-card checks' exact reference)."""
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q, k, causal, scale):
    """Scores ``[B, H, Sq, Sk]`` in the compute type and the causal mask
    (or None)."""
    sq, sk = q.shape[1], k.shape[1]
    f = _compute_type(q)
    s = torch.einsum("bshd,bthd->bhst", q.to(f), k.to(f)) * scale
    mask = None
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    return s, mask


def flash_attention_fwd_reference(q, k, v, causal: bool, scale: float,
                                  dropout: float = 0.0,
                                  seed: Optional[torch.Tensor] = None, *,
                                  block_q: int = BLOCK_Q,
                                  block_k: int = BLOCK_K
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1: ``(o [B,Sq,H,D] in q's dtype, lse
    [B,H,1,Sq] f32)``, computed in f32 over the whole score matrix (in
    float64, lse too, for float64 inputs). Under
    dropout the normalizer sums the undropped probabilities and the kept
    ones are scaled by ``1 / (1 - dropout)``, as in the Pallas kernel."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s, mask = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, 0.0)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout > 0.0:
        keep = _keep_bhqk(seed, b, h, sq, sk, block_q, block_k, dropout)
        p = torch.where(keep, p / (1.0 - dropout), 0.0)
    o = torch.einsum("bhst,bthd->bshd", p, v.to(p.dtype))
    o = o / den.squeeze(-1).transpose(1, 2)[..., None]
    lse = (m + torch.log(den)).transpose(-1, -2)
    return o.to(q.dtype), lse


def _delta(o, do):
    """Δ = rowsum(dO∘O) in f32 (float64 for float64 inputs), ``[B, H, 1,
    Sq]`` like lse (the Pallas wrapper computes it in XLA outside the
    kernels)."""
    f = _compute_type(do)
    return (do.to(f) * o.to(f)).sum(-1).transpose(1, 2)[:, :, None, :] \
        .contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, seed, causal: bool,
                                  scale: float, dropout: float = 0.0, *,
                                  block_q: int = BLOCK_Q,
                                  block_k: int = BLOCK_K
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain version of K2 and K3: ``(dq, dk, dv)`` in the dtypes of
    q, k and v, with P = exp(s − lse) recomputed over the whole score
    matrix in f32 (in float64 for float64 inputs):

    - dP′ = dO·Vᵀ, times keep/(1−p) under dropout; dS = P∘(dP′ − Δ);
    - dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = (P∘keep/(1−p))ᵀ·dO."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.transpose(-1, -2))
    if causal:
        p = torch.where(mask, p, 0.0)
    f = s.dtype
    dof = do.to(f)
    dp = torch.einsum("bshd,bthd->bhst", dof, v.to(f))
    p_av = p
    if dropout > 0.0:
        keep = _keep_bhqk(seed, b, h, sq, sk, block_q, block_k, dropout)
        p_av = torch.where(keep, p / (1.0 - dropout), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
    ds = p * (dp - _delta(o, do).transpose(-1, -2))
    dq = torch.einsum("bhst,bthd->bshd", ds, k.to(f)) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q.to(f)) * scale
    dv = torch.einsum("bhst,bshd->bthd", p_av, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernels


def kernel_for(pass_name: str, dtype: torch.dtype) -> str:
    """The kernel (a key of :data:`SOURCES`) that runs ``pass_name``
    (``"fwd"``, ``"bwd_dq"`` or ``"bwd_dkv"``) for ``dtype``: on the
    tensor cores in the 16-bit type for bfloat16 and float16, in 3×TF32
    for float32."""
    if dtype not in _DTYPES:
        raise TypeError(f"the kernels take float32, bfloat16 or float16, "
                        f"got {dtype}")
    if pass_name not in ("fwd", "bwd_dq", "bwd_dkv"):
        raise ValueError(f"no pass {pass_name!r}")
    return pass_name + ("_tf32" if dtype == torch.float32 else "_sm90")


def tma_aligned(shape, strides, address: int, dtype: torch.dtype) -> bool:
    """Whether TMA can read a ``[B, S, H, D]`` operand in place: bfloat16,
    float16 or float32, the last dim contiguous, the first element's byte
    ``address`` (or its offset from an aligned base) 16-byte aligned, and
    each of the batch, seq and head strides of a dim longer than 1 a
    positive multiple of 16 bytes below 2**40 (a dim of length 1 is never
    stepped)."""
    if dtype not in _DTYPES or strides[3] != 1 or address % 16:
        return False
    size = 4 if dtype == torch.float32 else 2
    return all(n == 1 or (0 < st and (size * st) % 16 == 0
                          and size * st < 2 ** 40)
               for n, st in zip(shape[:3], strides[:3]))


def _for_tma(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it in place, else a contiguous copy
    (counted in :data:`tma_copies`)."""
    global tma_copies
    if tma_aligned(t.shape, t.stride(), t.data_ptr(), t.dtype):
        return t
    tma_copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, symbol, _ = SOURCES[name]
        fn = getattr(_build.load(source), symbol)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        # causal scale dropout_on keep_prob thresh block_q block_k stream
        tail = [i32, f32, i32, f32, ctypes.c_uint32, i32, i32, ptr]
        if name.startswith("fwd"):
            # q k v o lse seed | dtype B Sq Sk H D | 9 strides | tail
            fn.argtypes = [ptr] * 6 + [i32] * 6 + [i64] * 9 + tail
        else:
            # q k v do lse delta seed dq dk dv | dtype B Sq Sk H D |
            # 12 strides | tail
            fn.argtypes = [ptr] * 10 + [i32] * 6 + [i64] * 12 + tail
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def build() -> None:
    """Build and load every K1–K3 kernel now (their six sources compile
    in parallel) instead of at their first launch."""
    _build.build_all(sorted({source for source, _, _ in SOURCES.values()}))
    for name in SOURCES:
        _kernel(name)


def _raise_launch(what: str, err: int) -> None:
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError(f"{what}: a TMA tensor map could not be encoded")
    raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, seq, heads, head_dim]")
    b, _, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2] != h
            or k.shape[3] != d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _resolve(q, device, dropout, seed):
    """The device the call runs on, after checking the tensors lie there
    and that dropout has its seed."""
    dev = resolve_device(device)
    if q.device.type != dev.type:
        raise ValueError(f"tensors lie on {q.device}, the call asked for "
                         f"{dev}")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout must be in [0, 1), got {dropout}")
    if dropout > 0.0:
        if seed is None:
            raise ValueError("dropout > 0 needs a seed: a (1,) int32 tensor "
                             "on the tensors' device")
        if (seed.shape != (1,) or seed.dtype != torch.int32
                or seed.device != q.device):
            raise ValueError(f"seed must be a (1,) int32 tensor on "
                             f"{q.device}, got {tuple(seed.shape)} "
                             f"{seed.dtype} on {seed.device}")
    return dev


def _check_kernel_inputs(tensors, d, dtypes=None):
    """Raise unless the kernels (of ``dtypes``, default K1–K3's) take
    ``tensors`` at head dim ``d``."""
    dtypes = _DTYPES if dtypes is None else dtypes
    if tensors[0].dtype not in dtypes:
        names = [str(t).replace("torch.", "") for t in dtypes]
        raise TypeError(f"the kernels take {', '.join(names[:-1])} or "
                        f"{names[-1]}, got {tensors[0].dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernels take head_dim in {HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("the last dim of q, k, v (and dO) must be "
                         "contiguous")


def _strides(*tensors):
    """Batch, seq and head strides of each tensor; a dim of length 1 is
    never stepped, so it gets the contiguous stride, which TMA takes."""
    out = []
    for t in tensors:
        d, h, s = t.shape[3], t.shape[2], t.shape[1]
        natural = (s * h * d, h * d, d)
        out += [t.stride(i) if t.shape[i] > 1 else natural[i]
                for i in range(3)]
    return out


def _dropout_args(dropout, seed, sq, sk, block_q, block_k, device):
    """(seed pointer, on, 1 - p, threshold, Pallas block_q, block_k)."""
    bq, bk = blocks(sq, sk, block_q, block_k)
    if dropout > 0.0:
        return (seed.data_ptr(), 1, 1.0 - dropout, _threshold(dropout), bq,
                bk)
    return _zero_seed(device).data_ptr(), 0, 1.0, _U32, bq, bk


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        dropout: float = 0.0,
                        seed: Optional[torch.Tensor] = None, *,
                        block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                        device=DEFAULT_DEVICE
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward over ``[B, S, H, D]``: ``(o, lse)`` as the Pallas
    ``_flash_fwd`` returns them. ``dropout > 0`` needs ``seed``, a ``(1,)``
    int32 tensor on the tensors' device; ``block_q``/``block_k`` are the
    Pallas tiles the mask follows. ``device`` is where the caller means to
    run (default CUDA); the tensors must lie there. On CUDA K1 launches or
    this raises; on the CPU the plain version runs."""
    _check(q, k, v)
    _resolve(q, device, dropout, seed)
    return flash_attention_fwd_op(q, k, v, seed, bool(causal), float(scale),
                                  float(dropout), int(block_q), int(block_k))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, seed: Optional[torch.Tensor],
                           causal: bool, scale: float, dropout: float,
                           block_q: int, block_k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a registered operator, ``paddle_tpu_torch::flash_attention_fwd``,
    so that ``torch.export`` keeps it as one node of the exported graph
    (its fake version gives the shapes) instead of tracing into the plain
    version; an exported program then launches K1 on the card. For CUDA
    tensors K1 launches or this raises; for CPU tensors the plain version
    runs. ``seed`` may be None when ``dropout == 0``."""
    return _launch_fwd(q, k, v, causal, scale, dropout, seed, block_q,
                       block_k)


@flash_attention_fwd_op.register_kernel("cpu")
def _fwd_op_cpu(q, k, v, seed, causal, scale, dropout, block_q, block_k):
    o, lse = flash_attention_fwd_reference(q, k, v, causal, scale, dropout,
                                           seed, block_q=block_q,
                                           block_k=block_k)
    return o.contiguous(), lse.contiguous()


@flash_attention_fwd_op.register_fake
def _fwd_op_fake(q, k, v, seed, causal, scale, dropout, block_q, block_k):
    b, sq, h, d = q.shape
    return (q.new_empty((b, sq, h, d)),
            q.new_empty((b, h, 1, sq), dtype=_compute_type(q)))


def _check_shape(b, sq, sk, h):
    if min(b, sq, sk, h) < 1 or h > 65535 or b > 65535:
        raise ValueError(f"unsupported shape: B={b} Sq={sq} Sk={sk} H={h}")


def _launch_fwd(q, k, v, causal, scale, dropout, seed, block_q, block_k):
    global launches
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs((q, k, v), d)
    _check_shape(b, sq, sk, h)
    name = kernel_for("fwd", q.dtype)
    if name in TMA_KERNELS:
        q, k, v = (_for_tma(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, 1, sq), dtype=torch.float32, device=q.device)
    drop = _dropout_args(dropout, seed, sq, sk, block_q, block_k, q.device)
    fn = _kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), drop[0], _DTYPES[q.dtype], b, sq, sk, h, d,
                 *_strides(q, k, v), int(causal), scale, *drop[1:], stream)
    if err != 0:
        _raise_launch("flash_attention_fwd", err)
    launches += 1
    if dropout > 0.0:
        dropout_launches["fwd"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, seed, causal: bool,
                        scale: float, dropout: float = 0.0, *,
                        block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                        device=DEFAULT_DEVICE
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward: ``(dq, dk, dv)`` as the Pallas ``_flash_bwd``
    returns them, from the forward's ``o`` and ``lse`` and the output
    gradient ``do``. Δ = rowsum(dO∘O) is plain torch; on CUDA K2 (dQ) and
    K3 (dK, dV) launch or this raises; on the CPU the plain version
    runs. ``seed`` and the tiles must be the forward's."""
    _check(q, k, v)
    if do.shape != o.shape or o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    dev = _resolve(q, device, dropout, seed)
    if dev.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                             causal, scale, dropout,
                                             block_q=block_q,
                                             block_k=block_k)
    return _launch_bwd(q, k, v, o, lse, do, seed, bool(causal), float(scale),
                       float(dropout), block_q, block_k)


def bwd_launch_args(q, k, v, o, lse, do, seed, causal, scale, dropout,
                    block_q=BLOCK_Q, block_k=BLOCK_K):
    """Checks the backward's CUDA inputs and returns ``(args, (dq, dk, dv,
    *keep))``: the argument list of each pass (``args["bwd_dq"]``,
    ``args["bwd_dkv"]``), Δ computed and the outputs allocated; ``keep``
    holds what else the arguments point to, to be kept alive until the
    launches. :func:`run_bwd_pass` launches one pass on it
    (for timing one kernel alone); :func:`flash_attention_bwd` launches
    both."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    _check_kernel_inputs((q, k, v, do), d)
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
    drop = _dropout_args(dropout, seed, sq, sk, block_q, block_k, q.device)
    # q, k, v and dO as each pass's kernel reads them: a kernel that reads
    # through TMA gets copies of what TMA cannot read in place, made once
    # and shared; the others read the tensors as they are
    plain, tma, args = (q, k, v, do), None, {}
    for name in ("bwd_dq", "bwd_dkv"):
        ops = plain
        if kernel_for(name, q.dtype) in TMA_KERNELS:
            if tma is None:
                tma = tuple(_for_tma(t) for t in plain)
            ops = tma
        args[name] = (ops[0].data_ptr(), ops[1].data_ptr(),
                      ops[2].data_ptr(), ops[3].data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), drop[0], dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, sq,
                      sk, h, d, *_strides(*ops), int(causal), scale,
                      *drop[1:])
    # delta and any TMA copies must outlive the launches: they ride along
    # with the outputs
    return args, (dq, dk, dv, delta, *(tma or ()))


def run_bwd_pass(name: str, args, device) -> None:
    """Launch K2 (``"bwd_dq"``) or K3 (``"bwd_dkv"``) on
    :func:`bwd_launch_args`' arguments, the kernel for their dtype; raises
    if the launch fails. Not counted: the counted path is
    :func:`flash_attention_bwd`."""
    pass_args = args[name]
    # pass_args[10]: dtype
    fn = _kernel(kernel_for(name, _DTYPE_OF[pass_args[10]]))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*pass_args, stream)
    if err != 0:
        _raise_launch(f"flash_attention {name}", err)


def _launch_bwd(q, k, v, o, lse, do, seed, causal, scale, dropout, block_q,
                block_k):
    global dq_launches, dkv_launches
    args, (dq, dk, dv, *_) = bwd_launch_args(q, k, v, o, lse, do, seed,
                                             causal, scale, dropout, block_q,
                                             block_k)
    run_bwd_pass("bwd_dq", args, q.device)
    dq_launches += 1
    run_bwd_pass("bwd_dkv", args, q.device)
    dkv_launches += 1
    if dropout > 0.0:
        dropout_launches["bwd_dq"] += 1
        dropout_launches["bwd_dkv"] += 1
    return dq, dk, dv


# ---------------------------------------------------------------- autograd


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the Pallas
    ``_fa_value`` custom VJP: the forward runs K1 and saves ``(q, k, v, o,
    lse, seed)``; the backward runs K2 and K3 on them (plain versions for
    CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout, seed, block_q,
                block_k):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, dropout, seed,
                                     block_q=block_q, block_k=block_k,
                                     device=q.device)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.args = (causal, scale, dropout, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seed = ctx.saved_tensors
        causal, scale, dropout, block_q, block_k = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, seed, causal,
                                         scale, dropout, block_q=block_q,
                                         block_k=block_k, device=q.device)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_value(q, k, v, causal: bool = False, scale: float = 1.0,
                          dropout: float = 0.0,
                          seed: Optional[torch.Tensor] = None, *,
                          block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                          device=DEFAULT_DEVICE) -> torch.Tensor:
    """Differentiable fused attention with optional in-kernel dropout (the
    Pallas ``flash_attention_value``). ``seed``: a ``(1,)`` int32 tensor
    on the tensors' device, required when ``dropout > 0``; without one a
    zero seed stands in, which only makes sense at ``dropout == 0``."""
    _check(q, k, v)
    _resolve(q, device, dropout, seed)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_attention_fwd(q, k, v, causal, scale, dropout, seed,
                                   block_q=block_q, block_k=block_k,
                                   device=q.device)[0]
    if seed is None:
        seed = _zero_seed(q.device)
    return FlashAttentionFunction.apply(q, k, v, bool(causal), float(scale),
                                        float(dropout), seed, block_q,
                                        block_k)
