"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or ``paddle_tpu``. Module paths mirror ``paddle_tpu``'s so each
piece's counterpart is easy to find. Every entry point runs on the GPU
(``device="cuda"``, or the device ``set_device`` chose) unless the caller
asks for the CPU, and every TPU kernel on the ported path is a hand-written
Hopper kernel under ``ops/cuda/csrc`` with a plain PyTorch version beside
it.

The top level is Paddle's: ``Tensor`` (a ``torch.Tensor`` subclass with
Paddle's methods), ``Parameter`` (a ``torch.nn.Parameter`` with Paddle's
attributes), ``Layer``, ``to_tensor`` and the functional ops of ``ops``
(creation, math, manipulation, logic, search, statistics, random, the
linear algebra, ``einsum``), the dtypes (torch's own), ``seed``, the grad
mode, ``set_device``, ``grad``, and the subpackages (``autograd``,
``linalg``, ``nn``, ...). ``core/dispatch.py``, ``core/kernel_cache.py`` and
``base/jax_compat.py`` have no counterpart: torch's dispatcher does their
work. A name of the JAX top level that is not ported yet raises
``NotImplementedError`` naming its item of ``ROADMAP.md``. Importing the
package touches no CUDA and compiles nothing.

Ported so far: GPT paged decode serving (``serving.DecodeEngine`` over
``models.gpt.GPTForCausalLM``) with the flash-attention forward kernel;
the GPT and Llama training steps (``jit.TrainStep``, ``optimizer.AdamW``,
``amp`` O2) with the flash-attention backward kernels and the RMSNorm
kernel; the batch serving tier: ``jit.save``/``jit.load`` over
``torch.export``, ``inference.Predictor`` with one CUDA graph a
(batch, seq) rung, and ``serving.ServingEngine``; the training-step API:
``optimizer.lr`` schedulers, parameter groups, ``nn.ClipGradBy*``, the ten
optimizers, ``amp`` O1/O2 in bf16 or fp16 with ``amp.GradScaler``, and
``nn.CrossEntropyLoss``; BERT/ERNIE fine-tuning with shape bucketing;
ResNet and PP-LiteSeg training (``vision.models``, convolution, BatchNorm
and pooling layers) with a multi-tensor Momentum kernel; the training
loop: ``Model`` (``hapi``) with ``fit``/``evaluate``/``predict``, callbacks
and ``metric`` s over ``io.DataLoader`` (worker processes) and
``io.DeviceLoader`` (batches staged on the card), with preemption-safe
snapshots (``reliability.TrainSnapshotter``) and the flight recorder,
memory sampler and numerics witness of ``observability``; and the
Paddle-style top level above, on which ``bench.py``'s training arms run
with only their imports renamed; and the model-authoring API:
``nn.Layer``, ``Parameter``, ``nn.ParamAttr``, ``nn.initializer``,
``autograd`` (``backward``, ``PyLayer``, ``saved_tensors_hooks``), the
transformer stack (``nn.Transformer``, ``nn.MultiHeadAttention``, ...),
``linalg`` and ``einsum``; and the op-interception tier: one
``TorchDispatchMode`` (``core/hooks.py``) under static mode
(``enable_static``, ``static.Program``/``Executor``, replayed as one CUDA
graph a signature, ``save_inference_model``), ``amp.debugging``,
``FLAGS_check_nan_inf``, ``register_op`` custom ops and the profiler's op
events, with ``TensorArray``, ``SelectedRows`` and ``StringTensor``.
"""
import torch as _torch

from . import tensor, version
from .base import dtype as _dtype
from .base.dtype import (bfloat16, complex64, complex128, finfo, float16,
                         float32, float64, iinfo, int8, int16, int32, int64,
                         uint8)
from .base.flags import get_flags, set_flags
from .base.global_state import (enable_grad, get_default_dtype,
                                is_grad_enabled, no_grad, seed,
                                set_default_dtype, set_grad_enabled)
from .core import hooks as _hooks  # noqa: F401 — the interception mode
from .core import tensor_methods as _tensor_methods  # noqa: F401
from .core.autograd import grad
from .core.custom_op import get_custom_op, register_op, run_custom_op
from .core.tensor_array import SelectedRows, StringTensor, TensorArray
from .core.tensor import Parameter, Tensor, to_tensor
from .device import (DEFAULT_DEVICE, CPUPlace, CUDAPlace, device_count,
                     get_device, is_compiled_with_cuda, resolve_device,
                     set_device, synchronize)
from .tensor import *  # noqa: F401,F403 — the functional ops
from .version import __version__
from ._late_imports import *  # noqa: F401,F403 — the subpackages
from . import autograd, linalg
from .distributed.parallel import DataParallel
from .nn.layer.layers import Layer
from .static.program import disable_static, enable_static

bool = _dtype.bool_  # noqa: A001 — paddle.bool
dtype = _torch.dtype


def in_dynamic_mode() -> bool:
    return True


def in_dygraph_mode() -> bool:
    return True


# the JAX top level's names that are not ported yet, by ROADMAP.md item
_NOT_PORTED = {
    "queue 1 item 1, the JAX dispatcher's helpers, which have no "
    "counterpart": ("TPUPlace", "unwrap", "passthrough", "primitive"),
    "queue 1 item 9": ("analysis",),
    "queue 1 item 10": ("audio", "distribution", "fft", "geometric", "onnx",
                        "signal", "sparse", "text"),
}


def __getattr__(name):
    for item, names in _NOT_PORTED.items():
        if name in names:
            raise NotImplementedError(
                f"paddle_tpu_torch.{name} is not ported yet (ROADMAP.md, "
                f"{item})")
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")
