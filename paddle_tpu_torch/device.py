"""Device resolution for every entry point of the port, and
``paddle.set_device`` (port of ``paddle_tpu/device/__init__.py``).

Entry points (``GPTForCausalLM``, ``DecodeEngine``, the kernel wrappers)
take ``device=`` and default to :data:`DEFAULT_DEVICE`, which
:func:`resolve_device` reads at call time: the device :func:`set_device`
chose, and CUDA until then. A caller who did not ask for the CPU never
lands there: with no CUDA device present, resolving the default raises
instead of running somewhere else. ``set_device("cpu")`` is that asking.
"""
from __future__ import annotations

import torch

__all__ = ["CPUPlace", "CUDAPlace", "DEFAULT_DEVICE", "device_count",
           "get_device", "is_compiled_with_cuda", "resolve_device",
           "set_device", "synchronize"]


class _DefaultDevice(str):
    """The default of every ``device=`` argument: equal to ``"cuda"`` as a
    string, and told apart from an explicit ``"cuda"`` by identity, so
    that :func:`resolve_device` gives the device :func:`set_device`
    chose."""

    __slots__ = ()

    def __repr__(self):
        return "DEFAULT_DEVICE"


DEFAULT_DEVICE = _DefaultDevice("cuda")

# the device set_device chose; None until it is called: CUDA
_chosen = None


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device`` (:data:`DEFAULT_DEVICE`: the one
    :func:`set_device` chose, else CUDA); raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available, and ``ValueError`` for any
    device type other than ``cuda`` and ``cpu``."""
    if device is DEFAULT_DEVICE:
        device = _chosen if _chosen is not None else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' (or call set_device('cpu')) to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _parse(device: str) -> torch.device:
    """Paddle's device names: ``"gpu"``, ``"gpu:N"``, ``"cuda[:N]"`` and
    ``"cpu"``; anything else, ``"tpu"`` included, raises ``ValueError``."""
    if not isinstance(device, str):
        raise ValueError(f"set_device takes a name, not {device!r}")
    kind, _, index = device.strip().lower().partition(":")
    if kind == "cpu" and not index:
        return torch.device("cpu")
    if kind in ("gpu", "cuda") and (not index or index.isdigit()):
        return torch.device("cuda", int(index) if index else None)
    raise ValueError(f"unsupported device {device!r}: use 'gpu', 'gpu:N', "
                     f"'cuda[:N]' or 'cpu'")


def set_device(device: str) -> torch.device:
    """Make ``device`` the default of every entry point and of the tensor
    creation ops; returns it as a ``torch.device``. Raises (as
    :func:`resolve_device`) when it names CUDA and none is present."""
    global _chosen
    dev = resolve_device(_parse(device))
    _chosen = dev
    return dev


def get_device() -> str:
    """The default device by Paddle's name: ``"cpu"`` or ``"gpu:N"``.
    Before :func:`set_device`, CUDA (``"gpu:0"`` without touching CUDA)."""
    if _chosen is None:
        return "gpu:0"
    return "cpu" if _chosen.type == "cpu" else f"gpu:{_chosen.index}"


def device_count() -> int:
    """CUDA devices visible to this process."""
    return torch.cuda.device_count()


def synchronize(device=None) -> None:
    """Wait for every kernel queued on the CUDA device (none on the CPU)."""
    dev = resolve_device(device if device is not None else DEFAULT_DEVICE)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def is_compiled_with_cuda() -> bool:
    """Whether this torch was built with CUDA."""
    return torch.backends.cuda.is_built()


def CPUPlace() -> str:
    """The CPU, by the name :func:`set_device` takes."""
    return "cpu"


def CUDAPlace(index: int = 0) -> str:
    """CUDA device ``index``, by the name :func:`set_device` takes (the
    JAX package's ``CUDAPlace`` names its accelerator, the TPU)."""
    return f"gpu:{int(index)}"
