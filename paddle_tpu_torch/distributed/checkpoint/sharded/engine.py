"""Sharded-checkpoint engine, single device (port of
``paddle_tpu/distributed/checkpoint/sharded/engine.py``).

- :func:`save_sharded` writes one raw piece file per tensor (``spec``
  null) under JAX's atomic publish: everything lands in a sibling
  ``.tmp_<name>_<nonce>`` dir, each piece fsynced, the manifest last, then
  one ``os.rename`` commits and the parent dir is fsynced. A crash, or an
  injected ``ckpt.write`` fault, at any point leaves either the previous
  committed checkpoint or an ignorable tmp dir.
- :func:`load_sharded` and :func:`load_sharded_like` assemble each tensor
  whole from whatever piece layout the checkpoint holds, including the
  dp-sharded pieces of a JAX save across 8 devices, and cast as JAX's
  ``_cast`` casts: float to float, a matching dtype passes through, and a
  non-float change is left alone by a blanket converting load and refused
  by a target-derived one.
- A torn, truncated or corrupt piece, or an incomplete piece set, raises
  naming the piece or the tensor. There are no partial loads.

Pieces are read and written through torch, never numpy, so ``bfloat16``
round-trips with no ``ml_dtypes``. Placement on a mesh (``mesh``,
``specs``) and ``convert_sharded`` wait for the distributed tier
(``ROADMAP.md``, queue 7). The engine knows nothing of model layouts:
``models.gpt.jax_state_dict`` and ``load_jax_state`` convert.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from ....device import DEFAULT_DEVICE, resolve_device
from ....observability.metrics import registry
from ....reliability.faults import fault_point
from . import manifest as mf

__all__ = ["save_sharded", "load_sharded", "load_sharded_like"]


def _tick(name: str, value: float = 1.0) -> None:
    registry.counter("ckpt." + name).inc(value)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-published rename survives power loss
    (best effort: not every filesystem supports directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten_state(state, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested state dict as ``{dotted name: tensor}``; numpy arrays
    become tensors."""
    flat = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_state(v, key + "."))
        elif isinstance(v, torch.Tensor):
            flat[key] = v
        elif isinstance(v, np.ndarray):
            flat[key] = torch.from_numpy(v)
    return flat


def _cast(t: torch.Tensor, target: Optional[torch.dtype], tensor_name: str,
          strict: bool = False) -> torch.Tensor:
    """JAX's dtype policy: float casts float to float; a matching dtype
    passes through. A blanket converting load (``strict=False``) leaves
    non-float tensors as they are; a target-derived dtype (``strict=True``,
    the hot-swap path) refuses any non-float change."""
    if target is None or t.dtype == target:
        return t
    if t.dtype.is_floating_point and target.is_floating_point:
        return t.to(target)
    if not strict:
        return t
    raise ValueError(
        f"sharded checkpoint: refusing to convert {tensor_name!r} from "
        f"{mf.dtype_name(t.dtype)} to {mf.dtype_name(target)} — only "
        "float→float conversion is supported (load with dtype=None to keep "
        "the saved dtype)")


# --------------------------------------------------------- atomic publish
def _new_tmp(directory: str, overwrite: bool, what: str):
    """Resolve the target, refuse a non-overwrite collision, create the
    sibling tmp dir the writer stages into. Returns ``(directory, parent,
    nonce, tmp)``."""
    directory = os.path.abspath(str(directory))
    if os.path.exists(directory) and not overwrite:
        raise FileExistsError(
            f"{directory} already exists — pass overwrite=True to replace "
            "the committed checkpoint")
    parent = os.path.dirname(directory)
    try:
        os.makedirs(parent, exist_ok=True)
    except OSError as e:
        raise OSError(f"{what}: cannot create checkpoint parent {parent!r}: "
                      f"{e}") from e
    nonce = uuid.uuid4().hex[:8]
    tmp = os.path.join(parent,
                       f"{mf.TMP_PREFIX}{os.path.basename(directory)}_{nonce}")
    try:
        os.makedirs(tmp)
    except OSError as e:
        raise OSError(f"{what}: cannot write under {parent!r} "
                      f"(read-only or unwritable): {e}") from e
    return directory, parent, nonce, tmp


def _commit(tmp: str, directory: str, nonce: str, manifest: dict) -> None:
    """Write and fsync the manifest into ``tmp``, then publish ``tmp`` as
    ``directory``: one atomic rename for a fresh target. An overwrite
    first moves the old checkpoint aside as a ``.tmp_old_<name>_<nonce>``
    sibling, so a crash between the two renames strands the complete
    previous checkpoint under a recoverable name (``read_manifest`` points
    at it); the old one is removed once the new one is in place."""
    mpath = os.path.join(tmp, mf.MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # the injected torn-write point: a crash here leaves only the tmp dir,
    # which read_manifest refuses
    fault_point("ckpt.write")
    if os.path.exists(directory):
        old = os.path.join(
            os.path.dirname(directory),
            f"{mf.TMP_PREFIX}old_{os.path.basename(directory)}_{nonce}")
        os.rename(directory, old)
        os.rename(tmp, directory)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, directory)  # the atomic publish


# --------------------------------------------------------------------- save
def _piece_bytes(t: torch.Tensor) -> bytes:
    """A tensor's raw C-order bytes, any dtype (bf16 included)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


def save_sharded(state: Dict, directory: str, *,
                 overwrite: bool = False) -> dict:
    """Write ``state`` (a possibly nested dict of tensors or numpy arrays)
    as one sharded checkpoint directory, one piece per tensor. Returns
    ``{"dir", "n_tensors", "n_pieces", "bytes", "max_piece_bytes",
    "seconds"}``. The publish is atomic (see :func:`_commit`);
    ``overwrite`` replaces an existing committed checkpoint."""
    t0 = time.perf_counter()
    directory, parent, nonce, tmp = _new_tmp(directory, overwrite,
                                             "save_sharded")
    flat = _flatten_state(state)
    entries = {}
    total = max_piece = 0
    try:
        for i, (name, t) in enumerate(flat.items()):
            shape = [int(d) for d in t.shape]
            data = _piece_bytes(t)
            fname = mf.piece_filename(i, name, 0)
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            entries[name] = {
                "shape": shape, "dtype": mf.dtype_name(t.dtype), "spec": None,
                "pieces": [{"file": fname,
                            "index": [[0, d] for d in shape],
                            "sha256": hashlib.sha256(data).hexdigest(),
                            "bytes": len(data)}]}
            total += len(data)
            max_piece = max(max_piece, len(data))
        _commit(tmp, directory, nonce,
                {"format": mf.FORMAT, "created_unix": time.time(),
                 "entries": entries})
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)
    _tick("pieces_saved", len(entries))
    _tick("saves")
    return {"dir": directory, "n_tensors": len(flat),
            "n_pieces": len(entries), "bytes": total,
            "max_piece_bytes": max_piece,
            "seconds": round(time.perf_counter() - t0, 4)}


# --------------------------------------------------------------------- load
class _PieceReader:
    """Reads one piece file whole, checks its byte count and (once a load)
    its sha256, and views its bytes as the manifest's dtype. Every defect
    raises naming the piece."""

    def __init__(self, directory: str, verify: bool = True):
        self.dir = directory
        self.verify = verify
        self._verified = set()

    def read(self, tensor: str, entry: dict, piece: dict) -> torch.Tensor:
        fname = piece["file"]
        path = os.path.join(self.dir, fname)
        if not os.path.exists(path):
            raise RuntimeError(
                f"sharded checkpoint {self.dir!r} is INCOMPLETE for "
                f"{tensor!r}: piece {fname!r} is missing — a shard file "
                "was lost or the save was torn; refusing a partial load")
        with open(path, "rb") as f:
            data = f.read()
        dtype = mf.torch_dtype(entry["dtype"])
        shape = tuple(int(b) - int(a) for a, b in piece["index"])
        want = math.prod(shape) * dtype.itemsize
        if len(data) != want:
            raise RuntimeError(
                f"sharded checkpoint piece {fname!r} ({tensor!r}) is "
                f"CORRUPT: {len(data)} bytes on disk, manifest promises "
                f"{want} — truncated or torn write; restore from a "
                "complete checkpoint")
        if self.verify and fname not in self._verified:
            if hashlib.sha256(data).hexdigest() != piece.get("sha256"):
                raise RuntimeError(
                    f"sharded checkpoint piece {fname!r} ({tensor!r}) is "
                    "CORRUPT: sha256 mismatch — the bytes rotted or were "
                    "torn mid-write; refusing to load them")
            self._verified.add(fname)
        if not data:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape)


def _assemble(reader: _PieceReader, tensor: str, entry: dict, target,
              strict: bool = False) -> torch.Tensor:
    """The whole of ``tensor``, assembled from its pieces however the
    saving grid laid them out, then cast. A coverage gap fails naming the
    tensor."""
    shape = tuple(int(d) for d in entry["shape"])
    pieces = entry["pieces"]
    if len(pieces) == 1 and [list(map(int, b)) for b in pieces[0]["index"]] \
            == [[0, d] for d in shape]:
        # one piece holding the whole tensor (the port's own layout)
        return _cast(reader.read(tensor, entry, pieces[0]), target, tensor,
                     strict)
    out = torch.zeros(shape, dtype=mf.torch_dtype(entry["dtype"]))
    covered = 0
    for piece in pieces:
        bounds = [(int(a), int(b)) for a, b in piece["index"]]
        arr = reader.read(tensor, entry, piece)
        out[tuple(slice(a, b) for a, b in bounds)] = arr
        covered += math.prod(b - a for a, b in bounds)
    numel = math.prod(shape)
    if covered != numel:
        raise RuntimeError(
            f"sharded checkpoint {reader.dir!r} is INCOMPLETE for "
            f"{tensor!r}: saved pieces cover {covered}/{numel} elements — "
            "shard file set incomplete; refusing a partial load")
    return _cast(out, target, tensor, strict)


def load_sharded(directory: str, *, dtype=None, names=None,
                 verify: bool = True,
                 device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Restore a sharded checkpoint as ``{name: tensor}`` on ``device``.

    - ``dtype``: optional converting load (one dtype, or name → dtype; a
      torch dtype or its name): float tensors cast float to float,
      non-float tensors keep their dtype.
    - ``names``: restrict to a subset of entries.
    - ``verify=False`` skips the sha256 pass (trusted local disk); byte
      counts and coverage are always enforced.
    """
    dev = resolve_device(device)
    man = mf.read_manifest(str(directory))
    reader = _PieceReader(str(directory), verify=verify)
    out = {}
    for name, entry in man["entries"].items():
        if names is not None and name not in names:
            continue
        want = dtype.get(name) if isinstance(dtype, dict) else dtype
        if isinstance(want, str):
            want = mf.torch_dtype(want)
        out[name] = _assemble(reader, name, entry, want).to(dev)
    _tick("loads")
    return out


def load_sharded_like(directory: str, targets: Dict[str, torch.Tensor], *,
                      require_all: bool = True,
                      verify: bool = True) -> Dict[str, torch.Tensor]:
    """New values for every tensor of ``targets`` (name → tensor), each on
    the target's device and in its dtype: the weight hot-swap's read path.
    Nothing in ``targets`` is touched. Missing checkpoint entries raise
    ``KeyError`` (``require_all``); a shape mismatch always raises
    ``ValueError``."""
    man = mf.read_manifest(str(directory))
    entries = man["entries"]
    missing = [k for k in targets if k not in entries]
    if missing and require_all:
        raise KeyError(
            f"sharded checkpoint {directory!r} is missing "
            f"{len(missing)} of the target's tensors (first: "
            f"{missing[:5]}) — it does not checkpoint this model")
    reader = _PieceReader(str(directory), verify=verify)
    out = {}
    for name, t in targets.items():
        if name not in entries:
            continue
        entry = entries[name]
        if [int(d) for d in entry["shape"]] != [int(d) for d in t.shape]:
            raise ValueError(
                f"sharded checkpoint {directory!r}: {name!r} has shape "
                f"{entry['shape']}, target expects {list(t.shape)}")
        out[name] = _assemble(reader, name, entry, t.dtype,
                              strict=True).to(t.device)
    _tick("loads")
    return out
