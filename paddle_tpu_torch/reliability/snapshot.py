"""Atomic rolling train-state snapshots: preemption-safe training (port of
``paddle_tpu/reliability/snapshot.py``).

A :class:`TrainSnapshotter` lands, every ``snapshot_every`` steps of
``Model.fit`` and at a SIGTERM, one complete and atomic snapshot of what
the next process needs to continue the loss stream bit for bit:

- the global step, the epoch and the next batch (the loader's cursor:
  ``DataLoader.iter_from`` skips back to it at the index level, and the
  epoch pins the shuffle through ``set_epoch``);
- the model's parameters and persistent buffers, their raw bytes through
  the sharded writer (``distributed.checkpoint.sharded``), so bf16 and
  fp16 tensors come back bit for bit;
- the optimizer's state (accumulators, step count, scheduler);
- the states of the generators the step draws from: the model's own
  ``torch.Generator`` s (dropout, ``jit.api.model_generators``) and
  torch's default CPU and CUDA generators. The JAX snapshot saves its one
  global RNG key instead.

Commit protocol: everything is written into ``.tmp_<step>_<nonce>/``,
every file fsynced, then one ``os.rename`` publishes ``snap_<step>/`` and
the parent directory is fsynced. A crash (or an injected ``ckpt.write``
fault) at any point leaves the previous snapshot intact and an ignorable
tmp directory. ``latest()`` only sees renamed, complete snapshots. The
directory is rolling: the ``keep`` newest survive.

A snapshot reads the card after syncing it, so it sees what the replayed
steps wrote; a restore copies into the live parameters, optimizer cells
and generators in place, never rebinding one, so a step already captured
into a CUDA graph replays on the restored values. The JAX package's zero1
optimizer shards are not ported (``ROADMAP.md``, queue 7): a snapshot that
holds them raises.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Optional, Sequence

import torch

from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE, resolve_device
from .faults import fault_point
from .policy import RetryPolicy

__all__ = ["TrainSnapshotter", "fsync_dir"]

_SNAP_PREFIX = "snap_"
_TMP_PREFIX = ".tmp_"
_TMP_STALE_S = 3600.0
_FORMAT = "paddle_tpu_torch_train_snap_v1"


def _fsync_path(path: str) -> None:
    """fsync a file or a directory (best effort: not every filesystem
    supports directory fds)."""
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


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-published rename survives power loss."""
    _fsync_path(path)


def _default_generators() -> list:
    """torch's default CPU generator, and each CUDA device's once CUDA is
    initialized (reading one would initialize it)."""
    gens = [torch.default_generator]
    if torch.cuda.is_initialized():
        gens += [torch.cuda.default_generators[i]
                 for i in range(torch.cuda.device_count())]
    return gens


def _restore_default_generators(states: list, path: str) -> None:
    """Set torch's default generators from a snapshot's ``states`` (the
    CPU one first, then one a CUDA device). CUDA is initialized first when
    the snapshot holds CUDA states, so none is dropped for want of it; a
    count that still differs from this host's raises ``ValueError``."""
    gens = [torch.default_generator]
    if len(states) > 1 and torch.cuda.is_available():
        torch.cuda.init()
        gens += [torch.cuda.default_generators[i]
                 for i in range(torch.cuda.device_count())]
    if len(states) != len(gens):
        raise ValueError(f"{path} holds {len(states)} default generator "
                         f"states, this host has {len(gens)} default "
                         f"generators (the CPU one and one a CUDA device)")
    for gen, st in zip(gens, states):
        gen.set_state(st)


class TrainSnapshotter:
    """Rolling atomic snapshots under one directory.

    ``save``/``restore`` are the API ``Model.fit`` drives; both work
    standalone. Writes retry under the ``ckpt.write``
    :class:`~.policy.RetryPolicy`: a transient disk fault costs a backoff,
    not the snapshot."""

    def __init__(self, directory: str, keep: Optional[int] = None,
                 retry: bool = True):
        self.dir = str(directory)
        self.keep = int(get_flag("train_snapshot_keep")
                        if keep is None else keep)
        self._retry = (RetryPolicy("ckpt.write", max_delay_s=0.5)
                       if retry else None)

    # ------------------------------------------------------------- write
    def save(self, network=None, optimizer=None, *, step: int,
             epoch: int = 0, next_batch: int = 0,
             generators: Sequence[torch.Generator] = (),
             extra: Optional[dict] = None) -> str:
        """Land one complete snapshot for ``step``; returns its path.
        ``generators`` are the step's own generators (the model's), saved
        beside torch's defaults. A snapshot of the same step that already
        committed is kept as it is."""
        args = (network, optimizer, step, epoch, next_batch,
                list(generators), extra)
        if self._retry is not None:
            return self._retry.run(self._save_once, *args)
        return self._save_once(*args)

    def _save_once(self, network, optimizer, step, epoch, next_batch,
                   generators, extra) -> str:
        from ..distributed.checkpoint.sharded import save_sharded
        from ..framework.io import save as fw_save

        final = os.path.join(self.dir, f"{_SNAP_PREFIX}{int(step):08d}")
        if os.path.exists(os.path.join(final, "state.json")):
            return final
        # what the replayed steps wrote, on every stream, before any read
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(
            self.dir, f"{_TMP_PREFIX}{int(step):08d}_{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            state = {"format": _FORMAT, "step": int(step),
                     "epoch": int(epoch), "next_batch": int(next_batch),
                     "ts_unix": time.time(), "zero1": False}
            if extra:
                state["extra"] = extra
            if network is not None:
                save_sharded(network.state_dict(),
                             os.path.join(tmp, "params"))
            if optimizer is not None:
                fw_save(optimizer.state_dict(),
                        os.path.join(tmp, "opt.pdopt"))
            fw_save({"model": [g.get_state() for g in generators],
                     "default": [g.get_state()
                                 for g in _default_generators()]},
                    os.path.join(tmp, "rng.pdstate"))
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            for name in os.listdir(tmp):
                _fsync_path(os.path.join(tmp, name))
            # the injected torn-write point: a crash here leaves only the
            # tmp dir, and the previous snapshot stays the latest
            fault_point("ckpt.write")
            os.rename(tmp, final)  # the atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        fsync_dir(self.dir)
        self._prune()
        from ..observability.metrics import registry

        registry.counter(
            "reliability.snapshots",
            "rolling train-state snapshots committed by "
            "TrainSnapshotter").inc()
        return final

    # -------------------------------------------------------------- read
    def snapshots(self) -> list:
        """Committed snapshots, oldest first: ``[(step, path), ...]``."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not name.startswith(_SNAP_PREFIX):
                continue
            path = os.path.join(self.dir, name)
            if not os.path.exists(os.path.join(path, "state.json")):
                continue
            try:
                out.append((int(name[len(_SNAP_PREFIX):]), path))
            except ValueError:
                continue
        return sorted(out)

    def latest(self) -> Optional[str]:
        snaps = self.snapshots()
        return snaps[-1][1] if snaps else None

    @torch.no_grad()
    def restore(self, network=None, optimizer=None,
                path: Optional[str] = None, *,
                generators: Sequence[torch.Generator] = (),
                device=DEFAULT_DEVICE) -> dict:
        """Restore the newest (or ``path``'s) snapshot into the live
        objects, in place, and return its ``state.json`` (the loader's
        cursor). ``device`` is where the live tensors lie (default CUDA;
        raises without CUDA unless the CPU is asked for). Raises
        ``FileNotFoundError`` when nothing complete exists."""
        from ..distributed.checkpoint.sharded import load_sharded_like
        from ..framework.io import load as fw_load

        dev = resolve_device(device)
        if path is None:
            path = self.latest()
            if path is None:
                raise FileNotFoundError(
                    f"no complete snapshot under {self.dir!r} (tmp dirs "
                    "from interrupted saves are not restorable)")
        with open(os.path.join(path, "state.json")) as f:
            state = json.load(f)
        if state.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} snapshot")
        if state.get("zero1"):
            raise NotImplementedError(
                "zero1 optimizer shards are not ported yet (ROADMAP.md, "
                "queue 7)")
        if network is not None:
            live = network.state_dict()
            for name, t in live.items():
                if t.device.type != dev.type:
                    raise ValueError(f"{name} lies on {t.device}, the "
                                     f"restore was asked for {dev}")
            new = load_sharded_like(os.path.join(path, "params"), live)
            for name, t in live.items():
                t.copy_(new[name])
        if optimizer is not None:
            optimizer.set_state_dict(fw_load(os.path.join(path,
                                                          "opt.pdopt")))
        rng = fw_load(os.path.join(path, "rng.pdstate"))
        if len(rng["model"]) != len(generators):
            raise ValueError(f"{path} holds {len(rng['model'])} model "
                             f"generator states, the restore was given "
                             f"{len(generators)} generators")
        for gen, st in zip(generators, rng["model"]):
            gen.set_state(st)
        _restore_default_generators(rng["default"], path)
        return state

    # ------------------------------------------------------------- prune
    def _prune(self) -> None:
        snaps = self.snapshots()
        if self.keep > 0:
            for _step, path in snaps[:-self.keep]:
                shutil.rmtree(path, ignore_errors=True)
        now = time.time()
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.dir, name)
            try:
                if now - os.path.getmtime(path) > _TMP_STALE_S:
                    shutil.rmtree(path, ignore_errors=True)
            except OSError:
                pass
