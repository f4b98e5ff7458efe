"""The high-level ``Model`` API (port of ``paddle_tpu/hapi/model.py``;
reference: python/paddle/hapi/model.py — ``Model.prepare``/``fit``/
``evaluate``/``predict``/``save``/``load`` and ``summary``).

A train batch runs through a ``jit.TrainStep``: on CUDA its second call
captures forward, backward and the optimizer's update as one CUDA graph,
and every later step replays it. ``fit`` keeps the card busy between log
boundaries: the step losses stay on the device in a :class:`MetricBuffer`
and reach the host only every ``sync_every`` steps and at the epoch's
end, and ``device_prefetch=N`` stages the next batches on the card from a
side stream while the current step runs, so a steady-state step makes no
host sync.

``fit`` is preemption safe: ``snapshot_dir`` arms atomic rolling snapshots
(``reliability.TrainSnapshotter``) every ``snapshot_every`` steps and at a
SIGTERM, which stops the loop at that step's boundary; ``resume=True``
restores the newest one and continues at the next batch, the loss stream
bit for bit the uninterrupted run's. ``Model`` runs on ``device``
(default CUDA; raises without CUDA unless the CPU is asked for), where the
network's parameters must lie; host batches are moved there.
"""
from __future__ import annotations

import logging
import os
import signal
import threading
from typing import List

import numpy as np
import torch

from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE, resolve_device
from ..io import DataLoader, Dataset, DeviceLoader
from ..metric.metrics import Metric, _to_numpy
from .callbacks import config_callbacks
from .metric_buffer import MetricBuffer, to_float

__all__ = ["Model"]

_log = logging.getLogger("paddle_tpu_torch")


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_device(values, device):
    """Each tensor (or numpy array) of ``values`` on ``device``."""
    out = []
    for v in values:
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if isinstance(v, torch.Tensor) and v.device != device:
            v = v.to(device)
        out.append(v)
    return out


class Model:
    """``paddle.Model(network)``: ``prepare`` then ``fit``/``evaluate``/
    ``predict``. ``inputs`` and ``labels`` (input specs) are accepted and
    read nowhere, as in the JAX package."""

    def __init__(self, network, inputs=None, labels=None, *,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        for p in network.parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"the network lies on {p.device}, the "
                                 f"model was asked for {self.device}")
        self.network = network
        self.stop_training = False
        self._preempted = False  # SIGTERM seen mid-fit (snapshot + stop)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None

    # ------------------------------------------------------------ prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        """The optimizer, the loss (``loss(outputs, label)``) and the
        metrics. ``amp_configs`` is accepted and read nowhere, as in the
        JAX package: AMP is the network's own (``amp.decorate``,
        ``amp.auto_cast`` in its forward)."""
        self._optimizer = optimizer
        self._loss = loss
        metrics = _to_list(metrics)
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric must be paddle.metric.Metric, got {type(m)}")
        self._metrics = metrics
        self._train_step = None

    # ------------------------------------------------------------ stepping
    def _build_train_step(self):
        from ..jit.api import TrainStep

        model = self.network
        loss_fn = self._loss

        def fn(*batch):
            *xs, y = batch
            return loss_fn(model(*xs), y)

        self._train_step = TrainStep(model=model, optimizer=self._optimizer,
                                     loss_fn=fn, device=self.device)

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        """One optimizer step; returns ``[loss]`` (reference train_batch).

        ``sync=True`` (the reference contract) reads the loss to a python
        float, one blocking device-to-host read. ``sync=False`` returns the
        loss as a tensor on the device, so a loop (``fit``) can defer the
        read to a ``MetricBuffer`` boundary."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before training")
        self.network.train()
        if self._train_step is None:
            self._build_train_step()
        batch = _to_device(_to_list(inputs) + _to_list(labels), self.device)
        loss = self._train_step(*batch)
        if sync:
            return [to_float(loss)]
        return [loss]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """The loss (a float) and each metric's ``update`` on one batch."""
        self.network.eval()
        inputs = _to_device(_to_list(inputs), self.device)
        labels = _to_device(_to_list(labels), self.device)
        outputs = self.network(*inputs)
        losses = []
        if self._loss is not None and labels:
            losses = [to_float(self._loss(outputs, *labels))]
        metric_outs = []
        for m in self._metrics:
            computed = m.compute(outputs, *labels)
            metric_outs.append(m.update(*_to_list(computed)))
        return losses, metric_outs

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs on one batch, as numpy arrays (bf16
        outputs as f32)."""
        self.network.eval()
        out = self.network(*_to_device(_to_list(inputs), self.device))
        return [_to_numpy(o) if isinstance(o, torch.Tensor) else o
                for o in _to_list(out)]

    # ------------------------------------------------------------ loops
    def _make_loader(self, data, batch_size, shuffle, num_workers=0,
                     device_prefetch=None):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers,
                              device_prefetch=device_prefetch,
                              device=self.device)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            device_prefetch=None, sync_every=None, snapshot_dir=None,
            snapshot_every=None, snapshot_keep=None, resume=None):
        """Train over ``train_data`` (a ``Dataset``, a ``DataLoader`` or any
        iterable of batches; a batch's last field is the label).

        The loop does not block between boundaries: the step losses stay
        on the device in a :class:`MetricBuffer` and materialize every
        ``sync_every`` steps (default ``log_freq``, or
        ``FLAGS_metric_sync_every``) and at each epoch's end;
        ``device_prefetch=N`` keeps N batches staged on the card
        (``FLAGS_device_prefetch``). Callbacks get float ``logs``: between
        boundaries the last materialized loss; only ``sync_every=0`` hands
        them the device value.

        Preemption safety: ``snapshot_dir`` arms atomic rolling snapshots
        (parameters, optimizer, the step's generators, the epoch and batch
        cursor) every ``snapshot_every`` steps
        (``FLAGS_train_snapshot_every``) and at SIGTERM (which stops the
        loop cleanly at that step's boundary). ``resume=True`` (or a
        directory) restores the newest snapshot and continues at the exact
        next batch; the shuffle is pinned to the epoch whenever snapshots
        or a resume are armed, so the resumed loss stream is bit for bit
        the uninterrupted one's. With ``snapshot_dir`` set and ``resume``
        left unset, a relaunched worker (``PADDLE_RESTART_GEN > 0``)
        resumes on its own; ``resume=False`` forces a fresh start."""
        from ..observability.anomaly import monitor

        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers, device_prefetch)
        if device_prefetch and loader is not None and loader is train_data:
            # a caller's loader or iterable is wrapped, never changed,
            # unless it already prefetches
            already = (isinstance(loader, DeviceLoader)
                       or bool(getattr(loader, "device_prefetch", 0)))
            if not already:
                loader = DeviceLoader(loader, depth=int(device_prefetch),
                                      device=self.device)
        if sync_every is None:
            sync_every = int(get_flag("metric_sync_every")) or log_freq
        snapshotter, cursor = self._arm_snapshots(snapshot_dir, snapshot_keep,
                                                  resume)
        if snapshot_every is None:
            snapshot_every = int(get_flag("train_snapshot_every"))
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, self, epochs=epochs, steps=steps,
                                verbose=verbose, save_freq=save_freq,
                                save_dir=save_dir, metrics=self._metrics)
        self.stop_training = False
        self._preempted = False
        cbks.on_train_begin()
        logs = {}
        buf = MetricBuffer(sync_every=sync_every)
        restore_sig = self._install_sigterm(snapshotter)
        try:
            logs = self._fit_loop(loader, epochs, eval_data, eval_freq,
                                  batch_size, num_workers, cbks, buf,
                                  cursor=cursor, snapshotter=snapshotter,
                                  snapshot_every=int(snapshot_every))
        except BaseException as e:
            if monitor.enabled:
                # the forensic window, before the stack unwinds
                monitor.on_exception("train.fit", e)
            raise
        finally:
            restore_sig()
        cbks.on_train_end(logs)

    # -------------------------------------------------- preemption safety
    def _generators(self) -> list:
        from ..jit.api import model_generators

        return model_generators(self.network)

    def _arm_snapshots(self, snapshot_dir, snapshot_keep, resume):
        """The snapshotter and the resume cursor. ``resume`` may be True
        (use ``snapshot_dir``) or a directory; a resume target with no
        complete snapshot starts fresh with a log line."""
        if resume is None and snapshot_dir:
            try:
                gen = int(os.environ.get("PADDLE_RESTART_GEN", "0") or 0)
            except ValueError:
                gen = 0
            if gen > 0:
                _log.info("fit: relaunch detected (PADDLE_RESTART_GEN=%d): "
                          "resuming from the snapshot under %s", gen,
                          snapshot_dir)
                resume = True
        if resume and not isinstance(resume, (str, bytes)) and not snapshot_dir:
            raise ValueError("fit(resume=True) needs snapshot_dir=")
        resume_dir = resume if isinstance(resume, (str, bytes)) else None
        target = snapshot_dir or resume_dir
        if target is None:
            return None, None
        from ..reliability.snapshot import TrainSnapshotter

        snapshotter = TrainSnapshotter(str(resume_dir or target),
                                       keep=snapshot_keep)
        cursor = None
        if resume:
            if snapshotter.latest() is None:
                _log.info("fit(resume=...): no complete snapshot under %s: "
                          "starting fresh", snapshotter.dir)
            else:
                cursor = snapshotter.restore(
                    self.network, self._optimizer,
                    generators=self._generators(), device=self.device)
                _log.info("fit(resume=...): restored step %d (epoch %d, "
                          "next batch %d) from %s", cursor["step"],
                          cursor["epoch"], cursor["next_batch"],
                          snapshotter.dir)
        if snapshot_dir and resume_dir and str(snapshot_dir) != str(resume_dir):
            # resume from one directory, keep snapshotting into another
            snapshotter = TrainSnapshotter(str(snapshot_dir),
                                           keep=snapshot_keep)
        return snapshotter, cursor

    def _install_sigterm(self, snapshotter):
        """SIGTERM: snapshot at the next step boundary and stop. Only on
        the main thread (the interpreter's signal contract); returns the
        zero-argument restore."""
        if snapshotter is None:
            return lambda: None
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def _on_sigterm(signum, frame):
            # a flag only: the snapshot (a card sync and disk writes) runs
            # at the step boundary, never inside the signal frame
            self._preempted = True

        try:
            prev = signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _fit_loop(self, loader, epochs, eval_data, eval_freq, batch_size,
                  num_workers, cbks, buf, cursor=None, snapshotter=None,
                  snapshot_every=0):
        from ..observability.anomaly import monitor
        from ..observability.memory import sampler as mem_sampler
        from ..profiler.pipeline import pipeline_stats, timed

        logs = {}
        start_epoch = int(cursor["epoch"]) if cursor else 0
        resume_batch = int(cursor["next_batch"]) if cursor else 0
        global_step = int(cursor["step"]) if cursor else 0
        # the shuffle is pinned to the epoch only when snapshots or a
        # resume are armed: the original and the resumed process must draw
        # the same order. A plain fit keeps a fresh shuffle each run
        pin_epochs = snapshotter is not None or cursor is not None
        generators = self._generators() if snapshotter is not None else []
        for epoch in range(start_epoch, epochs):
            if pin_epochs and hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            cbks.on_epoch_begin(epoch)
            skip = resume_batch if epoch == start_epoch else 0
            it = self._epoch_iter(loader, skip)
            try:
                for step, batch in enumerate(it, start=skip):
                    xs, ys = self._split_batch(batch)
                    cbks.on_train_batch_begin(step)
                    with timed(pipeline_stats.add_dispatch):
                        losses = self.train_batch(xs, ys, sync=False)
                    buf.append("loss", losses[0])
                    pipeline_stats.step()
                    global_step += 1
                    # sync-free: the allocator's host counters only
                    mem_sampler.maybe_sample("step")
                    if buf.should_sync(step):
                        # one stacked read covering every step since the
                        # previous boundary
                        logs = dict(buf.materialize())
                        if monitor.enabled:
                            monitor.on_flush()
                    else:
                        # float logs without a sync: the last boundary's
                        # value (step 0 is a boundary when sync_every >= 1)
                        val = buf.last_float("loss")
                        logs = {"loss": val if val is not None
                                else buf.latest("loss")}
                    cbks.on_train_batch_end(step, logs)
                    # one preemption point a step, after the callbacks: a
                    # SIGTERM anywhere in this step is handled here, with
                    # a snapshot at this exact boundary
                    if snapshotter is not None and (
                            self._preempted
                            or (snapshot_every > 0
                                and global_step % snapshot_every == 0)):
                        snapshotter.save(self.network, self._optimizer,
                                         step=global_step, epoch=epoch,
                                         next_batch=step + 1,
                                         generators=generators)
                    if self._preempted:
                        _log.warning(
                            "fit: SIGTERM received, snapshot landed at step "
                            "%d; stopping (resume with fit(resume=...))",
                            global_step)
                        self.stop_training = True
                        # a break mid-epoch is for preemption only: a
                        # callback's stop_training finishes the epoch
                        break
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            report = buf.flush()
            if monitor.enabled:
                monitor.on_flush()
            if "loss" in report:
                logs = {"loss": report["loss"]["last"]}
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and not self._preempted and (
                    epoch % eval_freq == 0 or epoch == epochs - 1):
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0, num_workers=num_workers)
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        return logs

    @staticmethod
    def _epoch_iter(loader, skip):
        """One epoch's iterator, ``skip`` batches on: a loader with a
        cursor (``DataLoader.iter_from``: index level, nothing refetched)
        skips by itself, anything else is consumed."""
        if not skip:
            return iter(loader)
        if hasattr(loader, "iter_from"):
            return loader.iter_from(skip)
        it = iter(loader)
        for _ in range(int(skip)):
            next(it)
        return it

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        """The mean loss over ``eval_data`` and each metric's
        ``accumulate()``."""
        loader = self._make_loader(eval_data, batch_size, False)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            xs, ys = self._split_batch(batch)
            batch_losses, _ = self.eval_batch(xs, ys)
            losses.extend(batch_losses)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            logs.update(dict(zip(names, vals)))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The outputs over ``test_data``, ``[outputs][batches]`` numpy
        arrays (concatenated over batches with ``stack_outputs``). A batch
        that carries a label has it dropped, as ``fit`` splits it."""
        loader = self._make_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            xs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(xs))
        # [steps][n_outs] -> [n_outs][steps]
        outs = list(map(list, zip(*outputs))) if outputs else []
        if stack_outputs:
            outs = [np.concatenate(o) for o in outs]
        return outs

    @staticmethod
    def _split_batch(batch, has_label=True):
        if isinstance(batch, (tuple, list)):
            if has_label and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    # ------------------------------------------------------------ persistence
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with
        ``training``, ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save as fw_save

        fw_save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fw_save(self._optimizer.state_dict(), path + ".pdopt")

    def save_sharded(self, directory, overwrite=False):
        """A servable sharded checkpoint of the network: one piece a
        tensor, in the reference's layout (each ``Linear`` weight ``[in,
        out]``), under the atomic tmp+rename publish, which
        ``Predictor.swap_weights(directory)`` and the decode engine's swap
        read. Returns the save report."""
        from ..distributed.checkpoint.sharded import save_sharded
        from ..models.gpt import jax_state_dict

        return save_sharded(jax_state_dict(self.network), directory,
                            overwrite=overwrite)

    @torch.no_grad()
    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Load what :meth:`save` wrote into the live network (in place)
        and, unless ``reset_optimizer``, the optimizer."""
        from ..framework.io import load as fw_load

        params = fw_load(path if path.endswith(".pdparams")
                         else path + ".pdparams")
        self.network.load_state_dict(params, strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and os.path.exists(opt_path):
            self._optimizer.set_state_dict(fw_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        """Parameter-count summary (reference hapi/model_summary.py):
        prints a table and returns the totals."""
        rows, total = [], 0
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape)) if p.shape else 1
            total += n
            rows.append((name, tuple(p.shape), n))
        width = max((len(r[0]) for r in rows), default=10) + 2
        lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':>12}"]
        lines += [f"{n:<{width}}{str(s):<20}{c:>12,}" for n, s, c in rows]
        lines.append(f"Total params: {total:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": total}
