"""Training callbacks (port of ``paddle_tpu/hapi/callbacks.py``; reference:
python/paddle/hapi/callbacks.py — Callback base, ProgBarLogger,
ModelCheckpoint, EarlyStopping, LRScheduler, config_callbacks)."""
from __future__ import annotations

import os
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def dispatch(*args, **kwargs):
            for c in self.callbacks:
                getattr(c, name)(*args, **kwargs)

        return dispatch


def _scalar(v) -> float:
    """Format-time materialization: host scalars (python or numpy) pass
    through; a tensor takes one counted host sync. The fit loop hands
    callbacks floats at its sync boundaries, so steady-state logging never
    pays this."""
    if isinstance(v, (float, int, np.floating, np.integer)):
        return float(v)
    from .metric_buffer import to_float

    return to_float(v)


class ProgBarLogger(Callback):
    """Per-epoch throughput/metric logging (reference ProgBarLogger; prints a
    summary line per log_freq steps instead of a terminal progress bar)."""

    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            msgs = [f"{k}: {_scalar(v):.4f}" for k, v in logs.items()]
            ips = (step + 1) / max(time.time() - self._start, 1e-9)
            print(f"Epoch {self.epoch}: step {step}/{self.steps} "
                  f"[{ips:.1f} step/s] " + " ".join(msgs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            logs = logs or {}
            msgs = [f"{k}: {_scalar(v):.4f}" for k, v in logs.items()]
            print(f"Epoch {epoch} done in {time.time() - self._start:.1f}s " + " ".join(msgs))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and ("acc" in monitor or monitor.startswith("fmeasure"))):
            self.monitor_op = np.greater
            self.min_delta *= 1
        else:
            self.monitor_op = np.less
            self.min_delta *= -1
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline if self.baseline is not None else (
            np.inf if self.monitor_op == np.less else -np.inf)

    def on_eval_end(self, logs=None):
        logs = logs or {}
        value = logs.get(self.monitor)
        if value is None:
            return
        value = np.asarray(value).reshape(-1)[0]
        if self.monitor_op(value - self.min_delta, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: best {self.monitor}={self.best:.5f}")


class LRScheduler(Callback):
    """Step the optimizer's LR schedule (reference LRScheduler callback)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks, model, epochs=None, steps=None, verbose=2,
                     save_freq=1, save_dir=None, metrics=None):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    params = {"epochs": epochs, "steps": steps, "verbose": verbose, "metrics": metrics or []}
    return CallbackList(cbks, model=model, params=params)
