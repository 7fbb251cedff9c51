"""``hapi`` callbacks (counterpart: ``paddle_tpu/hapi/callbacks.py``):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler`` (steps the optimizer's schedule; the
JAX package's ``fit`` adds it only when it is passed),
``ReduceLROnPlateau`` and ``VisualDL`` (scalars as JSON lines, as the
JAX package writes them).

The logs a callback receives hold host floats: ``fit`` fetches each
step's loss once, as the JAX package does, and nothing else.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "ReduceLROnPlateau", "VisualDL"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        out = []
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple, np.ndarray)):
                v = ", ".join(f"{float(x):.4f}" for x in np.ravel(v))
                out.append(f"{k}: [{v}]")
            elif isinstance(v, float):
                out.append(f"{k}: {v:.4f}")
            else:
                out.append(f"{k}: {v}")
        return " - ".join(out)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            ips = (step + 1) / max(time.time() - self._start, 1e-9)
            print(f"step {step + 1}/{self.steps or '?'} - "
                  f"{self._fmt(logs)} - {ips:.2f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"Epoch {epoch + 1} done - {self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.ravel(cur)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as _S
        lr = getattr(getattr(self.model, "_optimizer", None), "_lr", None)
        return lr if isinstance(lr, _S) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class ReduceLROnPlateau(Callback):
    """Multiply the optimizer's rate by ``factor`` when the monitored log
    has not improved for ``patience`` epochs (a schedule keeps its own)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 verbose=1, mode="auto", min_delta=1e-4, cooldown=0,
                 min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def _better(self, cur):
        if self._best is None:
            return True
        if self.mode == "min":
            return cur < self._best - self.min_delta
        return cur > self._best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self._better(cur):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = self.model._optimizer
            old = opt.get_lr()
            new = max(old * self.factor, self.min_lr)
            if new < old:
                try:
                    opt.set_lr(new)
                except RuntimeError:
                    return  # a schedule owns the rate
                if self.verbose:
                    print(f"Epoch {epoch}: ReduceLROnPlateau reducing "
                          f"lr to {new}")
            self._cooldown_left = self.cooldown
            self._wait = 0


class VisualDL(Callback):
    """The reference's VisualDL callback API without the visualdl
    package: one JSON record a line in ``log_dir/scalars.jsonl``,
    ``{"kind": "epoch", "step": epoch, <each float log>}`` at the end of
    every epoch, appended and flushed as it is written."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def _emit(self, kind, step, logs):
        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        rec = {"kind": kind, "step": int(step)}
        for k, v in (logs or {}).items():
            try:
                rec[k] = float(v[0] if isinstance(v, (list, tuple)) else v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def on_epoch_end(self, epoch, logs=None):
        self._emit("epoch", epoch, logs)

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None
