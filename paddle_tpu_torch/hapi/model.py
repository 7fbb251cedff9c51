"""``Model`` — the high-level training API (counterpart:
``paddle_tpu/hapi/model.py``): ``prepare``, ``train_batch``,
``train_batch_loop``, ``eval_batch``, ``predict_batch``, ``fit``,
``evaluate``, ``predict``, ``save`` and ``load``.

A step is eager PyTorch: forward and the loss (under
:func:`..amp.auto_cast` when ``prepare(amp_configs=)`` set a level, at
its ``"dtype"``, bf16 by default; evaluation and prediction run without
it, as the JAX package's),
``backward()``, the optimizer's step (one K4 launch on the card, the
global-norm clip factor and L1 folded in) and ``clear_grad()``. The JAX
package compiles each step into one program; here nothing in a step
reads the device from the host except the loss, fetched once a step by
``train_batch`` as the JAX package's ``_loss_value`` does, and the
metrics, which accumulate on the host as the JAX package's do.
:meth:`Model.train_batch_loop` runs N steps and fetches the ``[N]``
losses once at the end.

``Model(network, inputs, labels)``: only the number of ``inputs`` is read,
to split a loader's batch into inputs and labels, as the JAX package
does. ``fit``'s ``accumulate_grad_batches`` and ``drop_last``, which the
JAX package accepts and never reads, raise unless left at 1 and False.
The fleet stepper is not ported.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..amp import auto_cast
from ..framework.io_save import load as _load
from ..framework.io_save import save as _save
from ..io import DataLoader
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = None
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got "
                                f"{type(m)}")
        self._amp_level = None
        if amp_configs:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
                if amp_configs.get("dtype", "bfloat16") not in (
                        "bfloat16", torch.bfloat16):
                    raise NotImplementedError(
                        "prepare(amp_configs={'dtype': ...}) other than "
                        "bfloat16: the JAX package reads only 'level' and "
                        "casts to bfloat16")
        return self

    @property
    def device(self):
        return next(self.network.parameters()).device

    def _tensors(self, xs):
        return [torch.as_tensor(x).to(self.device) for x in _to_list(xs)]

    def _amp(self):
        if self._amp_level is None:
            return contextlib.nullcontext()
        return auto_cast(level=self._amp_level)

    def _forward_loss(self, inputs, labels):
        with self._amp():
            outs = _to_list(self.network(*inputs))
            losses = _to_list(self._loss(*(outs + labels)))
            total = losses[0]
            for extra in losses[1:]:
                total = total + extra
        return outs, total

    def _step(self, inputs, labels, update=True):
        """One eager step; returns the outputs and the detached loss on
        the device."""
        outs, total = self._forward_loss(inputs, labels)
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return outs, total.detach()

    def _update_metrics(self, outs, labels):
        res = []
        for m in self._metrics:
            state = _to_list(m.compute(*(list(outs) + labels)))
            res.append(m.update(*state))
        return res

    # -- single-batch ops -----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        """One step on one batch; returns the loss as a float (the step's
        one host fetch)."""
        self.network.train()
        labels = self._tensors(labels)
        outs, loss = self._step(self._tensors(inputs), labels, update)
        self._update_metrics(outs, labels)
        return float(loss)

    def train_batch_loop(self, inputs, labels=None):
        """N steps: ``inputs``/``labels`` carry a leading step axis ``[N,
        batch, ...]``. Returns the ``[N]`` float32 losses on the CPU,
        fetched once after the last step."""
        self.network.train()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        n = int(inputs[0].shape[0])
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        for i in range(n):
            losses[i] = self._step([x[i] for x in inputs],
                                   [y[i] for y in labels])[1]
        return losses.cpu()

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        outs = _to_list(self.network(*inputs))
        loss = self._loss(*(outs + labels)) if self._loss else None
        self._update_metrics(outs, labels)
        return float(_to_list(loss)[0]) if loss is not None else None

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The network's outputs as numpy arrays (bf16 widened to
        float32: numpy has no bf16)."""
        self.network.eval()
        outs = _to_list(self.network(*self._tensors(inputs)))
        return [_host(o) for o in outs]

    # -- loops ----------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          num_workers=num_workers)

    def _split_batch(self, batch):
        batch = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        n_in = len(self._inputs) if self._inputs else 1
        if len(batch) == 1:
            return batch, []
        return batch[:n_in], batch[n_in:]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train ``epochs`` passes over ``train_data`` (a dataset or a
        DataLoader), ``num_iters`` steps at most, evaluating on
        ``eval_data`` every ``eval_freq`` epochs, with the callbacks (a
        ``ProgBarLogger`` when ``verbose``, a ``ModelCheckpoint`` with
        ``save_dir``; a schedule steps only under the ``LRScheduler``
        callback, as in the JAX package)."""
        if accumulate_grad_batches != 1 or drop_last:
            raise NotImplementedError(
                "fit(accumulate_grad_batches=..., drop_last=True) is not "
                "ported to paddle_tpu_torch (the JAX package accepts both "
                "and never reads them)")
        loader = self._make_loader(train_data, batch_size, shuffle,
                                   num_workers)
        eval_loader = (self._make_loader(eval_data, batch_size, False,
                                         num_workers)
                       if eval_data is not None else None)
        cbks = _to_list(callbacks)
        if verbose:
            cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cb = CallbackList(cbks)
        cb.set_model(self)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cb.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                       "metrics": ["loss"] + [n for m in self._metrics
                                              for n in _to_list(m.name())]})
        self.stop_training = False
        cb.on_train_begin()
        it_count = 0
        logs = {}
        for epoch in range(epochs):
            cb.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(loader):
                cb.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                logs = {"loss": self.train_batch(inputs, labels)}
                for m in self._metrics:
                    logs.update(zip(_to_list(m.name()),
                                    _to_list(m.accumulate())))
                cb.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            cb.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                cb.on_eval_end(self.evaluate(eval_loader,
                                             batch_size=batch_size,
                                             verbose=0))
            if self.stop_training:
                break
        cb.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean of the batches' losses and each metric's accumulation
        over ``eval_data``."""
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        cb = CallbackList(_to_list(callbacks) +
                          ([ProgBarLogger(log_freq, verbose)] if verbose
                           else []))
        cb.set_model(self)
        cb.set_params({"verbose": verbose})
        cb.on_eval_begin()
        logs = {}
        total_loss, n = 0.0, 0
        for step, batch in enumerate(loader):
            inputs, labels = self._split_batch(batch)
            loss = self.eval_batch(inputs, labels)
            if loss is not None:
                total_loss += loss
                n += 1
            cb.on_eval_batch_end(step, {"loss": loss})
        if n:
            logs["loss"] = total_loss / n
        for m in self._metrics:
            logs.update(zip(_to_list(m.name()), _to_list(m.accumulate())))
        cb.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """Each batch's outputs (:meth:`predict_batch`), or with
        ``stack_outputs`` each output concatenated over the batches."""
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        outputs = [self.predict_batch(self._split_batch(batch)[0])
                   for batch in loader]
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    # -- persistence ----------------------------------------------------------
    def save(self, path, training=True):
        """``path + ".pdparams"``: the network's state dict;
        ``path + ".pdopt"`` (with ``training``): the optimizer's."""
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy the saved state into the network's tensors (and, unless
        ``reset_optimizer``, the optimizer's)."""
        self.network.load_state_dict(_load(path + ".pdparams"),
                                     strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """With ``input_size``: :func:`.summary.summary` of the network
        (one forward on zeros); without: a table of the parameters.
        Returns ``{"total_params", "trainable_params"}``."""
        if input_size is not None:
            from .summary import summary
            return summary(self.network, input_size, dtypes=dtype)
        total = trainable = 0
        lines = ["-" * 60, f"{'Param name':<40}{'Shape':<14}{'#':>6}",
                 "-" * 60]
        for n, p in self.network.named_parameters():
            total += p.numel()
            trainable += p.numel() if p.requires_grad else 0
            lines.append(f"{n:<40}{str(list(p.shape)):<14}{p.numel():>6}")
        lines += ["-" * 60, f"Total params: {total}",
                  f"Trainable params: {trainable}",
                  f"Non-trainable params: {total - trainable}", "-" * 60]
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}
