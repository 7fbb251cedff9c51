"""``Model`` — the high-level training API (counterpart:
``paddle_tpu/hapi/model.py``): ``prepare``, ``train_batch`` and
``train_batch_loop``.

A step is eager PyTorch: forward, the loss, ``backward()``, the
optimizer's step (one K4 launch on the card) and ``clear_grad()``. The
JAX package compiles N steps into one scanned program; here
:meth:`Model.train_batch_loop` runs N eager steps with no host sync
between them — each step's loss stays on the device — and fetches the
``[N]`` losses once at the end.

Not ported yet, and refused: ``metrics``, ``amp_configs`` (the bench
step casts the model to bf16 and trains with ``multi_precision``
instead), the fleet stepper, fit/evaluate/predict and persistence.
"""
from __future__ import annotations

import torch

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        if inputs is not None or labels is not None:
            # the JAX package reads them only to split fit()'s batches
            raise NotImplementedError(
                "Model(inputs=, labels=) belong to fit(), which is not "
                "ported to paddle_tpu_torch yet")
        self.network = network
        self._optimizer = None
        self._loss = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        for arg, val in (("metrics", metrics), ("amp_configs", amp_configs)):
            if val:
                raise NotImplementedError(
                    f"Model.prepare({arg}=...) is not ported to "
                    "paddle_tpu_torch yet")
        self._optimizer = optimizer
        self._loss = loss
        return self

    @property
    def device(self):
        return next(self.network.parameters()).device

    def _tensors(self, xs):
        return [torch.as_tensor(x).to(self.device) for x in _to_list(xs)]

    def _step(self, inputs, labels, update=True):
        """One eager step; returns the detached loss on the device."""
        outs = _to_list(self.network(*inputs))
        losses = _to_list(self._loss(*(outs + labels)))
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return total.detach()

    def train_batch(self, inputs, labels=None, update=True):
        """One step on one batch; returns the loss as a float (a host
        fetch)."""
        self.network.train()
        return float(self._step(self._tensors(inputs),
                                self._tensors(labels), update))

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
                                   [y[i] for y in labels])
        return losses.cpu()
