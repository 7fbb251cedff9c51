"""Adam and AdamW (counterpart: ``paddle_tpu/optimizer/optimizers.py``;
its other optimizers come in a later slice).

On CUDA parameters a step is ONE launch of the multi-tensor kernel K4
over every leaf (:mod:`..ops.adamw_kernel`), the global-norm clip factor
and the L1 term folded in; on CPU parameters it is the same rule leaf by
leaf. ``amsgrad=True`` takes the plain rule on either
device, as the JAX package takes its XLA rule, and is counted under
``adamw_kernel.stats["amsgrad_plain_calls"]``.

There is no ``use_multi_tensor`` argument: the card's step is always
the multi-tensor kernel, and the JAX package never reads it.

``AdamW(apply_decay_param_fun=..., lr_ratio=...)`` raise
``NotImplementedError``: the JAX package stores both and never reads
them (decay applies to every leaf there), and the port does not copy
that silent ignore.
"""
from __future__ import annotations

import torch

from ..ops import adamw_kernel
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 *, amsgrad=False, name=None):
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode is not ported to paddle_tpu_torch yet")
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        s = {"moment1": torch.zeros(p.shape, **kw),
             "moment2": torch.zeros(p.shape, **kw)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(p.shape, **kw)
        return s

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon,
                "amsgrad": self._amsgrad, "decoupled": False}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        return adamw_kernel.adam_rule(
            param, grad, state, lr, step, b1=hp["b1"], b2=hp["b2"],
            eps=hp["eps"], wd=hp["weight_decay"], decoupled=hp["decoupled"],
            amsgrad=hp["amsgrad"])

    def _apply(self, params, grads, states, lr, step, clip=None,
               clip_mask=None):
        if self._amsgrad:
            adamw_kernel.stats["amsgrad_plain_calls"] += 1
            return super()._apply(params, grads, states, lr, step, clip,
                                  clip_mask)
        hp = self._hyperparams()
        adamw_kernel.adamw_update(
            params, grads, states, lr=lr, step=step, b1=hp["b1"],
            b2=hp["b2"], eps=hp["eps"], wd=hp["weight_decay"],
            decoupled=hp["decoupled"], l1=self._l1, clip=clip,
            clip_mask=clip_mask)


class AdamW(Adam):
    """Decoupled weight decay (default coefficient 0.01) on every leaf."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        for arg, val in (("lr_ratio", lr_ratio),
                         ("apply_decay_param_fun", apply_decay_param_fun)):
            if val is not None:
                raise NotImplementedError(
                    f"AdamW({arg}=...) is not ported to paddle_tpu_torch "
                    "(the JAX package stores it and never applies it)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)

    def _hyperparams(self):
        hp = super()._hyperparams()
        hp["decoupled"] = True
        return hp
