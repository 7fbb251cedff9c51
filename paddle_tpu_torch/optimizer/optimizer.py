"""Optimizer base (counterpart: ``paddle_tpu/optimizer/optimizer.py``).

Parameter groups, learning rate or :class:`~.lr.LRScheduler`, weight
decay as a coefficient, f32 master weights under ``multi_precision``.
:meth:`Optimizer.step` updates every parameter that has a gradient IN
PLACE, the step count starting at 1; a subclass either gives the pure
per-leaf rule ``_update`` (run leaf by leaf, as the JAX package's XLA
path does) or overrides ``_apply`` with a multi-tensor kernel
(:class:`~.optimizers.Adam`).

Not ported yet, and refused rather than ignored: ``grad_clip``, L1 decay,
and per-group options (the JAX package reads only ``"params"`` of a
group and silently drops the rest).
"""
from __future__ import annotations

import torch

from ..ops.adamw_kernel import apply_in_place
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _decay_coeff(weight_decay):
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    if type(weight_decay).__name__ == "L1Decay":
        raise NotImplementedError(
            "L1Decay is not ported to paddle_tpu_torch yet")
    return float(getattr(weight_decay, "coeff",
                         getattr(weight_decay, "_coeff", 0.0)))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required (eager mode)")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported to paddle_tpu_torch yet")
        self._lr = learning_rate
        self._weight_decay = _decay_coeff(weight_decay)
        self._multi_precision = multi_precision
        self._step_count = 0
        self._accum: dict[int, dict] = {}   # id(param) -> state dict
        self._param_groups = self._build_groups(parameters)

    # -- param groups -------------------------------------------------------
    @staticmethod
    def _build_groups(parameters):
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            groups = []
            for g in parameters:
                extra = sorted(set(g) - {"params"})
                if extra:
                    raise NotImplementedError(
                        f"per-group options {extra} are not ported to "
                        "paddle_tpu_torch yet")
                groups.append({"params": list(g["params"])})
            return groups
        return [{"params": parameters}]

    def _all_params(self):
        for g in self._param_groups:
            yield from g["params"]

    # -- lr -----------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("set_lr cannot override an LRScheduler")
        self._lr = float(value)

    def set_lr_scheduler(self, scheduler):
        self._lr = scheduler

    # -- state --------------------------------------------------------------
    def _get_state(self, p):
        st = self._accum.get(id(p))
        if st is None:
            st = self._init_state(p)
            if self._multi_precision and p.dtype != torch.float32:
                st["master"] = p.detach().float()
            self._accum[id(p)] = st
        return st

    def _init_state(self, p) -> dict:
        return {}

    # -- the per-leaf rule (pure; subclasses override) ----------------------
    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        raise NotImplementedError

    def _hyperparams(self) -> dict:
        return {"weight_decay": self._weight_decay}

    def _apply(self, params, grads, states, lr, step):
        hp = self._hyperparams()
        for p, g, s in zip(params, grads, states):
            apply_in_place(p, g, s, lambda c, gc, st: self._update(
                c, gc, st, lr, step, hp))

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        params = [p for p in self._all_params()
                  if p.requires_grad and p.grad is not None]
        if not params:
            return
        self._step_count += 1
        states = [self._get_state(p) for p in params]
        self._apply(params, [p.grad for p in params], states,
                    self.get_lr(), self._step_count)

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._all_params():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad
