"""Optimizer base (counterpart: ``paddle_tpu/optimizer/optimizer.py``).

Parameter groups, learning rate or :class:`~.lr.LRScheduler`, weight
decay as a coefficient or :class:`~..regularizer.L2Decay`,
:class:`~..regularizer.L1Decay` as a gradient term, ``grad_clip``, f32
master weights under ``multi_precision`` (the original float32 values
that :func:`..amp.decorate` kept, where it ran). :meth:`Optimizer.step`
updates every parameter that has a gradient IN PLACE, the step count
starting at 1. A subclass gives the pure per-leaf rule ``_update`` (the
JAX package's, run leaf by leaf on CPU parameters), and either a
multi-tensor pass ``_foreach_update`` in ``torch._foreach_*`` that CUDA
parameters take instead (the counterpart of the JAX package's one jitted
``_fused_apply``; ``stats`` counts the passes and the leaf-rule steps),
or its own ``_apply`` over a hand-written kernel
(:class:`~.optimizers.Adam`).

:class:`~..nn.clip_grad.ClipGradByGlobalNorm` reaches ``_apply`` as a
float32 factor on the device (K4 folds it into its one pass), and no
grad is rewritten; the other clips rewrite the grads before ``_apply``.
A step reads nothing on the host.

A parameter's gradient is ``p.main_grad`` where
``decorate(master_grad=True)`` keeps a float32 one, else ``p.grad``.

Refused rather than ignored: per-group options (the JAX package stores
them and reads only ``"params"`` of a group).
"""
from __future__ import annotations

import torch

from ..nn.clip_grad import ClipGradBase, ClipGradByGlobalNorm
from ..ops.adamw_kernel import apply_in_place
from ..regularizer import L1Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "grad_of", "stats", "reset_stats"]

stats = {"foreach_passes": 0, "leaf_rule_steps": 0}
# elements of one group of a multi-tensor pass (1 GiB of float32): a
# rule's temporaries stay a few GiB whatever the model's size
FOREACH_GROUP = 1 << 28


def reset_stats():
    for key in stats:
        stats[key] = 0


def grad_of(p):
    """The gradient the optimizer steps ``p`` with: the float32
    ``main_grad`` that ``decorate(master_grad=True)`` accumulates, else
    ``p.grad``."""
    g = getattr(p, "main_grad", None)
    return g if g is not None else p.grad


def _decay_coeff(weight_decay):
    if weight_decay is None or isinstance(weight_decay, L1Decay):
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "coeff",
                         getattr(weight_decay, "_coeff", 0.0)))


def _l1_coeff(weight_decay):
    return weight_decay.coeff if isinstance(weight_decay, L1Decay) else 0.0


def _groups(params):
    """Consecutive runs of leaf indices of about ``FOREACH_GROUP``
    elements."""
    limit, group, n = FOREACH_GROUP, [], 0
    for i, p in enumerate(params):
        if group and n + p.numel() > limit:
            yield group
            group, n = [], 0
        group.append(i)
        n += p.numel()
    if group:
        yield group


def foreach_grads(grads, ws, clip=None, clip_mask=None, l1=0.0):
    """:func:`~..ops.adamw_kernel.prepare_grad` for every leaf: the
    clipped leaves' grads times ``clip`` in float32 and rounded back to
    their dtype, each cast to its ``ws`` (the tensor the rule runs on),
    ``l1 * sign(w)`` added. The grads themselves are not written."""
    gs = list(grads)
    if clip is not None:
        idx = [i for i, c in enumerate(clip_mask or [True] * len(gs)) if c]
        scaled = torch._foreach_mul([gs[i].float() for i in idx], clip)
        for i, g in zip(idx, scaled):
            gs[i] = g.to(gs[i].dtype)
    gs = [g.to(w.dtype) for g, w in zip(gs, ws)]
    if l1:
        gs = torch._foreach_add(gs, torch._foreach_mul(
            torch._foreach_sign(ws), l1))
    return gs


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required (eager mode)")
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradBase):
            raise NotImplementedError(
                f"grad_clip of type {type(grad_clip).__name__}: the port "
                "takes ClipGradByValue, ClipGradByNorm and "
                "ClipGradByGlobalNorm (paddle_tpu_torch.nn)")
        self._lr = learning_rate
        self._grad_clip = grad_clip
        self._weight_decay = _decay_coeff(weight_decay)
        self._l1 = _l1_coeff(weight_decay)
        self._multi_precision = multi_precision
        self._use_master_weights = multi_precision
        self._step_count = 0
        self._clip_factor = None   # the last step's, on the device
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
                        "paddle_tpu_torch (the JAX package stores them and "
                        "never reads them)")
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
            if self._use_master_weights and p.dtype != torch.float32:
                master = getattr(p, "_master_weight", None)
                st["master"] = (master if master is not None
                                else p.detach().float())
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

    _foreach_update = None   # (ws, gs, states, lr, step, hp), in place

    def _apply(self, params, grads, states, lr, step, clip=None,
               clip_mask=None):
        """CUDA params through the subclass's multi-tensor pass where it
        has one, else the rule leaf by leaf; ``clip`` (the folded
        global-norm factor) applies to the leaves whose ``clip_mask``
        entry is true."""
        if params[0].device.type != "cpu" and self._foreach_update:
            return self._apply_foreach(params, grads, states, lr, step,
                                       clip, clip_mask)
        return self._apply_leaves(params, grads, states, lr, step, clip,
                                  clip_mask)

    def _apply_leaves(self, params, grads, states, lr, step, clip=None,
                      clip_mask=None):
        """The rule ``_update`` leaf by leaf, in place."""
        stats["leaf_rule_steps"] += 1
        hp = self._hyperparams()
        mask = clip_mask or [True] * len(params)
        for p, g, s, c in zip(params, grads, states, mask):
            apply_in_place(p, g, s, lambda w, gw, st: self._update(
                w, gw, st, lr, step, hp), clip if c else None, self._l1)

    def _apply_foreach(self, params, grads, states, lr, step, clip=None,
                       clip_mask=None):
        """``_foreach_update`` over the leaves, in place, in consecutive
        groups of about ``FOREACH_GROUP`` elements (every rule is leaf by
        leaf, so grouping changes nothing but the temporaries' size),
        with the leaf rule's grads (:func:`foreach_grads`) and masters:
        the rule runs on the float32 master where there is one, and the
        param becomes its cast. Nothing is read on the host."""
        stats["foreach_passes"] += 1
        hp = self._hyperparams()
        mask = clip_mask or [True] * len(params)
        for idx in _groups(params):
            ps, st = [params[i] for i in idx], [states[i] for i in idx]
            ws = [s.get("master", p) for p, s in zip(ps, st)]
            gs = foreach_grads([grads[i] for i in idx], ws, clip,
                               [mask[i] for i in idx], self._l1)
            self._foreach_update(ws, gs, st, lr, step, hp)
            pairs = [(p, s["master"]) for p, s in zip(ps, st)
                     if "master" in s]
            if pairs:
                torch._foreach_copy_([p for p, _ in pairs],
                                     [m for _, m in pairs])

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        pairs = [(p, g) for p in self._all_params()
                 if p.requires_grad and (g := grad_of(p)) is not None]
        clip = clip_mask = None
        if self._grad_clip is not None and pairs:
            if isinstance(self._grad_clip, ClipGradByGlobalNorm):
                clip = self._grad_clip.factor(pairs)
                clip_mask = [getattr(p, "need_clip", True) for p, _ in pairs]
            else:
                pairs = self._grad_clip(pairs)
        self._clip_factor = clip
        if not pairs:
            return
        self._step_count += 1
        params = [p for p, _ in pairs]
        states = [self._get_state(p) for p in params]
        self._apply(params, [g for _, g in pairs], states, self.get_lr(),
                    self._step_count, clip, clip_mask)

    @torch.no_grad()
    def clear_grad(self, set_to_zero=False):
        for p in self._all_params():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None
            if getattr(p, "main_grad", None) is not None:
                if set_to_zero:
                    p.main_grad.zero_()
                else:
                    p.main_grad = None

    clear_gradients = clear_grad

    # -- serialization -------------------------------------------------------
    def state_dict(self):
        """``_step_count``, the schedule's state under ``LR_Scheduler``,
        and ``"<param key>.<state name>"`` for every state tensor (the
        key is the param's position among all the optimizer's params)."""
        out = {"_step_count": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for idx, p in enumerate(self._all_params()):
            st = self._accum.get(id(p))
            if st is None:
                continue
            key = f"param_{idx}"
            for sname, arr in st.items():
                out[f"{key}.{sname}"] = arr
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load :meth:`state_dict`'s output: each state tensor is copied
        into the optimizer's own (a master that ``decorate`` kept stays
        the param's ``_master_weight``)."""
        self._step_count = state.get("_step_count", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state:
            self._lr.set_state_dict(state["LR_Scheduler"])
        for idx, p in enumerate(self._all_params()):
            key = f"param_{idx}"
            st = self._get_state(p)
            for sname in list(st):
                val = state.get(f"{key}.{sname}")
                if val is not None:
                    st[sname].copy_(torch.as_tensor(val))

    set_dict = set_state_dict
