"""Gradient clipping (counterpart: ``paddle_tpu/nn/clip_grad.py``).

A clip object takes ``[(param, grad), ...]`` and returns the pairs with
the grads clipped, each rounded back to its grad's dtype as the JAX
package does (``(g * scale).astype(g.dtype)``); a param whose
``need_clip`` is False keeps its grad. Norms are float32 sums of squares
on the grads' device, with no host read.

Inside :meth:`Optimizer.step <..optimizer.Optimizer.step>` an Adam or
AdamW does not call :class:`ClipGradByGlobalNorm`: it passes the factor
of :meth:`ClipGradByGlobalNorm.factor` to K4, which scales and rounds
each grad element as it reads it and rewrites no grad.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "global_norm"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def global_norm(grads):
    """sqrt of the float32 sum of squares of every element of ``grads``:
    one multi-tensor pass (``torch._foreach_norm``), a 0-d float32 tensor
    on the grads' device."""
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = torch._foreach_norm(list(grads), 2, dtype=torch.float32)
    return torch.stack(norms).square().sum().sqrt()


def _factor(norm, clip_norm):
    """``min(clip_norm / max(norm, 1e-12), 1)`` in float32."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                g = _scaled(g, _factor(global_norm([g]), self.clip_norm))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def factor(self, params_grads):
        """The clip factor of these grads, a 0-d float32 tensor on their
        device: ``min(clip_norm / max(||g||, 1e-12), 1)`` over the grads
        that are clipped."""
        return _factor(global_norm([g for p, g in params_grads
                                    if _clipped(p, g)]), self.clip_norm)

    @torch.no_grad()
    def __call__(self, params_grads):
        params_grads = list(params_grads)
        scale = self.factor(params_grads)
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place so that their total norm is at
    most ``max_norm``; returns the total norm before clipping (float32).
    ``error_if_nonfinite`` reads the norm on the host."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == math.inf:
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not math.isfinite(float(total)):
        raise RuntimeError(
            f"the total norm of gradients is non-finite ({float(total)}); "
            "set error_if_nonfinite=False to skip this check")
    scale = _factor(total, float(max_norm))
    for p in parameters:
        if p.grad is not None:
            p.grad = _scaled(p.grad, scale)
    return total
