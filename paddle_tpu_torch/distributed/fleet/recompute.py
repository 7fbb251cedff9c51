"""Activation recomputation (counterpart:
``paddle_tpu/distributed/fleet/recompute.py``).

:func:`recompute` runs a segment under ``torch.utils.checkpoint``
(non-reentrant): the forward keeps none of the segment's activations,
and backward runs the segment again to rebuild them.

The replay runs as the forward ran. ``torch.utils.checkpoint`` saves and
restores only torch's default CPU and CUDA generators, and the port's
dropout draws from a model-owned ``torch.Generator`` (GPT's hidden
dropout). So the segment's generators, every ``torch.Generator`` held as
a ``generator`` attribute of a module of the segment, are read when the
forward starts the segment, set back to that state for the replay, and
returned afterwards to the state the forward left them in. The replay
thus draws the forward's masks, and the next forward draws what it
would have drawn without recompute. The JAX package gets this from its
counter-folded keys. The AMP state (:mod:`...amp.state`) is handled the
same way: ``Model`` leaves ``auto_cast`` before backward, and the replay
casts as the forward did.

Granularity ``"full"`` (recompute everything) is ported; ``"full_attn"``
(keep the tagged attention output) and ``offload`` are refused.
``use_reentrant`` is taken for the reference's signature: the segment
runs non-reentrant either way, with the same gradients.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...amp.state import amp_state

__all__ = ["recompute", "recompute_sequential"]


def _segment_generators(function):
    owner = function if isinstance(function, nn.Module) \
        else getattr(function, "__self__", None)
    if not isinstance(owner, nn.Module):
        return []
    gens = {}
    for mod in owner.modules():
        g = getattr(mod, "generator", None)
        if isinstance(g, torch.Generator):
            gens[id(g)] = g
    return list(gens.values())


def _replay_contexts(generators):
    """``context_fn`` for checkpoint: the forward's context records the
    generators' states and the AMP state; the replay's sets them back
    for its draws and casts, and restores what it found when it is
    done."""
    amp = amp_state()
    start = []

    @contextlib.contextmanager
    def forward():
        start[:] = [amp.snapshot()] + [g.get_state() for g in generators]
        yield

    @contextlib.contextmanager
    def replay():
        now = [amp.snapshot()] + [g.get_state() for g in generators]
        amp.restore(start[0])
        for g, s in zip(generators, start[1:]):
            g.set_state(s)
        try:
            yield
        finally:
            amp.restore(now[0])
            for g, s in zip(generators, now[1:]):
                g.set_state(s)

    return forward(), replay()


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    backward. Without grad (``torch.no_grad``, evaluation) the function
    runs plainly. Options: ``preserve_rng_state`` (default True: torch's
    default generators as well as the segment's own), ``granularity``
    (``"full"``), ``use_reentrant`` (accepted; see the module note)."""
    return _recompute(function, args, kwargs, ())


def _recompute(function, args, kwargs, generators):
    """:func:`recompute`, replaying ``generators`` besides the
    function's own."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    granularity = kwargs.pop("granularity", "full")
    if kwargs.pop("offload", False):
        raise NotImplementedError(
            "recompute(offload=True) is not ported to paddle_tpu_torch yet")
    if granularity == "full_attn":
        raise NotImplementedError(
            "recompute granularity 'full_attn' (keeping the tagged "
            "attention output, mark_saveable) is not ported to "
            "paddle_tpu_torch yet")
    if granularity != "full":
        raise ValueError(
            f"recompute granularity {granularity!r} not in ('full', "
            "'full_attn') — 'core_attn' is handled by the caller wrapping "
            "only the attention sublayer")
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    gens = (_segment_generators(function) + list(generators)
            if preserve else [])
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve,
                      context_fn=lambda: _replay_contexts(gens), **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence of functions in ``ctx["segments"]`` segments
    of ``len // segments`` functions each (the last segments may be
    shorter), each segment one :func:`recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    if isinstance(functions, nn.Module):
        functions = list(functions.children())
    funcs = list(functions)
    seg_size = max(1, len(funcs) // max(segments, 1))
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(funcs), seg_size):
        chunk = funcs[i:i + seg_size]

        def segment(x, chunk=chunk):
            for f in chunk:
                x = f(x)
            return x
        gens = [g for f in chunk for g in _segment_generators(f)]
        out = _recompute(segment, (out,), dict(kwargs), gens)
    return out
