"""Multi-tensor AdamW: the hand-written kernel K4 and its plain PyTorch
version (counterpart: ``paddle_tpu/ops/pallas/_adamw_kernel.py``).

One call updates every leaf of an optimizer step, IN PLACE: each leaf's
float32 master weight (when it has one), moments and param are
overwritten; nothing is returned. A leaf is ``(param, grad, state)`` with
``state = {"moment1", "moment2"[, "master"]}`` float32 tensors shaped like
the param; the grad has the param's dtype. The rule is the JAX package's
``Adam._update`` (``optimizer/optimizers.py:201``), coupled or decoupled
(AdamW) decay, with the f32 master as the source of truth when present.

- :func:`adamw_update` dispatches: CPU params → :func:`adamw_update_plain`
  (the rule leaf by leaf), any other → :func:`adamw_update_cuda` (ONE
  launch of ``csrc/adamw.cu`` over all leaves, any leaf size), which
  raises for params that are not on a CUDA device.
- :func:`adamw_eligible` keeps the JAX package's amsgrad exclusion; the
  TPU kernel's lane-divisibility condition does not apply here.

``stats`` counts kernel launches, plain-version calls and the steps that
took the plain amsgrad rule (``Adam(amsgrad=True)``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..cuda_build import KernelLibrary

__all__ = ["adamw_update", "adamw_update_cuda", "adamw_update_plain",
           "adamw_eligible", "adam_rule", "apply_in_place",
           "bias_corrections", "stats",
           "reset_stats", "KERNEL_LIBRARY", "CHUNK"]

stats = {"kernel_launches": 0, "plain_calls": 0, "amsgrad_plain_calls": 0}


def reset_stats():
    for key in stats:
        stats[key] = 0


def adamw_eligible(state) -> bool:
    return ("moment1" in state and "moment2" in state
            and "moment2_max" not in state)


def bias_corrections(b1, b2, step):
    """``(1 - b1**t, 1 - b2**t)`` in float32, as the JAX package computes
    them from its int32 step."""
    one, t = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(b1) ** t),
            float(one - np.float32(b2) ** t))


def adam_rule(param, grad, state, lr, step, *, b1, b2, eps, wd, decoupled,
              amsgrad=False):
    """The JAX package's ``Adam._update`` on torch tensors: returns
    ``(new_param, new_state)`` and changes nothing. ``param`` is the
    tensor the rule runs on (the f32 master where there is one)."""
    if wd and not decoupled:
        grad = grad + wd * param
    m1 = b1 * state["moment1"] + (1 - b1) * grad
    m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
    bc1, bc2 = bias_corrections(b1, b2, step)
    out = {"moment1": m1, "moment2": m2}
    vv = m2
    if amsgrad:
        vv = torch.maximum(state["moment2_max"], m2)
        out["moment2_max"] = vv
    update = (m1 / bc1) / (torch.sqrt(vv / bc2) + eps)
    if wd and decoupled:
        update = update + wd * param
    return param - lr * update, out


def apply_in_place(param, grad, state, rule):
    """One leaf through ``rule(compute, grad, state) -> (new, new_state)``,
    written back in place: ``compute`` is the f32 master where there is
    one (the grad cast to its dtype), and the param becomes the cast of
    the new value."""
    compute = state.get("master", param)
    new, new_state = rule(compute, grad.to(compute.dtype), state)
    for key, val in new_state.items():
        state[key].copy_(val)
    if "master" in state:
        state["master"].copy_(new)
    param.copy_(new)


def adamw_update(params, grads, states, *, lr, step, b1, b2, eps, wd,
                 decoupled):
    """Update every leaf in place (see the module docstring)."""
    if not params:
        return
    fn = (adamw_update_plain if params[0].device.type == "cpu"
          else adamw_update_cuda)
    fn(params, grads, states, lr=lr, step=step, b1=b1, b2=b2, eps=eps,
       wd=wd, decoupled=decoupled)


def adamw_update_plain(params, grads, states, *, lr, step, b1, b2, eps, wd,
                       decoupled):
    """Plain version of K4: :func:`adam_rule` leaf by leaf, in place."""
    stats["plain_calls"] += 1
    rule = functools.partial(adam_rule, lr=lr, step=step, b1=b1, b2=b2,
                             eps=eps, wd=wd, decoupled=decoupled)
    for p, g, s in zip(params, grads, states):
        apply_in_place(p, g, s, rule)


# -- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_F = ctypes.c_float
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "adamw.cu",
    {"adamw_multi_tensor": ([_P, ctypes.c_int, ctypes.c_longlong]
                            + [_F] * 9 + [ctypes.c_int, _P], ctypes.c_int)})
CHUNK = 8192  # elements per block, as kChunk in csrc/adamw.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond, msg):
    if not cond:
        raise ValueError(f"adamw_update_cuda: {msg}")


def _leaf_row(p, g, s, chunk0, dev):
    _require(p.device == dev and g.device == dev,
             f"param/grad on {p.device}/{g.device}, first param on {dev}")
    _require(p.dtype in _DTYPES, f"param dtype {p.dtype}")
    _require(g.dtype == p.dtype, f"grad dtype {g.dtype} != {p.dtype}")
    _require(adamw_eligible(s), "state needs moment1 and moment2 and no "
             "moment2_max (amsgrad takes the plain rule)")
    master = s.get("master")
    f32 = [s["moment1"], s["moment2"]] + ([master] if master is not None
                                          else [])
    for x in [p, g] + f32:
        _require(x.is_contiguous() and x.shape == p.shape,
                 f"tensor of shape {tuple(x.shape)} / contiguity "
                 f"{x.is_contiguous()} for a {tuple(p.shape)} param")
    for x in f32:
        _require(x.device == dev and x.dtype == torch.float32,
                 "master and moments must be float32 on the param's device")
    align = 16 if p.dtype == torch.float32 else 8
    vec = all(x.data_ptr() % 16 == 0 for x in f32) and all(
        x.data_ptr() % align == 0 for x in (p, g))
    return [p.data_ptr(), master.data_ptr() if master is not None else 0,
            g.data_ptr(), s["moment1"].data_ptr(), s["moment2"].data_ptr(),
            p.numel(), chunk0, _DTYPES[p.dtype], int(vec), 0]


def adamw_update_cuda(params, grads, states, *, lr, step, b1, b2, eps, wd,
                      decoupled):
    """ONE launch of K4 over every leaf, on the first param's current
    stream. Every leaf lies on that CUDA device; a param is bf16 or f32,
    with or without an f32 master; grads have the params' dtypes; all
    tensors contiguous. The leaf table (ten int64 a leaf) goes to the device
    through pinned memory without waiting for the host. Raises on
    anything else and if the launch fails."""
    dev = params[0].device
    _require(dev.type == "cuda", f"params lie on {dev}; K4 needs CUDA")
    rows, chunk0 = [], 0
    for p, g, s in zip(params, grads, states):
        if p.numel() == 0:
            continue
        rows.append(_leaf_row(p, g, s, chunk0, dev))
        chunk0 += -(-p.numel() // CHUNK)
    if not rows:
        return
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    bc1, bc2 = bias_corrections(b1, b2, step)
    lib = KERNEL_LIBRARY.lib()
    with torch.cuda.device(dev):
        rc = lib.adamw_multi_tensor(
            table.data_ptr(), len(rows), chunk0, float(lr), float(b1),
            float(b2), float(1 - b1), float(1 - b2), float(eps), float(wd),
            bc1, float(np.sqrt(np.float32(bc2))), int(bool(decoupled)),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw_multi_tensor (K4) kernel launch failed: "
                           f"cudaError {rc}")
    stats["kernel_launches"] += 1
