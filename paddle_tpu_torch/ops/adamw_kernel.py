"""Multi-tensor AdamW: the hand-written kernel K4 and its plain PyTorch
version (counterpart: ``paddle_tpu/ops/pallas/_adamw_kernel.py``).

One call updates every leaf of an optimizer step, IN PLACE: each leaf's
float32 master weight (when it has one), moments and param are
overwritten; nothing is returned. A leaf is ``(param, grad, state)`` with
``state = {"moment1", "moment2"[, "master"]}`` float32 tensors shaped like
the param; the grad is float32 or the param's dtype. The rule is the JAX
package's ``Adam._update`` (``optimizer/optimizers.py:201``), coupled or
decoupled (AdamW) decay, with the f32 master as the source of truth when
present, and the steps of its ``Optimizer.step`` around the rule folded
into the same pass (``optimizer/optimizer.py``, ``_update_one``):

- ``clip``: a 0-d float32 tensor on the params' device, the global-norm
  clip factor (:meth:`..nn.clip_grad.ClipGradByGlobalNorm.factor`); each
  grad of a leaf whose ``clip_mask`` entry is true is multiplied by it
  and rounded to the grad's dtype before use, and no grad is rewritten;
- ``l1``: ``l1 * sign(w)`` added to the grad, ``w`` the master where
  there is one (``L1Decay``).

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
           "adamw_eligible", "adam_rule", "apply_in_place", "prepare_grad",
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
    tensor the rule runs on (the f32 master where there is one). The
    bias corrections divide as 0-d tensors on the param's device: CUDA
    would turn a division by a Python scalar into a multiply by its
    reciprocal, where K4 and the JAX package divide."""
    if wd and not decoupled:
        grad = grad + wd * param
    m1 = b1 * state["moment1"] + (1 - b1) * grad
    m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=param.device)
                for b in bias_corrections(b1, b2, step))
    out = {"moment1": m1, "moment2": m2}
    vv = m2
    if amsgrad:
        vv = torch.maximum(state["moment2_max"], m2)
        out["moment2_max"] = vv
    update = (m1 / bc1) / (torch.sqrt(vv / bc2) + eps)
    if wd and decoupled:
        update = update + wd * param
    return param - lr * update, out


def prepare_grad(grad, compute, clip=None, l1=0.0):
    """The grad as the rule sees it, in ``compute``'s dtype: times the
    clip factor and rounded back to its own dtype, then ``l1 *
    sign(compute)`` added (the JAX package's clip and ``_update_one``)."""
    if clip is not None:
        grad = (grad.float() * clip).to(grad.dtype)
    grad = grad.to(compute.dtype)
    if l1:
        grad = grad + l1 * torch.sign(compute)
    return grad


def apply_in_place(param, grad, state, rule, clip=None, l1=0.0):
    """One leaf through ``rule(compute, grad, state) -> (new, new_state)``,
    written back in place: ``compute`` is the f32 master where there is
    one (the grad through :func:`prepare_grad`), and the param becomes the
    cast of the new value."""
    compute = state.get("master", param)
    new, new_state = rule(compute, prepare_grad(grad, compute, clip, l1),
                          state)
    for key, val in new_state.items():
        state[key].copy_(val)
    if "master" in state:
        state["master"].copy_(new)
    param.copy_(new)


def adamw_update(params, grads, states, *, lr, step, b1, b2, eps, wd,
                 decoupled, l1=0.0, clip=None, clip_mask=None):
    """Update every leaf in place (see the module docstring)."""
    if not params:
        return
    fn = (adamw_update_plain if params[0].device.type == "cpu"
          else adamw_update_cuda)
    fn(params, grads, states, lr=lr, step=step, b1=b1, b2=b2, eps=eps,
       wd=wd, decoupled=decoupled, l1=l1, clip=clip, clip_mask=clip_mask)


def _mask(clip_mask, n):
    return [True] * n if clip_mask is None else [bool(c) for c in clip_mask]


def adamw_update_plain(params, grads, states, *, lr, step, b1, b2, eps, wd,
                       decoupled, l1=0.0, clip=None, clip_mask=None):
    """Plain version of K4: :func:`adam_rule` leaf by leaf, in place."""
    stats["plain_calls"] += 1
    rule = functools.partial(adam_rule, lr=lr, step=step, b1=b1, b2=b2,
                             eps=eps, wd=wd, decoupled=decoupled)
    for p, g, s, c in zip(params, grads, states, _mask(clip_mask,
                                                        len(params))):
        apply_in_place(p, g, s, rule, clip if c else None, l1)


# -- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_F = ctypes.c_float
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "adamw.cu",
    {"adamw_multi_tensor": ([_P, ctypes.c_int, ctypes.c_longlong, _P]
                            + [_F] * 10 + [ctypes.c_int, _P], ctypes.c_int)})
CHUNK = 8192  # elements per block, as kChunk in csrc/adamw.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC, _CLIP = 1, 2   # the leaf's flags, as kVec and kClip


def _require(cond, msg):
    if not cond:
        raise ValueError(f"adamw_update_cuda: {msg}")


def _leaf_row(p, g, s, chunk0, dev, clip):
    _require(p.device == dev and g.device == dev,
             f"param/grad on {p.device}/{g.device}, first param on {dev}")
    _require(p.dtype in _DTYPES, f"param dtype {p.dtype}")
    _require(g.dtype in (p.dtype, torch.float32),
             f"grad dtype {g.dtype} for a {p.dtype} param")
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
    vec = all(x.data_ptr() % 16 == 0 for x in f32) and all(
        x.data_ptr() % (16 if x.dtype == torch.float32 else 8) == 0
        for x in (p, g))
    return [p.data_ptr(), master.data_ptr() if master is not None else 0,
            g.data_ptr(), s["moment1"].data_ptr(), s["moment2"].data_ptr(),
            p.numel(), chunk0, _DTYPES[p.dtype], _DTYPES[g.dtype],
            _VEC * int(vec) + _CLIP * int(clip)]


def adamw_update_cuda(params, grads, states, *, lr, step, b1, b2, eps, wd,
                      decoupled, l1=0.0, clip=None, clip_mask=None):
    """ONE launch of K4 over every leaf, on the first param's current
    stream. Every leaf lies on that CUDA device; a param is bf16 or f32,
    with or without an f32 master; a grad is float32 or its param's
    dtype; all tensors contiguous; ``clip`` a float32 tensor of one
    element on that device, read there by the kernel. The leaf table (ten
    int64 a leaf) goes to the device through pinned memory without
    waiting for the host. Raises on anything else and if the launch
    fails."""
    dev = params[0].device
    _require(dev.type == "cuda", f"params lie on {dev}; K4 needs CUDA")
    if clip is not None:
        _require(clip.device == dev and clip.dtype == torch.float32
                 and clip.numel() == 1 and clip.is_contiguous(),
                 "clip must be one float32 on the params' device")
    rows, chunk0 = [], 0
    for p, g, s, c in zip(params, grads, states,
                          _mask(clip_mask, len(params))):
        if p.numel() == 0:
            continue
        rows.append(_leaf_row(p, g, s, chunk0, dev, c and clip is not None))
        chunk0 += -(-p.numel() // CHUNK)
    if not rows:
        return
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    bc1, bc2 = bias_corrections(b1, b2, step)
    lib = KERNEL_LIBRARY.lib()
    with torch.cuda.device(dev):
        rc = lib.adamw_multi_tensor(
            table.data_ptr(), len(rows), chunk0,
            clip.data_ptr() if clip is not None else None, float(lr),
            float(b1), float(b2), float(1 - b1), float(1 - b2), float(eps),
            float(wd), bc1, bc2, float(l1),
            int(bool(decoupled)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw_multi_tensor (K4) kernel launch failed: "
                           f"cudaError {rc}")
    stats["kernel_launches"] += 1
