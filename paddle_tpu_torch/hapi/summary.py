"""``summary`` and ``flops`` (counterpart: ``paddle_tpu/hapi/summary.py``).

Both run ONE forward of the network without grad, on zeros of
``input_size`` (or on ``input``), with a forward hook on every submodule
collecting its output shape in the order the modules finish.
``summary`` prints the per-module table and returns the parameter
totals; ``flops`` counts each module's FLOPs by its class's rule (one
multiply-add counted as one FLOP, the reference's convention) and
returns the total. The rules cover the layer classes the port has:
``Linear`` (``torch.nn.Linear`` and the port's), the norms (the port's
``LayerNorm`` and ``RMSNorm``, ``torch.nn``'s) and ``torch.nn``'s
activations. The conv and pool rules come with the vision layers.
``custom_ops`` maps further classes to ``fn(module, output_shape) ->
int``.

The inputs are made on the network's device, so the forward runs where
the network lives.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch
from torch import nn

from ..device import resolve_dtype
from ..nn import LayerNorm, RMSNorm

__all__ = ["summary", "flops"]


def _device(net):
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def _make_inputs(input_size, dtypes, device):
    if input_size is None:
        raise ValueError("summary/flops need input_size or input")
    if isinstance(input_size, tuple) and all(
            isinstance(d, (numbers.Integral, type(None))) for d in input_size):
        sizes = [input_size]
    elif isinstance(input_size, (list, tuple)):
        sizes = list(input_size)
    else:
        raise TypeError(f"bad input_size {input_size!r}")
    if dtypes is None:
        dtypes = ["float32"] * len(sizes)
    elif isinstance(dtypes, str):
        dtypes = [dtypes] * len(sizes)
    elif len(dtypes) != len(sizes):
        raise ValueError(f"dtypes has {len(dtypes)} entries for "
                         f"{len(sizes)} inputs")
    return [torch.zeros(tuple(1 if d is None or d < 0 else int(d)
                              for d in shape),
                        dtype=resolve_dtype(dt), device=device)
            for shape, dt in zip(sizes, dtypes)]


def _out_shape(out):
    if isinstance(out, torch.Tensor):
        return list(out.shape)
    if isinstance(out, (list, tuple)) and out and isinstance(
            out[0], torch.Tensor):
        return list(out[0].shape)
    return []


def _collect(net, inputs):
    """One forward without grad with a hook on every submodule: rows of
    ``(qualified name, module, output shape)`` in finishing order."""
    rows, handles = [], []
    subs = list(net.named_modules())[1:] or [(type(net).__name__.lower(),
                                              net)]
    for qname, sub in subs:
        handles.append(sub.register_forward_hook(
            lambda m, ins, outs, qname=qname: rows.append(
                (qname, m, _out_shape(outs)))))
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
    return rows


def _count(params):
    total = trainable = 0
    for p in params:
        total += p.numel()
        trainable += p.numel() if p.requires_grad else 0
    return total, trainable


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-module table (name, class, output shape, own
    parameters) and return ``{"total_params", "trainable_params"}``."""
    if input is None:
        inputs = _make_inputs(input_size, dtypes, _device(net))
    elif isinstance(input, torch.Tensor):
        inputs = [input]
    else:
        inputs = list(input)
    rows = _collect(net, [x if isinstance(x, torch.Tensor)
                          else torch.as_tensor(np.asarray(x))
                          for x in inputs])
    header = f"{'Layer (type)':<38}{'Output Shape':<24}{'Param #':>12}"
    line = "-" * len(header)
    print(line)
    print(header)
    print(line)
    for qname, mod, oshape in rows:
        own = _count(mod.parameters(recurse=False))[0]
        print(f"{qname + ' (' + type(mod).__name__ + ')':<38}"
              f"{str(oshape):<24}{own:>12,}")
    print(line)
    total, trainable = _count(net.parameters())
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


# -- FLOPs rules (one multiply-add = one FLOP) ---------------------------------

def _linear_flops(mod, oshape):
    out_f, in_f = mod.weight.shape          # torch's [out, in]
    nbatch = int(np.prod(oshape[:-1])) if len(oshape) > 1 else 1
    bias = out_f if mod.bias is not None else 0
    return nbatch * (in_f * out_f + bias)


def _norm_flops(mod, oshape):
    return 2 * int(np.prod(oshape))


def _act_flops(mod, oshape):
    return int(np.prod(oshape))


def _default_rules():
    rules = {nn.Linear: _linear_flops}
    for cls in (LayerNorm, RMSNorm, nn.LayerNorm, nn.GroupNorm,
                nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d,
                nn.InstanceNorm1d, nn.InstanceNorm2d, nn.InstanceNorm3d,
                getattr(nn, "RMSNorm", None)):
        if cls is not None:
            rules[cls] = _norm_flops
    for cls in (nn.ReLU, nn.ReLU6, nn.GELU, nn.Sigmoid, nn.Tanh, nn.Softmax,
                nn.LeakyReLU, nn.SiLU, nn.Hardswish, nn.PReLU):
        rules[cls] = _act_flops
    return rules


def flops(net, input_size=None, custom_ops=None, print_detail=False):
    """The FLOPs of one forward on zeros of ``input_size`` (float32) by
    the rules above, ``custom_ops`` taking precedence; prints the total
    (and, with ``print_detail``, each module's) and returns it."""
    rows = _collect(net, _make_inputs(input_size, None, _device(net)))
    rules = _default_rules()
    rules.update(custom_ops or {})
    total, details = 0, []
    for qname, mod, oshape in rows:
        fn = next((rules[c] for c in type(mod).__mro__ if c in rules), None)
        n = int(fn(mod, oshape)) if fn and oshape else 0
        total += n
        details.append((qname, type(mod).__name__, oshape, n))
    if print_detail:
        hdr = f"{'Layer':<38}{'Output Shape':<24}{'FLOPs':>14}"
        print("-" * len(hdr))
        print(hdr)
        print("-" * len(hdr))
        for qname, tname, oshape, n in details:
            print(f"{qname + ' (' + tname + ')':<38}{str(oshape):<24}"
                  f"{n:>14,}")
        print("-" * len(hdr))
    print(f"Total Flops: {total:,}")
    return total
