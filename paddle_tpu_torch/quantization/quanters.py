"""Fake quantizers: quantize-dequantize with a clipped straight-through
gradient (counterpart: ``paddle_tpu/quantization/quanters.py``).

:func:`fake_quant` is ``round(clip(x / step)) * step``, step = scale /
qmax, as a ``torch.autograd.Function`` whose backward passes the
gradient only where ``|x| <= scale`` (none to the scale). Divisions are
by tensors on x's device, so the card divides as the CPU does (PyTorch
multiplies by the reciprocal of a Python scalar divisor there).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["fake_quant", "FakeQuanterWithAbsMaxObserver",
           "FakeQuanterChannelWiseAbsMax", "quantize_to_int8"]


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, qmax):
        ctx.save_for_backward(x, scale)
        q = torch.tensor(qmax, dtype=scale.dtype, device=scale.device)
        step = scale / q
        return torch.clamp(torch.round(x / step), -q - 1, q) * step

    @staticmethod
    def backward(ctx, g):
        # clipped STE: the gradient passes only inside the clip range
        x, scale = ctx.saved_tensors
        inside = (x.abs() <= scale).to(g.dtype)
        return g * inside, torch.zeros_like(scale), None


def fake_quant(x, scale, bit_length=8):
    """Functional quantize-dequantize with the clipped-STE gradient."""
    qmax = float(2 ** (bit_length - 1) - 1)
    return _FakeQuant.apply(x, scale, qmax)


class FakeQuanterWithAbsMaxObserver(nn.Module):
    """QAT activation quanter: a moving-average absmax scale (a buffer
    updated from each training batch) and fake quant."""

    def __init__(self, moving_rate=0.9, bit_length=8, dtype="float32"):
        super().__init__()
        self._moving_rate = moving_rate
        self._bit_length = bit_length
        self._qmax = float(2 ** (bit_length - 1) - 1)
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self.register_buffer("state", torch.zeros((), dtype=torch.float32))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                absmax = x.detach().abs().max().to(torch.float32)
                r = self._moving_rate
                state = self.state * r + 1.0
                scale = (self.scale * self.state * r + absmax) / state
                self.scale.copy_(torch.clamp_min(scale, 1e-9))
                self.state.copy_(state)
        return fake_quant(x, self.scale.clone(),
                          bit_length=self._bit_length)

    def quant_axis(self):
        return None

    def scales(self):
        return self.scale.clone()


class FakeQuanterChannelWiseAbsMax(nn.Module):
    """Weight quanter: per-channel absmax, recomputed each forward.
    ``quant_axis`` names the channel axis of the tensor it is given; the
    port's ``Linear`` weight is ``[out, in]``, so its output channel is
    axis 0, the JAX package's default axis 1 of its ``[in, out]``
    weight."""

    def __init__(self, quant_axis=0, bit_length=8, dtype="float32"):
        super().__init__()
        self._quant_axis = quant_axis
        self._bit_length = bit_length
        self._qmax = float(2 ** (bit_length - 1) - 1)

    def forward(self, w):
        axes = tuple(i for i in range(w.dim()) if i != self._quant_axis)
        scale = torch.amax(w.detach().abs(), dim=axes, keepdim=True)
        scale = torch.clamp_min(scale.to(torch.float32), 1e-9)
        return fake_quant(w, scale, bit_length=self._bit_length)

    def quant_axis(self):
        return self._quant_axis


def quantize_to_int8(arr, quant_axis=None):
    """Real quantization for PTQ's convert: ``(int8 values, float32
    scale)`` in numpy, the JAX package's ops in its order."""
    arr = np.asarray(arr, dtype=np.float32)
    if quant_axis is None:
        scale = np.maximum(np.abs(arr).max(), 1e-9)
    else:
        axes = tuple(i for i in range(arr.ndim) if i != quant_axis)
        scale = np.maximum(np.abs(arr).max(axis=axes, keepdims=True), 1e-9)
    q = np.clip(np.round(arr / scale * 127.0), -128, 127).astype(np.int8)
    return q, np.asarray(scale, np.float32)
