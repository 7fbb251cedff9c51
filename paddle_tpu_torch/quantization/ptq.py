"""PTQ: post-training quantization by observer insertion and convert
(counterpart: ``paddle_tpu/quantization/ptq.py``).
``PTQ(config).quantize(model)`` wraps each configured ``Linear`` with an
observer; the user runs calibration batches; ``convert()`` freezes the
observed scales into :class:`QuantizedInferenceLinear` layers with int8
weights, whose products run through K7 on the card
(:mod:`..ops.weight_only_kernel`): with an activation scale the A8 arm
(int8 x int8 -> int32, then rescaled), without one the weight-only arm.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.common import Linear
from ..ops.weight_only_kernel import int8_matmul, weight_only_matmul
from .config import QuantConfig
from .observers import AbsmaxObserver
from .quanters import quantize_to_int8

__all__ = ["PTQ", "QuantizedInferenceLinear"]


class _ObservedLinear(nn.Module):
    def __init__(self, layer: Linear, q_config):
        super().__init__()
        self._layer = layer
        obs_cls = q_config.activation or AbsmaxObserver
        self.activation_observer = obs_cls()

    def forward(self, x):
        x = self.activation_observer(x)
        return self._layer(x)


class QuantizedInferenceLinear(nn.Module):
    """Deployment linear: an int8 weight ``[n, k]`` and its float32
    per-channel scale ``[n, 1]`` (the absmax; the JAX package's ``[k,
    n]`` and ``[1, n]`` transposed).

    With a calibrated activation scale the layer runs a true int8 x int8
    -> int32 product: x quantized with sx = act_scale / 127 (``clip(
    round(x / sx), -127, 127)``, in float32), the int32 sum, then
    ``(float)acc * (sx * (w_scale / 127))`` in x's dtype (K7's A8 arm on
    the card). Without one, the weight is dequantized in x's dtype
    (K7's weight-only arm with the scale w_scale / 127). The bias is
    added after either."""

    def __init__(self, weight_i8, w_scale, bias, act_scale=None):
        super().__init__()
        self.register_buffer("weight_quant", torch.as_tensor(weight_i8))
        self.register_buffer("weight_scale", torch.as_tensor(w_scale))
        self.bias = bias
        self._act_scale = act_scale

    def forward(self, x):
        dev = x.device
        w_scale = self.weight_scale.reshape(-1)
        if self._act_scale is not None:
            sx = np.float32(self._act_scale) / np.float32(127.0)
            x_i8 = torch.clamp(
                torch.round(x.to(torch.float32)
                            / torch.tensor(sx, device=dev)),
                -127, 127).to(torch.int8)
            y = int8_matmul(x_i8, self.weight_quant, w_scale, sx, x.dtype)
        else:
            y = weight_only_matmul(
                x, self.weight_quant,
                w_scale / torch.tensor(127.0, device=w_scale.device))
        if self.bias is not None:
            y = y + self.bias
        return y


class PTQ:
    def __init__(self, config: QuantConfig | None = None):
        self._config = config or QuantConfig(activation=AbsmaxObserver,
                                             weight=None)

    def quantize(self, model, inplace=True):
        if not inplace:
            raise NotImplementedError(
                "copy-quantize not supported; pass inplace=True")
        self._walk(model, "")
        return model

    def _walk(self, layer, prefix):
        for name, child in list(layer.named_children()):
            qname = f"{prefix}.{name}" if prefix else name
            if type(child) is Linear:
                cfg = self._config._get_config_by_layer(child, qname)
                if cfg is not None:
                    setattr(layer, name, _ObservedLinear(child, cfg))
                    continue
            self._walk(child, qname)

    @torch.no_grad()
    def convert(self, model, inplace=True):
        for parent in list(model.modules()):
            for name, child in list(parent.named_children()):
                if not isinstance(child, _ObservedLinear):
                    continue
                child.activation_observer.cal_thresholds()
                act_scale = float(child.activation_observer.scales())
                lin = child._layer
                w = lin.weight.detach().float().cpu().numpy()
                w_i8, w_scale = quantize_to_int8(w, quant_axis=0)
                dev = lin.weight.device
                setattr(parent, name, QuantizedInferenceLinear(
                    torch.from_numpy(w_i8).to(dev),
                    torch.from_numpy(w_scale).to(dev), lin.bias, act_scale))
        return model
