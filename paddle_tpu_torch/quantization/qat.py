"""QAT: quantization-aware training by fake-quant layer substitution
(counterpart: ``paddle_tpu/quantization/qat.py``).
``QAT(config).quantize(model)`` swaps each configured ``Linear`` for a
:class:`QuantedLinear` that fake-quantizes its weight (per output
channel) and, when configured, its input; training then runs as usual
(straight-through gradients), and ``convert()`` swaps plain ``Linear``
layers back in whose weights are the fake-quantized values. The conv
layers (``QuantedConv2D``) wait for the port's ``vision/`` layers.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..amp.state import cast_for_op
from ..nn.common import Linear
from .config import QuantConfig
from .quanters import (FakeQuanterChannelWiseAbsMax,
                       FakeQuanterWithAbsMaxObserver)

__all__ = ["QAT", "QuantedLinear"]


class QuantedLinear(nn.Module):
    """Linear with a fake-quanted weight and (optionally) input."""

    def __init__(self, layer: Linear, q_config):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self.weight_quanter = (q_config.weight() if q_config.weight
                               else FakeQuanterChannelWiseAbsMax(quant_axis=0))
        self.activation_quanter = (q_config.activation()
                                   if q_config.activation else None)

    def forward(self, x):
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        w = self.weight_quanter(self.weight)
        x, w = cast_for_op((x, w), "matmul")
        (b,) = cast_for_op((self.bias,), "matmul")
        return F.linear(x, w, b)


_QAT_MAPPING = {Linear: QuantedLinear}


def _walk_and_replace(model, config, mapping, factory, _prefix=""):
    """Replace configured sublayers in place (recursively, so name-based
    configs see the qualified dotted path); returns the count."""
    count = 0
    for name, child in list(model.named_children()):
        qname = f"{_prefix}.{name}" if _prefix else name
        cls = mapping.get(type(child))
        cfg = (config._get_config_by_layer(child, qname)
               if cls is not None else None)
        if cls is not None and cfg is not None:
            setattr(model, name, factory(cls, child, cfg))
            count += 1
        else:
            count += _walk_and_replace(child, config, mapping, factory,
                                       _prefix=qname)
    return count


class QAT:
    def __init__(self, config: QuantConfig | None = None):
        self._config = config or QuantConfig(
            activation=FakeQuanterWithAbsMaxObserver, weight=None)

    def quantize(self, model, inplace=True):
        if not inplace:
            raise NotImplementedError(
                "copy-quantize not supported; pass inplace=True")
        _walk_and_replace(model, self._config, _QAT_MAPPING,
                          lambda cls, child, cfg: cls(child, cfg))
        return model

    @torch.no_grad()
    def convert(self, model, inplace=True):
        """Freeze: swap the quanted layers back to plain ``Linear``
        layers whose weights are the fake-quantized values."""
        for parent in list(model.modules()):
            for name, child in list(parent.named_children()):
                if isinstance(child, QuantedLinear):
                    w = child.weight_quanter(child.weight.detach())
                    lin = Linear.__new__(Linear)
                    nn.Module.__init__(lin)
                    lin.out_features, lin.in_features = w.shape
                    lin.weight = nn.Parameter(w)
                    lin.bias = child.bias
                    setattr(parent, name, lin)
        return model
