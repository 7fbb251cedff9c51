"""Normalisation layers (counterpart: ``paddle_tpu/nn/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .functional import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """LayerNorm with a weight (ones) and a bias (zeros) over
    ``normalized_shape``; float32 statistics (:func:`.functional.
    layer_norm`)."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **kw))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)


class RMSNorm(nn.Module):
    """LLaMA's RMSNorm; the weight starts at ones."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
