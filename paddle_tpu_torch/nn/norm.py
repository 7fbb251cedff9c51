"""Normalisation layers (counterpart: ``paddle_tpu/nn/norm.py``)."""
from __future__ import annotations

import torch
from torch import nn

from .functional import rms_norm

__all__ = ["RMSNorm"]


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
