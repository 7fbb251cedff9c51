"""Linear and Dropout (counterpart: ``paddle_tpu/nn/common.py``)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..amp.state import cast_for_op
from .functional import dropout

__all__ = ["Dropout", "Linear"]


class Linear(nn.Linear):
    """``torch.nn.Linear`` (weight ``[out, in]``) behind the JAX package's
    AMP hook: under ``auto_cast`` a float32 input, weight and bias are
    cast to the AMP dtype (category ``"matmul"``, as its ``F.linear``)."""

    def forward(self, x):
        x, w = cast_for_op((x, self.weight), "matmul")
        (b,) = cast_for_op((self.bias,), "matmul")
        return F.linear(x, w, b)


class Dropout(nn.Module):
    """``Dropout(p, axis=None, mode="upscale_in_train", *, generator)``:
    :func:`.functional.dropout` in training. Its mask comes from
    ``generator``, a ``torch.Generator`` on the activations' device that
    the owning model holds (so a model's seed decides its masks); the
    layer never draws from torch's global default."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 generator):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
