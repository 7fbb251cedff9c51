"""Layers and functions of the port's trunks. ``Linear`` is
``torch.nn.Linear`` with the AMP cast of the JAX package's op layer in
front (:mod:`..amp`); note that ``torch.nn.Linear`` stores its weight
``[out, in]`` where the JAX package stores ``[in, out]``
(``models/convert.py`` transposes when weights are carried across)."""
from . import functional
from .clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm,
                        ClipGradByValue, clip_grad_norm_)
from .common import Dropout, Linear
from .norm import LayerNorm, RMSNorm
from . import quant

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "LayerNorm", "Linear", "RMSNorm", "clip_grad_norm_",
           "functional", "quant"]
