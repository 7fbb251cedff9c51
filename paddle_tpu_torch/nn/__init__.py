"""Layers and functions of the port's trunks. Linear and Embedding are
``torch.nn``'s own; note that ``torch.nn.Linear`` stores its weight
``[out, in]`` where the JAX package stores ``[in, out]``
(``models/convert.py`` transposes when weights are carried across)."""
from . import functional
from .common import Dropout
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "LayerNorm", "RMSNorm", "functional"]
