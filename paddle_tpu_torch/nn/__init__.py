"""Layers and functions of the port's LLaMA trunk. Linear and Embedding
are ``torch.nn``'s own; note that ``torch.nn.Linear`` stores its weight
``[out, in]`` where the JAX package stores ``[in, out]``
(``models/convert.py`` transposes when weights are carried across)."""
from . import functional
from .norm import RMSNorm

__all__ = ["RMSNorm", "functional"]
