"""``paddle.incubate``'s ported parts (counterpart:
``paddle_tpu/incubate/``)."""
from . import nn

__all__ = ["nn"]
