"""``paddle.incubate.nn`` (counterpart: ``paddle_tpu/incubate/nn/``)."""
from . import functional

__all__ = ["functional"]
