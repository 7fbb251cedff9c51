"""Distributed training (counterpart: ``paddle_tpu/distributed``): only
``fleet.recompute`` is ported so far."""
from . import fleet

__all__ = ["fleet"]
