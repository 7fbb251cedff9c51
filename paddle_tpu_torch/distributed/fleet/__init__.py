"""``fleet`` (counterpart: ``paddle_tpu/distributed/fleet``): activation
recomputation only so far."""
from .recompute import mark_saveable, recompute, recompute_sequential

__all__ = ["mark_saveable", "recompute", "recompute_sequential"]
