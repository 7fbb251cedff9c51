"""``fleet`` (counterpart: ``paddle_tpu/distributed/fleet``): activation
recomputation only so far."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
