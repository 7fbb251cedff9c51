"""High-level training API (counterpart: ``paddle_tpu/hapi``)."""
from .model import Model

__all__ = ["Model"]
