"""High-level training API (counterpart: ``paddle_tpu/hapi``)."""
from . import callbacks
from .model import Model

__all__ = ["Model", "callbacks"]
