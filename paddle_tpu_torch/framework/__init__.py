"""``save`` and ``load`` (counterpart: ``paddle_tpu/framework``)."""
from .io_save import load, save

__all__ = ["load", "save"]
