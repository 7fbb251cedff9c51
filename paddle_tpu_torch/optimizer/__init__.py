"""Optimizers (counterpart: ``paddle_tpu/optimizer``): the base with
parameter groups and master weights, Adam and AdamW over the
multi-tensor kernel K4, and the LR-scheduler base."""
from . import lr
from .lr import LRScheduler
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "LRScheduler", "Optimizer", "lr"]
