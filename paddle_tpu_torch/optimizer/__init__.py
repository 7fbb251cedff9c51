"""Optimizers (counterpart: ``paddle_tpu/optimizer``): the base with
parameter groups, master weights, grad clipping and L1, Adam and AdamW
over the multi-tensor kernel K4, and the learning-rate schedules."""
from . import lr
from .lr import LRScheduler
from .optimizer import Optimizer
from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW", "LRScheduler", "Optimizer", "lr"]
