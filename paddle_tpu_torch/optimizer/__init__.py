"""Optimizers (counterpart: ``paddle_tpu/optimizer``): the base with
parameter groups, master weights, grad clipping and L1; Adam and AdamW
over the multi-tensor kernel K4; SGD, Momentum, Adagrad, RMSProp,
Adamax, Adadelta, Lamb, NAdam, RAdam, Rprop and ASGD, each one
``torch._foreach_*`` pass a step on the card; LBFGS; and the
learning-rate schedules."""
from . import lr
from .lr import LRScheduler
from .optimizer import Optimizer
from .optimizers import (ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax,
                         AdamW, Lamb, Momentum, NAdam, RAdam, RMSProp, Rprop)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "LBFGS", "LRScheduler", "Lamb", "Momentum", "NAdam", "Optimizer",
           "RAdam", "RMSProp", "Rprop", "SGD", "lr"]
