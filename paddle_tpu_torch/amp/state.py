"""The AMP state and the op layer's cast rule (counterpart:
``paddle_tpu/amp/state.py``).

:func:`cast_for_op` is the JAX package's rule, applied where its op layer
applies it: the port's ``Linear`` (category ``"matmul"``) and
``scaled_dot_product_attention`` (``"attention"``). Under ``auto_cast`` a
float32 or float64 input of a white-listed category (every category at
O2, black-listed ones excepted) is cast to the AMP dtype; anything else
runs in the dtype it comes in. This is not ``torch.autocast``, which also
casts its float32-list ops (exp, log_softmax, cross entropy, norms) UP;
the JAX package leaves a black-listed op's inputs as they come.
"""
from __future__ import annotations

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "amp_state", "cast_for_op"]

WHITE_LIST = {"matmul", "conv", "einsum", "bmm", "mm", "addmm",
              "attention"}
BLACK_LIST = {"softmax", "log_softmax", "layer_norm", "batch_norm", "exp",
              "log", "mean", "sum", "cross_entropy", "norm", "cumsum"}
_WIDE = (torch.float32, torch.float64)


class _AmpState:
    __slots__ = ("enabled", "dtype", "level", "custom_white", "custom_black")

    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()

    def snapshot(self):
        return tuple(getattr(self, k) for k in self.__slots__)

    def restore(self, snap):
        for k, v in zip(self.__slots__, snap):
            setattr(self, k, v)


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def cast_for_op(tensors, category):
    """``tensors`` cast per the active AMP level (``None`` entries pass)."""
    st = _state
    if not st.enabled or category in st.custom_black \
            or category in BLACK_LIST:
        return tensors
    if st.level == "O2" or category in WHITE_LIST \
            or category in st.custom_white:
        return tuple(t.to(st.dtype) if t is not None and t.dtype in _WIDE
                     else t for t in tensors)
    return tensors
