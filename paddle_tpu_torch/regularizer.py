"""Weight-decay regularizers (counterpart: ``paddle_tpu/regularizer.py``).

``weight_decay=L2Decay(c)`` is the optimizer's decay coefficient;
``L1Decay(c)`` adds ``c * sign(w)`` to the gradient (on the float32
master where there is one) before the update rule, inside K4's launch on
the card (:mod:`.ops.adamw_kernel`).
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay({self.coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay({self.coeff})"
