"""PTQ observers: identity layers that record the absmax of what passes
through and later report a quantization scale (counterpart:
``paddle_tpu/quantization/observers.py``). Each observation reads one
number to the host, as the JAX package's does."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["BaseObserver", "AbsmaxObserver", "EMAObserver"]


class BaseObserver(nn.Module):
    """Identity layer that records statistics of what passes through."""

    def __init__(self, bit_length=8):
        super().__init__()
        self._bit_length = bit_length

    def forward(self, x):
        self._observe(float(x.detach().abs().max()))
        return x

    def _observe(self, absmax: float):
        raise NotImplementedError

    def cal_thresholds(self):
        pass

    def scales(self):
        raise NotImplementedError

    def quant_axis(self):
        return None

    def bit_length(self):
        return self._bit_length


class AbsmaxObserver(BaseObserver):
    """scale = max |x| over all calibration batches."""

    def __init__(self, bit_length=8):
        super().__init__(bit_length)
        self._max = 1e-9

    def _observe(self, absmax):
        self._max = max(self._max, float(absmax))

    def scales(self):
        return torch.tensor(self._max, dtype=torch.float32)


class EMAObserver(BaseObserver):
    """Exponential-moving-average absmax (smoother for spiky
    activations)."""

    def __init__(self, bit_length=8, moving_rate=0.9):
        super().__init__(bit_length)
        self._moving_rate = moving_rate
        self._ema = None

    def _observe(self, absmax):
        v = float(absmax)
        self._ema = v if self._ema is None else (
            self._moving_rate * self._ema + (1 - self._moving_rate) * v)

    def scales(self):
        return torch.tensor(max(self._ema or 1e-9, 1e-9),
                            dtype=torch.float32)
