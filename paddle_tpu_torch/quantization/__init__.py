"""Quantization: QAT and PTQ (counterpart: ``paddle_tpu/quantization``).

``QuantConfig`` picks layers and quanters; ``QAT(config).quantize(model)``
inserts fake-quant layers (:func:`fake_quant`, a clipped
straight-through estimator) and ``convert()`` freezes them into plain
``Linear`` layers; ``PTQ(config).quantize(model)`` inserts observers
(``AbsmaxObserver``, ``EMAObserver``) and ``convert()`` produces
:class:`QuantizedInferenceLinear` layers with int8 weights, whose
products run through the hand-written K7 on the card. For ``Linear``
only: the conv layers (``QuantedConv2D``) wait for ``vision/``.
"""
from .config import QuantConfig
from .observers import AbsmaxObserver, BaseObserver, EMAObserver
from .ptq import PTQ, QuantizedInferenceLinear
from .qat import QAT, QuantedLinear
from .quanters import (FakeQuanterChannelWiseAbsMax,
                       FakeQuanterWithAbsMaxObserver, fake_quant)

__all__ = [
    "QuantConfig", "QAT", "PTQ",
    "BaseObserver", "AbsmaxObserver", "EMAObserver",
    "FakeQuanterWithAbsMaxObserver", "FakeQuanterChannelWiseAbsMax",
    "fake_quant", "QuantedLinear", "QuantizedInferenceLinear",
]
