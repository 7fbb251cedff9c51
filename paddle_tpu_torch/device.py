"""Device policy of the port: every entry point runs on the CUDA card
unless the caller asks for the CPU (``device="cpu"``, as the tests do).

Without a card and without ``device="cpu"`` an entry point raises; it
never drops quietly to the CPU, so a run that reports device numbers
cannot have measured the host instead.
"""
from __future__ import annotations

import torch

__all__ = ["dtype_name", "resolve_device", "resolve_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32, "int64": torch.int64}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (the current CUDA device); anything else
    is taken as given, a CUDA device with its index filled in so that
    devices compare equal. A CUDA device on a machine without one
    raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the host")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """Map a dtype name of the JAX package ("float32", "bfloat16",
    "float16", "int8", "int32", "int64") or a ``torch.dtype`` to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}: use one of "
            f"{sorted(_DTYPES)}") from None


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype (``"bfloat16"``, never
    ``"torch.bfloat16"``): what geometry dicts and wire headers carry."""
    dt = resolve_dtype(dtype)
    for name, d in _DTYPES.items():
        if d == dt:
            return name
    raise ValueError(f"no name for dtype {dtype!r}")  # pragma: no cover
