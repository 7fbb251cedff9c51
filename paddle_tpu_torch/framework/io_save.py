"""``save`` / ``load`` (counterpart: ``paddle_tpu/framework/io_save.py``):
a pickle of nested dicts, lists and tuples whose tensors are stored as
numpy payloads.

- A bf16 tensor is stored as its raw 16 bits (``uint16``) with the
  dtype's name, since numpy has no bf16 without ``ml_dtypes``; every
  other dtype as its own numpy array. Load gives the bits back exactly.
- :func:`load` unpickles through an unpickler that admits the payload
  class, numpy's array reconstruction and plain containers and scalars,
  nothing else: a file that names any other global is refused.
- Tensors load onto the CPU (``return_numpy=True``: numpy arrays, bf16
  as float32); the consumer moves them (``load_state_dict`` copies into
  the model's own tensors on its device).
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]


class _TensorPayload:
    def __init__(self, array, dtype, requires_grad):
        self.array = array
        self.dtype = dtype
        self.requires_grad = requires_grad


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        return _TensorPayload(arr.copy(), name, obj.requires_grad)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        if obj.dtype == "bfloat16":
            t = torch.from_numpy(obj.array.view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(obj.array)
        if return_numpy:
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy) for v in obj)
    return obj


_ALLOWED = {
    (__name__, "_TensorPayload"),
    ("numpy", "dtype"), ("numpy", "ndarray"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("builtins", "tuple"), ("builtins", "list"), ("builtins", "dict"),
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED or (
                module.startswith("numpy") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"load: the file names {module}.{name}, which is neither a "
            "tensor payload nor a plain container")


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        obj = _Unpickler(io.BytesIO(f.read())).load()
    return _unpack(obj, return_numpy)
