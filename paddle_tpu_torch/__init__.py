"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package
rebuilds it slice by slice in PyTorch for an NVIDIA H100, with every
Pallas kernel on a slice's path written again by hand for Hopper
(CUDA C++ for ``sm_90a``). It imports neither JAX nor ``paddle_tpu``.

Device policy: every entry point runs on the CUDA card unless the caller
passes ``device="cpu"``; without a card it raises rather than fall back
to the host (:mod:`.device`).

The first slice is serving: :class:`~.serving.ServingEngine` over
:class:`~.models.LlamaForCausalLM`, with the ragged paged-attention
kernel in ``serving/csrc/ragged_paged_attention.cu``.
"""
from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
