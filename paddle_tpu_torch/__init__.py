"""paddle_tpu_torch: the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package
rebuilds it slice by slice in PyTorch for an NVIDIA H100, with every
Pallas kernel on a slice's path written again by hand for Hopper
(CUDA C++ for ``sm_90a``). It imports neither JAX nor ``paddle_tpu``.

Device policy: every entry point runs on the CUDA card unless the caller
passes ``device="cpu"``; without a card it raises rather than fall back
to the host (:mod:`.device`).

Slices so far:

- serving: :class:`~.serving.ServingEngine` over
  :class:`~.models.LlamaForCausalLM`, with the ragged paged-attention
  kernel in ``serving/csrc/ragged_paged_attention.cu``;
- training: :class:`~.hapi.Model` over the LLaMA with
  :class:`~.models.LlamaPretrainingCriterion` and
  :class:`~.optimizer.AdamW`, with the flash-attention kernels in
  ``ops/csrc/flash_attention.cu`` and the multi-tensor AdamW kernel in
  ``ops/csrc/adamw.cu``;
- pretraining as users run it: ``Model.fit`` / ``evaluate`` /
  ``predict`` / ``save`` / ``load`` over :mod:`.io`'s ``DataLoader``,
  with :mod:`.amp`, the clips of :mod:`.nn`, the schedules of
  :mod:`.optimizer.lr`, :mod:`.regularizer`, :mod:`.metric`,
  :mod:`.hapi.callbacks` and recompute (:mod:`.distributed.fleet`);
- the rest of training around that step: the other optimizers of
  :mod:`.optimizer` (one ``torch._foreach_*`` pass a step on the card,
  and LBFGS), recompute's ``full_attn`` and ``offload`` forms,
  ``DataLoader`` workers and the rest of :mod:`.io`, and
  :mod:`.hapi.summary`'s ``summary`` and ``flops``.
"""
from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
