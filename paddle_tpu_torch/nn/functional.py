"""The LLaMA trunk's elementwise functions, in PyTorch.

Counterparts: ``paddle_tpu/nn/functional/__init__.py::rms_norm`` and
``paddle_tpu/incubate/nn/functional/__init__.py::swiglu`` /
``fused_rotary_position_embedding``. Each keeps the JAX package's
precision order so the two agree in float32 and round alike in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "swiglu", "fused_rotary_position_embedding"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with float32 statistics. The normalised value is cast back
    to ``x.dtype`` BEFORE the weight multiplies it, as the JAX package
    does; in bf16 that order decides the rounding."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


def swiglu(x, y=None):
    """``silu(x) * y``; with ``y=None`` the last dim of ``x`` is split in
    half (gate, up)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def fused_rotary_position_embedding(q, k=None, *, position_ids,
                                    rotary_emb_base=10000.0):
    """Neox-style (half-split) RoPE on ``[B, S, H, D]`` tensors. The
    angles come straight from ``position_ids`` ``[B, S]`` in float32, so
    any position is valid (no table to run past). Returns ``(q, k)`` in
    their input dtypes; ``k=None`` passes through."""
    d = q.shape[-1]
    inv = 1.0 / (rotary_emb_base ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    freqs = position_ids.to(torch.float32)[..., None] * inv  # [B, S, D/2]
    sin = torch.sin(freqs)[:, :, None, :]
    cos = torch.cos(freqs)[:, :, None, :]

    def rope(x):
        xf = x.float()
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rope(q), (rope(k) if k is not None else None)
