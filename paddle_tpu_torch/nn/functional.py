"""The trunks' elementwise functions and attention entries, in PyTorch.

Counterparts: ``paddle_tpu/nn/functional/__init__.py::rms_norm`` /
``layer_norm`` / ``gelu`` / ``dropout`` / ``scaled_dot_product_attention``,
``paddle_tpu/nn/functional/flash_attention.py::flash_attention`` /
``flash_attn_unpadded`` / ``flashmask_attention`` and
``paddle_tpu/incubate/nn/functional/__init__.py::swiglu`` /
``fused_rotary_position_embedding``. Each keeps the JAX package's
precision order so the two agree in float32 and round alike in bf16.
Random draws (dropout's mask, attention dropout's seed) come from a
``torch.Generator`` the caller passes, never from torch's global default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp.state import cast_for_op
from ..ops.flash_attention import (flash_attention,
                                   flash_attention_bshd, flashmask_attention)

__all__ = ["rms_norm", "layer_norm", "gelu", "dropout", "swiglu",
           "fused_rotary_position_embedding", "scaled_dot_product_attention",
           "flash_attention", "flash_attn_unpadded", "flashmask_attention"]


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with float32 statistics. The normalised value is cast back
    to ``x.dtype`` BEFORE the weight multiplies it, as the JAX package
    does; in bf16 that order decides the rounding."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the last ``len(normalized_shape)`` dims with float32
    mean and (biased) variance; the normalised value is cast back to
    ``x.dtype`` before the weight multiplies it and the bias is added, as
    the JAX package does."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    x32 = x.float()
    mu = x32.mean(dim=dims, keepdim=True)
    var = (x32 - mu).square().mean(dim=dims, keepdim=True)
    out = ((x32 - mu) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=True`` is the tanh form GPT uses."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout with the JAX package's modes: ``upscale_in_train`` keeps
    each element with probability 1 - p as ``x / (1 - p)``,
    ``downscale_in_infer`` keeps it as is in training and scales by 1 - p
    outside it; ``axis`` draws one keep bit per index of those dims. The
    mask comes from ``generator`` (on x's device), which a training call
    with p > 0 must give: there is no draw from the global default."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if generator is None:
        raise ValueError("dropout in training draws its mask from a "
                         "torch.Generator: pass generator=")
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, *, seed=None):
    """``[B, S, H, D]`` attention (key/value may carry fewer heads), the
    JAX package's layout: :func:`~..ops.flash_attention.
    flash_attention_bshd`, the kernels K1-K3 on the card, K6 and the
    masked arms of K2/K3 with ``attn_mask`` (bool, True = keep, or
    additive; taken without a gradient, as the JAX package detaches it);
    a bool key-padding mask ``[B, 1, 1, Sk]`` runs on the segment arms.
    Dropout in training runs the kernels' counter-hash arms at ``seed``
    (an int, which it needs). Under ``auto_cast`` float32 q, k and v are
    cast to the AMP dtype first (category ``"attention"``)."""
    query, key, value = cast_for_op((query, key, value), "attention")
    if attn_mask is not None:
        attn_mask = attn_mask.detach()
    return flash_attention_bshd(query, key, value, mask=attn_mask,
                                causal=is_causal,
                                dropout_p=dropout_p if training else 0.0,
                                seed=seed)


def _segments_of(total, cu, pad, fill):
    """Segment id of each of ``total`` packed rows (the count of interior
    boundaries ``cu[1:-1]`` at or before it), then ``pad`` rows of
    ``fill``; ``[1, total + pad]`` int32."""
    idx = torch.arange(total, device=cu.device)
    seg = (idx[:, None] >= cu[None, 1:-1]).sum(-1).to(torch.int32)
    return torch.cat([seg, seg.new_full((pad,), fill)])[None]


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, name=None, *,
                        seed=None):
    """Packed varlen attention: q/k/v ``[total, H, D]`` (k/v may carry
    fewer heads), ``cu_seqlens [B+1]``. Returns ``(out [total_q, H, D],
    None)``. As the JAX package's kernel path (``_unpadded_kernel_path``):
    the totals padded to a multiple of 128 with never-matching segment ids
    (-1 on q, -2 on k), one batch row of segments through the segment arms
    (K1 when the padded totals are equal, K6 when they differ), then the
    padding cut off. ``causal`` is per-document causal only when
    ``cu_seqlens_q is cu_seqlens_k`` (absolute positions then match); other
    causal packing raises, as do ``return_softmax`` and dropout across
    different padded totals (the JAX package runs those in XLA). Dropout
    with equal totals runs K1-K3's counter-hash arms at ``seed``."""
    if return_softmax:
        raise NotImplementedError(
            "flash_attn_unpadded(return_softmax=True) is not ported: the "
            "kernels never hold the probabilities")
    if causal and cu_seqlens_q is not cu_seqlens_k:
        raise NotImplementedError(
            "flash_attn_unpadded: causal packing with cu_seqlens_q that is "
            "not cu_seqlens_k is not ported (absolute positions would not "
            "be per-document positions; the JAX package runs it in XLA)")
    q, k, v = query, key, value
    tq, tk = q.shape[0], k.shape[0]
    pq, pk = (-tq) % 128, (-tk) % 128
    cq = torch.as_tensor(cu_seqlens_q, device=q.device)
    ck = torch.as_tensor(cu_seqlens_k, device=k.device)
    sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    out = flash_attention_bshd(
        F.pad(q, (0, 0, 0, 0, 0, pq))[None],
        F.pad(k, (0, 0, 0, 0, 0, pk))[None],
        F.pad(v, (0, 0, 0, 0, 0, pk))[None], causal=causal, scale=sc,
        q_seg=_segments_of(tq, cq, pq, -1), kv_seg=_segments_of(tk, ck, pk, -2),
        dropout_p=dropout, seed=seed)
    return out[0, :tq], None
