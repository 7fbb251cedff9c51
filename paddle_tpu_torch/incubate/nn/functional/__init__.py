"""``paddle.incubate.nn.functional``'s fused rotary embedding (counterpart:
``paddle_tpu/incubate/nn/functional/__init__.py::
fused_rotary_position_embedding``), whole: q, k and v, angles from
``position_ids`` or from ``sin``/``cos`` tables (half- or full-width,
gathered by ``position_ids`` or taken by sequence position), the neox
(half-split) and the interleaved style, and ``position_ids=None``. No
Pallas kernel stands behind it in the JAX package (one XLA fusion), so
it is plain PyTorch. The models call the neox form from positions in
:func:`paddle_tpu_torch.nn.functional.fused_rotary_position_embedding`.
"""
from __future__ import annotations

import torch

__all__ = ["fused_rotary_position_embedding"]


def _inv_freq(d, base, device):
    return 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d))


def _angles(x, sin, cos, position_ids, base):
    """``(sin, cos)`` broadcastable to ``[B, S, H, D/2]`` float32 for x
    ``[B, S, H, D]``, as the JAX package picks them: from the position
    ids directly (no table, any position valid), from the sequence
    positions 0..S-1, or from the given tables (their last two dims
    ``[S_table, D or D/2]``; full-width tables give their first half),
    gathered by the position ids when given."""
    d = x.shape[-1]
    if sin is None and position_ids is not None:
        f = position_ids.to(torch.float32)[..., None] * _inv_freq(
            d, base, x.device)
        return torch.sin(f)[:, :, None], torch.cos(f)[:, :, None]
    if sin is None:
        f = torch.arange(x.shape[1], dtype=torch.float32,
                         device=x.device)[:, None] * _inv_freq(d, base,
                                                               x.device)
        return torch.sin(f)[None, :, None], torch.cos(f)[None, :, None]
    sin = sin.reshape(sin.shape[-2], sin.shape[-1])
    cos = cos.reshape(cos.shape[-2], cos.shape[-1])
    if sin.shape[-1] == d:
        sin, cos = sin[..., :d // 2], cos[..., :d // 2]
    if position_ids is not None:
        pos = position_ids.long()
        return sin[pos][:, :, None], cos[pos][:, :, None]
    return sin[None, :, None], cos[None, :, None]


def _rope(x, sin, cos, neox):
    xf = x.float()
    if neox:
        d = x.shape[-1]
        x1, x2 = xf[..., :d // 2], xf[..., d // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    rotary_emb_base=10000.0, name=None):
    """RoPE on q, k and v ``[B, S, H, D]`` (each may be None, passed
    through), in float32, each cast back to its dtype. Returns ``(q, k,
    v)``."""
    return tuple(
        None if t is None else _rope(
            t, *_angles(t, sin, cos, position_ids, rotary_emb_base),
            use_neox_rotary_style)
        for t in (q, k, v))
