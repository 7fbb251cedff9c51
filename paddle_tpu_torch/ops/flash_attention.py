"""Differentiable flash attention over the K1-K3 kernels (counterpart:
``paddle_tpu/ops/pallas/flash_attention.py``).

- :func:`flash_attention_bshd` — ``[B, S, H, D]`` attention (k/v may carry
  fewer heads: GQA runs natively in the kernels). Its gradient is a
  ``torch.autograd.Function`` whose forward saves the lse and whose
  backward is K2 + K3 (the JAX package's ``_flash_core_ext`` /
  ``_ext_fwd`` / ``_ext_bwd``).
- :func:`flash_core_lse` — the same function that also returns the row
  lse ``[B, H, S]`` and takes its cotangent (the ``dlse`` fold), for
  ring attention.
- :func:`_attention_ref` / :func:`_attention_ref_lse` — the plain
  oracles, as in the JAX package.

On CPU tensors every call takes the kernels' plain versions; on CUDA
tensors it launches the kernels or raises (:mod:`.fa_kernel`). The arms
this slice does not port — an attention mask, segment ids, dropout,
returned probabilities, ``Sq != Sk`` — raise ``NotImplementedError``
naming what is missing; they are never sent to a plain version.
"""
from __future__ import annotations

import torch

from . import fa_kernel
from .fa_kernel import fa_backward, fa_forward

__all__ = ["flash_attention_bshd", "flash_core_lse", "dispatch_stats",
           "reset_dispatch_stats"]


def dispatch_stats():
    """Counts since the last reset: K1/K2/K3 launches and plain-version
    calls (``fa_kernel.stats``)."""
    return dict(fa_kernel.stats)


def reset_dispatch_stats():
    fa_kernel.reset_stats()


def _attention_ref(q, k, v, mask=None, causal=False, scale=None):
    """Plain attention. q [B,S,H,D]; k/v may carry fewer (GQA) heads,
    repeated here. Scores in float32; ``mask`` is bool (True = keep) or
    additive; rows with no live key come out 0; the probabilities are
    cast to q's dtype before the product with V."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * s
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention_ref_lse(q, k, v, causal=False, scale=None):
    """Plain ``(out, lse [B,H,S] f32)``: the oracle K1 is held against
    (:func:`.fa_kernel.fa_forward_plain`)."""
    return fa_kernel.fa_forward_plain(q, k, v, causal=causal, scale=scale,
                                      return_lse=True)


class _FlashCore(torch.autograd.Function):
    """``(out, lse)``: K1 forward; backward K2 + K3 with the lse's
    cotangent folded into delta (none when only ``out`` is used)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = fa_forward(q, k, v, causal=causal, scale=scale,
                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = fa_backward(
            q, k, v, out, lse, g_out.contiguous(), causal=ctx.causal,
            scale=ctx.scale,
            dlse=g_lse.contiguous() if g_lse is not None else None)
        return dq, dk, dv, None, None


def _refuse(mask, dropout_p, q_seg, kv_seg, return_probs, q, k):
    missing = []
    if mask is not None:
        missing.append("an attention mask (the streamed forward K6 and "
                       "the mask arms of K2/K3)")
    if q_seg is not None or kv_seg is not None:
        missing.append("segment ids (the segment arms of K1-K3)")
    if dropout_p:
        missing.append(f"dropout_p={dropout_p} (the in-kernel "
                       "_keep_scale dropout arms of K1-K3)")
    if return_probs:
        missing.append("return_probs")
    if k.shape[1] != q.shape[1]:
        missing.append(f"Sq={q.shape[1]} != Sk={k.shape[1]} (the "
                       "streamed forward K6)")
    if missing:
        raise NotImplementedError(
            "flash attention in paddle_tpu_torch does not port "
            + "; ".join(missing) + " yet")


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention_bshd(q, k, v, mask=None, causal=False, dropout_p=0.0,
                         scale=None, q_seg=None, kv_seg=None,
                         return_probs=False):
    """``[B, S, H, D]`` attention, k/v at ``[B, S, HKV, D]``. Without a
    gradient to take, only the forward runs (no lse is written)."""
    _refuse(mask, dropout_p, q_seg, kv_seg, return_probs, q, k)
    if _needs_grad(q, k, v):
        return _FlashCore.apply(q, k, v, causal, scale)[0]
    return fa_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, scale=scale)


def flash_core_lse(q, k, v, causal, scale):
    """``(out [B,S,H,D], lse [B,H,S] f32)``, differentiable in both."""
    _refuse(None, 0.0, None, None, False, q, k)
    if _needs_grad(q, k, v):
        return _FlashCore.apply(q, k, v, causal, scale)
    return fa_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, scale=scale, return_lse=True)
