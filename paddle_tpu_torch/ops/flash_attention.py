"""Differentiable flash attention over the K1-K3 and K6 kernels
(counterpart: ``paddle_tpu/ops/pallas/flash_attention.py``).

- :func:`flash_attention_bshd` — ``[B, Sq, H, D]`` attention (k/v at
  ``[B, Sk, HKV, D]``: GQA runs natively in the kernels), with an
  optional mask (bool, True = keep, or additive), segment ids and
  attention dropout. Its gradient is a ``torch.autograd.Function`` whose
  forward saves the lse (and the dropout seed) and whose backward is K2 +
  K3 (the JAX package's ``_flash_core_ext`` / ``_ext_fwd`` / ``_ext_bwd``
  and ``_flash_core_drop`` / ``_drop_fwd`` / ``_drop_bwd`` in one). A bool
  key-padding mask ``[B, 1, 1, Sk]`` becomes segment ids (keys 0 / -2,
  queries 0), as in the JAX package.
- :func:`flash_attention` — ``paddle.nn.functional.flash_attention``.
- :func:`flash_core_lse` — the same function that also returns the row
  lse ``[B, H, Sq]`` and takes its cotangent (the ``dlse`` fold), for
  ring attention.
- :func:`flashmask_attention` — PaddleNLP's FlashMask: the compact
  ``startend_row_indices [B, H|1, Sk, 1|2|4]`` column bounds, the
  sliding window folded into them, through :func:`_flash_core_fm` /
  :func:`flash_core_fm_lse` (K6 forward, the banded arms of K2/K3).
- :func:`_attention_ref` / :func:`_attention_ref_lse` /
  :func:`_attention_ref_hash_dropout` — the plain oracles, as in the JAX
  package.

A mask, a band or ``Sq != Sk`` sends the forward to K6 and the backward
to the masked arms of K2/K3; the rest runs K1-K3, segment ids in their
segment arms. On CPU tensors every call takes the kernels' plain versions;
on CUDA tensors it launches the kernels or raises (:mod:`.fa_kernel`).

Dropout: wherever the JAX kernels take it (``0 < p < 1``, no dense mask
or FlashMask, ``Sq == Sk``, no returned probabilities) dropout runs the
counter-hash arms of K1-K3 (``fa_kernel.keep_scale``) at the caller's
``seed`` (an int; ``models.gpt`` draws one per layer and training forward
from its own generator), which a training call must give: there is no
draw from a global default. The JAX package keeps that
arm behind ``PADDLE_TPU_FA_KERNEL_DROPOUT`` and otherwise draws a threefry
mask in XLA, which torch cannot reproduce; the port has no switch. The
cases outside the kernels' reach (dropout with a mask, FlashMask or
``Sq != Sk``; returned probabilities) raise ``NotImplementedError`` naming
what is missing; they are never densified or sent to a plain version.
"""
from __future__ import annotations

import torch

from . import fa_kernel
from .fa_kernel import fa_backward, fa_forward

__all__ = ["flash_attention_bshd", "flash_attention", "flash_core_lse",
           "flashmask_attention", "flash_core_fm_lse",
           "dispatch_stats", "reset_dispatch_stats"]

_INT32_MAX = 2 ** 31 - 1


def dispatch_stats():
    """Counts since the last reset: K1/K6/K2/K3 launches and plain-version
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


def _attention_ref_hash_dropout(q, k, v, seed, p, causal=True, q_seg=None,
                                kv_seg=None):
    """The parity definition of the counter-hash dropout (the JAX
    package's namesake): plain attention with the keep mask rebuilt from
    ``fa_kernel.keep_scale``, the dropped probabilities times float32 V,
    cast to q's dtype. It scales the scores by ``1/sqrt(D)`` only, as the
    JAX oracle does."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (
        dh ** 0.5)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if q_seg is not None:
        qs, ks = q_seg[:, None, :, None], kv_seg[:, None, None, :]
        logits = logits.masked_fill(~((qs == ks) & (qs >= 0) & (ks >= 0)),
                                    float("-inf"))
    probs = torch.softmax(logits, -1).nan_to_num(0.0)
    ks = fa_kernel.keep_bhqk(seed, b, h, sq, sk, p, q.device)
    return torch.einsum("bhqk,bkhd->bqhd", probs * ks,
                        v.float()).to(q.dtype)


def _attention_ref_lse(q, k, v, causal=False, scale=None, mask=None):
    """Plain ``(out, lse [B,H,Sq] f32)`` with an optional additive mask
    ``[B|1, H|1, Sq, Sk]`` (a dead row gives out 0 and lse -inf): the
    oracle K1 and K6 are held against
    (:func:`.fa_kernel.fa_forward_plain`)."""
    return fa_kernel.fa_forward_plain(q, k, v, causal=causal, scale=scale,
                                      return_lse=True, mask=mask)


def _fm_kw(fm):
    """The band tuple ``(start, end[, start2, end2])`` as fa_forward's
    keywords."""
    return dict(zip(("fm_start", "fm_end", "fm_start2", "fm_end2"), fm))


class _FlashCore(torch.autograd.Function):
    """``(out, lse)``: K1 forward, or K6 with a mask, bands or Sq != Sk;
    backward K2 + K3 (in the same arms) with the lse's cotangent folded
    into delta (none when only ``out`` is used). The segment ids and the
    dropout seed (an int) are saved with the lse, so the backward redraws
    the forward's keep mask. The mask, the bands and the segment ids take
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mask, q_seg, kv_seg, dropout_p,
                seed, *fm):
        ctx.set_materialize_grads(False)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = fa_forward(q, k, v, causal=causal, scale=scale,
                              return_lse=True, mask=mask, q_seg=q_seg,
                              kv_seg=kv_seg, dropout_p=dropout_p, seed=seed,
                              **_fm_kw(fm))
        ctx.save_for_backward(q, k, v, out, lse, mask, q_seg, kv_seg, *fm)
        ctx.causal, ctx.scale = causal, scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, mask, q_seg, kv_seg, *fm = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv = fa_backward(
            q, k, v, out, lse, g_out.contiguous(), causal=ctx.causal,
            scale=ctx.scale,
            dlse=g_lse.contiguous() if g_lse is not None else None,
            mask=mask, q_seg=q_seg, kv_seg=kv_seg, dropout_p=ctx.dropout_p,
            seed=ctx.seed, **_fm_kw(fm))
        return (dq, dk, dv) + (None,) * (7 + len(fm))


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _attend(q, k, v, causal, scale, mask=None, fm=(), want_lse=False,
            q_seg=None, kv_seg=None, dropout_p=0.0, seed=None):
    """The one entry into the kernels: with a gradient to take through
    :class:`_FlashCore`, else the forward alone (no lse is written unless
    asked for)."""
    fm = tuple(x for x in fm if x is not None)
    if _needs_grad(q, k, v):
        out, lse = _FlashCore.apply(q, k, v, causal, scale, mask, q_seg,
                                    kv_seg, dropout_p, seed, *fm)
        return (out, lse) if want_lse else out
    return fa_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, scale=scale, return_lse=want_lse,
                      mask=mask, q_seg=q_seg, kv_seg=kv_seg,
                      dropout_p=dropout_p, seed=seed, **_fm_kw(fm))


def _normalize_mask(m, b, h, sq, sk):
    """A full mask as K6 takes it: additive float32 ``[B|1, H|1, Sq, Sk]``
    (the JAX package's ``_normalize_mask``). A 2-D ``[Sq, Sk]`` or 3-D
    ``[B, Sq, Sk]`` mask gains its missing dims, a bool one becomes 0 /
    -inf. A mask broadcast over Sq or Sk is not materialised (the JAX
    package sends it to its reference for that reason): it is expanded as
    a stride-0 view, and K6 reads the mask through its strides."""
    if m.dim() == 2:
        m = m[None, None]
    elif m.dim() == 3:
        m = m[:, None]
    if (m.dim() != 4 or m.shape[0] not in (1, b) or m.shape[1] not in (1, h)
            or m.shape[2] not in (1, sq) or m.shape[3] not in (1, sk)):
        raise ValueError(f"attention mask of shape {tuple(m.shape)} does "
                         f"not broadcast to [B={b}, H={h}, Sq={sq}, "
                         f"Sk={sk}]")
    if m.dtype == torch.bool:
        m = torch.zeros(m.shape, dtype=torch.float32,
                        device=m.device).masked_fill(~m, float("-inf"))
    else:
        m = m.float()
    return m.expand(m.shape[0], m.shape[1], sq, sk)


def _refuse_dropout(dropout_p, why):
    if why:
        raise NotImplementedError(
            f"flash attention in paddle_tpu_torch does not port dropout_p="
            f"{dropout_p} with {why}: the counter-hash dropout arms of "
            "K1-K3 take no dense mask, no FlashMask and no Sq != Sk (the "
            "JAX package runs those cases in XLA with a threefry mask)")


def flash_attention_bshd(q, k, v, mask=None, causal=False, dropout_p=0.0,
                         scale=None, q_seg=None, kv_seg=None,
                         return_probs=False, *, seed=None):
    """``[B, Sq, H, D]`` attention, k/v at ``[B, Sk, HKV, D]``. ``mask``
    is bool (True = keep) or additive, of any shape that broadcasts to
    ``[B, H, Sq, Sk]`` over its leading dims (the JAX package's mask
    branch); it and ``Sq != Sk`` run on K6. A bool key-padding mask
    ``[B, 1, 1, Sk]`` without segment ids becomes them (keys 0 where kept
    and -2 elsewhere, queries 0), as in the JAX package. ``q_seg`` /
    ``kv_seg`` int ``[B, Sq]`` / ``[B, Sk]``: packed segment ids (a
    negative id matches nothing). ``dropout_p`` in (0, 1) drops attention
    links through the kernels' counter hash at ``seed`` (an int, which
    dropout needs). Without a gradient to take, only the forward runs (no
    lse is written)."""
    if return_probs:
        raise NotImplementedError(
            "flash attention in paddle_tpu_torch does not port return_probs "
            "(return_softmax): the kernels never hold the [Sq, Sk] "
            "probabilities")
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    marr = None
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg must both be given or both be "
                         "None")
    if mask is not None:
        if (mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
                and mask.dtype == torch.bool and q_seg is None):
            keep = mask[:, 0, 0, :].expand(b, sk)
            kv_seg = torch.where(keep, 0, -2).to(torch.int32)
            q_seg = torch.zeros(b, sq, dtype=torch.int32, device=q.device)
        else:
            marr = _normalize_mask(mask, b, h, sq, sk)
    if dropout_p:
        if not 0.0 < dropout_p < 1.0:
            raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
        _refuse_dropout(dropout_p, "a dense attention mask"
                        if marr is not None else
                        f"Sq={sq} != Sk={sk}" if sq != sk else None)
        if seed is None:
            raise ValueError("attention dropout draws its keep mask from a "
                             "counter hash at seed=: pass seed= (an int)")
        return _attend(q, k, v, causal, scale, q_seg=q_seg, kv_seg=kv_seg,
                       dropout_p=float(dropout_p), seed=seed)
    return _attend(q, k, v, causal, scale, mask=marr, q_seg=q_seg,
                   kv_seg=kv_seg)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, *, seed=None):
    """``paddle.nn.functional.flash_attention``: ``(out, None)``; dropout
    only in training, at ``seed`` (an int, which it needs).
    ``return_softmax`` raises (the kernels never hold the probabilities),
    and so do ``fixed_seed_offset`` / ``rng_name``, which the JAX package
    accepts and never reads."""
    if fixed_seed_offset is not None or rng_name:
        raise NotImplementedError(
            "flash_attention(fixed_seed_offset=, rng_name=) is not ported: "
            "the dropout seed comes from seed=")
    drop_p = dropout if training else 0.0
    return flash_attention_bshd(query, key, value, causal=causal,
                                dropout_p=drop_p,
                                return_probs=return_softmax,
                                seed=seed), None


def flash_core_lse(q, k, v, causal, scale):
    """``(out [B,Sq,H,D], lse [B,H,Sq] f32)``, differentiable in both."""
    return _attend(q, k, v, causal, scale, want_lse=True)


# -- FlashMask: compact column bounds at O(Sk) memory -------------------------

def _flash_core_fm(q, k, v, fm_start, fm_end, fm_start2, fm_end2, causal,
                   scale):
    """FlashMask attention: K6 forward (its lse saved when a gradient is
    taken), the banded K2 + K3 backward."""
    return _attend(q, k, v, causal, scale,
                   fm=(fm_start, fm_end, fm_start2, fm_end2))


def flash_core_fm_lse(q, k, v, fm_start, fm_end, fm_start2, fm_end2, causal,
                      scale):
    """``(out, lse)`` of :func:`_flash_core_fm`, differentiable in both
    (the lse's cotangent folds into delta)."""
    return _attend(q, k, v, causal, scale,
                   fm=(fm_start, fm_end, fm_start2, fm_end2), want_lse=True)


def _normalize_startend(startend_row_indices, sk):
    """PaddleNLP's FlashMask layout ``[B, H|1, Sk, C]`` int32 → (start,
    end[, start2, end2]) ``[B, H|1, Sk]`` row bands. C=1: rows [start_j,
    Sq) masked (the causal document form); C=2: the [start_j, end_j)
    band; C=4: two bands, [LTS, LTE) below and [UTS, UTE) above."""
    idx = startend_row_indices
    if idx.dim() != 4 or idx.shape[2] != sk or idx.shape[3] not in (1, 2, 4):
        raise ValueError(
            "startend_row_indices must be [B, H|1, Sk, 1|2|4] int32, "
            f"got {tuple(idx.shape)}")
    start = idx[..., 0].to(torch.int32)
    if idx.shape[3] == 1:
        return (start, torch.full_like(start, _INT32_MAX))
    end = idx[..., 1].to(torch.int32)
    if idx.shape[3] == 2:
        return (start, end)
    return (start, end, idx[..., 2].to(torch.int32),
            idx[..., 3].to(torch.int32))


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=True, window_size=None,
                        return_softmax_lse=False, fixed_seed_offset=None,
                        rng_name="", training=True, name=None):
    """``paddle.nn.functional.flashmask_attention``: attention with a
    compact column-wise mask (``[B, H|1, Sk, 1|2|4]`` int32 query-row
    bounds a key column; O(Sk) memory) instead of a dense one: C=1 the
    causal document start, C=2 one [start, end) band, C=4 two bands.
    ``window_size`` w (an int, or its first entry) is sliding-window
    causal attention, each query seeing itself and the w keys before it;
    it folds into the bounds: alone as one band, into a C=1 index by a
    column-wise min, and with a C=2 index as the second band of the C=4
    form. Returns ``out`` or, with ``return_softmax_lse``, ``(out,
    lse)``. Dropout in training (and its ``fixed_seed_offset`` /
    ``rng_name``) raises: the kernels' dropout arms take no band."""
    q, k, v = query, key, value
    sk = k.shape[1]
    drop_p = dropout if training else 0.0
    if drop_p or fixed_seed_offset is not None or rng_name:
        raise NotImplementedError(
            "flashmask_attention in paddle_tpu_torch does not port dropout "
            "(fixed_seed_offset / rng_name seed it): the counter-hash "
            "dropout arms of K1-K3 take no FlashMask band (the JAX package "
            "runs it in XLA with a threefry mask)")
    fm = None
    raw = startend_row_indices
    if raw is not None:
        fm = list(_normalize_startend(raw, sk))
    win_rows = None
    if window_size is not None:
        if not causal:
            raise NotImplementedError(
                "flashmask_attention window_size requires causal=True "
                "(the reference's sliding-window form)")
        w = window_size[0] if isinstance(window_size, (tuple, list)) \
            else int(window_size)
        if w >= 0:      # -1 / (-1, -1) = disabled
            # bottom-right-aligned (offset = sk - sq): key j is visible to
            # query row i iff i + offset - w <= j <= i + offset, so column
            # j masks rows >= j + w + 1 - offset
            offset = sk - q.shape[1]
            win_rows = torch.clamp(
                torch.arange(sk, dtype=torch.int32, device=k.device)
                + w + 1 - offset, min=0)[None, None, :]
    if win_rows is not None:
        if fm is None:
            fm = [win_rows, torch.full_like(win_rows, _INT32_MAX)]
        elif len(fm) == 2 and raw.shape[3] == 1:
            fm[0] = torch.minimum(fm[0], win_rows)
        elif len(fm) == 2:
            fm += [win_rows.expand(fm[0].shape).contiguous(),
                   torch.full_like(fm[0], _INT32_MAX)]
        else:
            raise NotImplementedError(
                "flashmask_attention: window_size composes with C=1 or "
                "C=2 startend_row_indices (folded to min-start / the "
                "C=4 two-band form); C=4 already carries two bands and "
                "cannot take a third")
    if fm is None:
        if return_softmax_lse:
            return flash_core_lse(q, k, v, causal, None)
        return flash_attention_bshd(q, k, v, causal=causal)
    b, h = q.shape[0], q.shape[2]
    if fm[0].shape[0] not in (1, b) or fm[0].shape[1] not in (1, h):
        raise ValueError(
            f"startend_row_indices batch/head dims "
            f"{tuple(fm[0].shape[:2])} incompatible with q "
            f"[B={b}, H={h}]")
    fm = tuple(fm) + (None,) * (4 - len(fm))
    if return_softmax_lse:
        return flash_core_fm_lse(q, k, v, *fm, causal, None)
    return _flash_core_fm(q, k, v, *fm, causal, None)
