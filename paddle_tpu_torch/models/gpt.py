"""GPT-3 family (counterpart: ``paddle_tpu/models/gpt.py``): learned
positions, pre-LN blocks, a tanh-GELU MLP, biased linears, hidden and
attention dropout, an untied or tied LM head.

Module names mirror the JAX package (``gpt.h.0.attn.qkv_proj`` ...) so
weights carry across key for key (``models/convert.py``).

Attention runs through ``scaled_dot_product_attention`` (causal): K1-K3
on the card, a bool key-padding ``attn_mask [B, 1, 1, S]`` (right-padded
rows) on their segment arms, attention dropout in training on their
counter-hash arms; ``attn_mask_startend_row_indices`` (FlashMask) runs
through ``flashmask_attention`` (K6) with attention dropout off.

Randomness: :class:`GPTForCausalLM` owns one ``torch.Generator`` on its
device, seeded with ``seed``. It draws the weights (N(0, 0.02) for every
Linear and Embedding weight, biases 0, LayerNorms 1 and 0), then every
hidden-dropout mask and, at the start of each training forward, one
attention-dropout seed per layer (int32 in [0, 2**31 - 1), fetched in one
device-to-host copy). The same seed and inputs thus give the same run.

``recompute`` (training only) runs each block under
:func:`..distributed.fleet.recompute`, which replays the block's dropout
masks from the model's generator in backward.

``generate()`` (``models/generation.py``) runs the ``forward_cached``
path: fused qkv, no RoPE, learned positions at ``offset + arange(S)``,
attention through ``cached_attention`` (K5 on the card). The cache is
kept in the model's dtype: the JAX package builds GPT's cache in float32
even for a bf16 model, but a bf16 K/V widened to float32 is exact, so a
bf16 cache holds the same values (and K5's tile form takes bf16 pages).

Not ported, and refused: ``tensor_parallel`` and the pipeline form
``GPTForCausalLMPipe``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..distributed.fleet.recompute import recompute
from ..nn import Dropout, LayerNorm, Linear
from ..nn.functional import (flashmask_attention, gelu,
                             scaled_dot_product_attention)
from .generation import (CachePlan, GenerationMixin, cached_attention,
                         init_static_caches)

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTForCausalLMPipe", "count_params",
           "flops_per_token"]

_SEED_HIGH = 2 ** 31 - 1


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int | None = None
    max_position_embeddings: int = 2048
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    tensor_parallel: bool = False
    recompute: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt3_1_3b(**kw):
        return GPTConfig(**{**dict(hidden_size=2048, num_hidden_layers=24,
                                   num_attention_heads=16), **kw})

    @staticmethod
    def tiny(**kw):
        return GPTConfig(**{**dict(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            hidden_dropout_prob=0.0, attention_dropout_prob=0.0), **kw})


def _check_slice(cfg):
    """Refuse the flags this port does not implement yet."""
    for name in ("tensor_parallel",):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"GPTConfig.{name} is not ported to paddle_tpu_torch yet")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"GPTConfig.dtype={cfg.dtype!r}: use 'float32' or "
                         "'bfloat16'")


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.num_attention_heads
        self.hd = h // self.nh
        self.drop = cfg.attention_dropout_prob
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)

    def forward(self, x, attn_mask=None, startend_row_indices=None,
                seed=None):
        """Causal attention over the whole sequence; ``seed`` is this
        call's attention-dropout seed (training with dropout only)."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.nh, self.hd)
        q, k, v = qkv.unbind(dim=2)
        if startend_row_indices is not None:
            if attn_mask is not None:
                raise ValueError(
                    "attn_mask and attn_mask_startend_row_indices are "
                    "mutually exclusive")
            out = flashmask_attention(
                q, k, v, startend_row_indices=startend_row_indices,
                dropout=self.drop, causal=True, training=self.training)
        else:
            out = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=True,
                dropout_p=self.drop, training=self.training, seed=seed)
        return self.out_proj(out.reshape(b, s, self.nh * self.hd))

    def forward_cached(self, x, k_buf, v_buf, plan):
        """The static-cache path of ``generate``: fused qkv, no RoPE,
        :func:`~.generation.cached_attention` under the forward's
        :class:`~.generation.CachePlan`, out_proj."""
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.nh, self.hd)
        q, k, v = qkv.unbind(dim=2)
        out, k_buf, v_buf = cached_attention(
            q.contiguous(), k, v, k_buf, v_buf, plan,
            1.0 / (self.hd ** 0.5))
        return (self.out_proj(out.reshape(b, s, self.nh * self.hd)), k_buf,
                v_buf)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, generator, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.fc_in = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc_out = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.drop = Dropout(cfg.hidden_dropout_prob, generator=generator)

    def forward(self, x, attn_mask=None, startend_row_indices=None,
                attn_seed=None):
        if self.cfg.recompute and self.training:
            return recompute(self._block, x, attn_mask,
                             startend_row_indices, attn_seed)
        return self._block(x, attn_mask, startend_row_indices, attn_seed)

    def _block(self, x, attn_mask=None, startend_row_indices=None,
               attn_seed=None):
        x = x + self.drop(self.attn(
            self.ln_1(x), attn_mask=attn_mask,
            startend_row_indices=startend_row_indices, seed=attn_seed))
        return x + self.drop(self.fc_out(gelu(self.fc_in(self.ln_2(x)),
                                              approximate=True)))

    def forward_cached(self, x, k_buf, v_buf, plan):
        a, k_buf, v_buf = self.attn.forward_cached(self.ln_1(x), k_buf,
                                                   v_buf, plan)
        x = x + a
        return (x + self.fc_out(gelu(self.fc_in(self.ln_2(x)),
                                     approximate=True)), k_buf, v_buf)


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, *, generator, device=None,
                 dtype=None):
        super().__init__()
        _check_slice(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.generator = generator
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                **kw)
        self.drop = Dropout(cfg.hidden_dropout_prob, generator=generator)
        self.h = nn.ModuleList([GPTBlock(cfg, generator=generator, **kw)
                                for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def attention_seeds(self, flashmask=False):
        """One attention-dropout seed per layer for this forward, drawn
        from the model's generator in one fetch; None for each layer when
        attention dropout is off (outside training, p = 0, or a FlashMask
        forward, whose attention takes no dropout)."""
        n = self.cfg.num_hidden_layers
        if (not self.training or not self.cfg.attention_dropout_prob
                or flashmask):
            return [None] * n
        g = self.generator
        return torch.randint(0, _SEED_HIGH, (n,), generator=g,
                             device=g.device).tolist()

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                attn_mask_startend_row_indices=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        seeds = self.attention_seeds(
            attn_mask_startend_row_indices is not None)
        for block, seed in zip(self.h, seeds):
            x = block(x, attn_mask=attn_mask,
                      startend_row_indices=attn_mask_startend_row_indices,
                      attn_seed=seed)
        return self.ln_f(x)

    def forward_cached(self, input_ids, caches, offset):
        """caches: per block a ``(k_buf, v_buf)`` pair; positions
        ``offset + arange(S)`` index the learned table."""
        b, s = input_ids.shape
        plan = CachePlan(offset, b, s, caches[0][0])
        x = self.wte(input_ids) + self.wpe(plan.idx)[None]
        new = []
        for blk, (kb, vb) in zip(self.h, caches):
            x, kb, vb = blk.forward_cached(x, kb, vb, plan)
            new.append((kb, vb))
        return self.ln_f(x), new


class GPTForCausalLM(nn.Module, GenerationMixin):
    """``GPTForCausalLM(cfg, device=None, seed=0)``: parameters are made
    on ``device`` (the card unless ``device="cpu"``) in ``cfg.dtype``;
    ``seed`` seeds the model's generator, which draws the weights and then
    every dropout mask and attention-dropout seed (see the module note).
    Real weights arrive through ``load_state_dict`` (see
    ``models/convert.py``)."""

    def __init__(self, cfg: GPTConfig, *, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        self.cfg = cfg
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.gpt = GPTModel(cfg, generator=self.generator, device=dev,
                            dtype=dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                              device=dev, dtype=dtype)
        self.init_weights(self.generator)
        if cfg.tie_word_embeddings:
            # nn.Linear's [out, in] = [vocab, hidden] is the embedding's
            # own layout, so the head shares the Parameter as is
            self.lm_head.weight = self.gpt.wte.weight

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
            if isinstance(mod, nn.Linear) and mod.bias is not None:
                mod.bias.zero_()

    @property
    def device(self):
        return self.lm_head.weight.device

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                attn_mask_startend_row_indices=None):
        return self.lm_head(self.gpt(
            input_ids, position_ids, attn_mask,
            attn_mask_startend_row_indices=attn_mask_startend_row_indices))

    # -- static-cache generation hooks (GenerationMixin) -------------------
    def _init_caches(self, batch, total_len, cache_dtype=None):
        cfg = self.cfg
        nh = cfg.num_attention_heads
        return init_static_caches(cfg.num_hidden_layers, batch, total_len,
                                  nh, cfg.hidden_size // nh, cache_dtype,
                                  resolve_dtype(cfg.dtype),
                                  device=self.device)

    def _forward_cached(self, input_ids, caches, offset):
        h, caches = self.gpt.forward_cached(input_ids, caches, offset)
        return self.lm_head(h), caches


def GPTForCausalLMPipe(cfg: GPTConfig, *args, **kwargs):
    raise NotImplementedError(
        "GPTForCausalLMPipe (the pipeline form) is not ported to "
        "paddle_tpu_torch yet")


def count_params(cfg: GPTConfig) -> int:
    h, m, L, v = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    per_layer = (2 * h                      # ln_1
                 + h * 3 * h + 3 * h        # qkv_proj
                 + h * h + h                # out_proj
                 + 2 * h                    # ln_2
                 + h * m + m + m * h + h)   # fc_in, fc_out
    return (v * h + cfg.max_position_embeddings * h + L * per_layer + 2 * h
            + (0 if cfg.tie_word_embeddings else v * h))


def flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU): 6 N over the parameters that
    multiply (every one but the token and position embeddings, whose
    lookups do none; the untied head counts), plus the full-S² attention
    term 12 L h S. GPT-3 1.3B at S 2048: 9.08e9."""
    h = cfg.hidden_size
    lookups = cfg.vocab_size * h + cfg.max_position_embeddings * h
    n = count_params(cfg) - lookups
    if cfg.tie_word_embeddings:
        n += cfg.vocab_size * h     # the tied head multiplies
    return 6.0 * n + 12 * cfg.num_hidden_layers * h * seq_len
