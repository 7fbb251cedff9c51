"""LLaMA-2 family (counterpart: ``paddle_tpu/models/llama.py``).

Module names mirror the JAX package (``llama.layers.0.self_attn.q_proj``
...) so weights carry across key for key (``models/convert.py``).

- Training: :class:`LlamaForCausalLM` with ``use_flash_attention`` runs
  its attention through ``scaled_dot_product_attention`` (the kernels
  K1-K3 on the card, K6 with an ``attn_mask``); a ``sliding_window``
  (Mistral) and PaddleNLP's packed-document
  ``attn_mask_startend_row_indices`` go through ``flashmask_attention``
  (K6 and the banded arms of K2/K3). With ``fuse_linear_cross_entropy`` a
  training
  forward returns the marked final hidden state and
  :class:`LlamaPretrainingCriterion` applies the head chunk by chunk with
  the cross entropy (the ``[B, S, V]`` logits never exist at once).
- ``use_flash_attention=False`` takes plain float32 attention (the JAX
  package's ``_ref_attn_fn`` path, banded with ``sliding_window``): the
  dense reference the serving engine's paged path is held against.
- Serving runs the trunk through ``serving/engine.py::_paged_forward``,
  which reuses these modules' weights.
- ``generate()`` (``models/generation.py``) runs the ``forward_cached``
  path: a static K/V cache per layer, attention through
  ``cached_attention`` (K5 on the card), the window included.

- ``recompute`` (training only): ``recompute_granularity="full"`` runs
  each decoder layer, ``"core_attn"`` each layer's attention (its
  projections included), under :func:`..distributed.fleet.recompute`, so
  backward runs it again (K1 launches twice a layer and step);
  ``"full_attn"`` runs each layer so with the attention output tagged by
  :func:`..distributed.fleet.mark_saveable`, which backward keeps: K1
  launches once a layer and step.

Configuration flags outside the ported slices (tensor, sequence and
context parallelism, MoE) raise ``NotImplementedError``; none is
silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device, resolve_dtype
from ..distributed.fleet.recompute import mark_saveable, recompute
from ..nn import Linear, RMSNorm
from ..nn.functional import (flashmask_attention,
                             fused_rotary_position_embedding,
                             scaled_dot_product_attention, swiglu)
from ..ops.flash_attention import _attention_ref
from .generation import (CachePlan, GenerationMixin, cached_attention,
                         init_static_caches)

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "count_params", "flops_per_token"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_flash_attention: bool = True
    fuse_linear_cross_entropy: bool = False
    loss_chunk_size: int = 1024
    tie_word_embeddings: bool = False
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    context_parallel: str | None = None
    sliding_window: int | None = None
    recompute: bool = False
    recompute_granularity: str = "full"
    dtype: str = "float32"
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_layer_interval: int = 1
    moe_aux_loss_weight: float = 0.01

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**{**dict(
            hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32), **kw})

    @staticmethod
    def mistral_7b(**kw):
        # Mistral-7B v0.1: rope_theta 1e4 with the 4096 sliding window
        return LlamaConfig(**{**dict(
            hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=32768,
            sliding_window=4096), **kw})

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128), **kw})


def _check_slice(cfg):
    """Refuse the flags this port does not implement yet."""
    unsupported = {
        "tensor_parallel": cfg.tensor_parallel,
        "sequence_parallel": cfg.sequence_parallel,
        "context_parallel": cfg.context_parallel,
        "moe_num_experts": cfg.moe_num_experts > 0,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(
                f"LlamaConfig.{name} is not ported to paddle_tpu_torch yet")
    if cfg.recompute and cfg.recompute_granularity not in (
            "full", "full_attn", "core_attn"):
        raise ValueError(f"recompute_granularity="
                         f"{cfg.recompute_granularity!r}: use 'full', "
                         "'full_attn' or 'core_attn'")
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"LlamaConfig.dtype={cfg.dtype!r}: use "
                         "'float32' or 'bfloat16'")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads or self.num_heads
        self.head_dim = cfg.hidden_size // self.num_heads
        h = cfg.hidden_size
        kv_out = self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, kv_out, **kw)
        self.v_proj = Linear(h, kv_out, **kw)
        self.o_proj = Linear(h, h, **kw)

    def forward(self, x, position_ids, attn_mask=None,
                startend_row_indices=None):
        """Causal GQA attention over the whole sequence, the JAX package's
        branches without a KV cache: FlashMask bounds
        (``startend_row_indices``, the window folded in) or a sliding
        window with flash attention through ``flashmask_attention``; a
        window without it as plain banded attention; otherwise the flash
        kernels (with ``attn_mask``) or, with ``use_flash_attention=False``,
        plain float32 attention. Mistral's ``sliding_window`` w counts the
        query itself among its w visible keys, ``window_size`` counts the
        keys before it: hence w - 1."""
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k = fused_rotary_position_embedding(
            q, k, position_ids=position_ids,
            rotary_emb_base=self.cfg.rope_theta)
        sw = self.cfg.sliding_window
        if sw and attn_mask is not None:
            raise NotImplementedError(
                "sliding_window does not compose with a dense attn_mask; "
                "use packed sequences via attn_mask_startend_row_indices "
                "(FlashMask folds the window into the column bounds)")
        if startend_row_indices is not None:
            if attn_mask is not None:
                raise ValueError("attn_mask and attn_mask_startend_row_"
                                 "indices are mutually exclusive")
            out = flashmask_attention(
                q, k, v, startend_row_indices=startend_row_indices,
                causal=True, window_size=int(sw) - 1 if sw else None)
        elif sw and self.cfg.use_flash_attention:
            out = flashmask_attention(q, k, v, causal=True,
                                      window_size=int(sw) - 1)
        elif self.cfg.use_flash_attention:
            out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                               is_causal=True,
                                               training=self.training)
        else:
            mask = attn_mask.detach() if attn_mask is not None else None
            if sw:
                pos = torch.arange(s, device=x.device)
                mask = pos[None, :] > pos[:, None] - int(sw)
            out = _attention_ref(q.float(), k.float(), v.float(),
                                 mask=mask, causal=True).to(x.dtype)
        out = out.reshape(b, s, nh * hd)
        if (self.cfg.recompute and self.training
                and self.cfg.recompute_granularity == "full_attn"):
            out = mark_saveable(out, "attn_out")
        return self.o_proj(out)

    def forward_cached(self, x, k_buf, v_buf, plan):
        """The static-cache path of ``generate`` (``models/generation.py``):
        q/k/v, RoPE at ``offset + arange(S)`` (the forward's
        :class:`~.generation.CachePlan` ``idx``, a device tensor),
        :func:`~.generation.cached_attention` with the window, o_proj.
        Returns ``(out, k_buf, v_buf)``."""
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k = fused_rotary_position_embedding(
            q, k, position_ids=plan.idx[None].expand(b, s),
            rotary_emb_base=self.cfg.rope_theta)
        out, k_buf, v_buf = cached_attention(
            q, k, v, k_buf, v_buf, plan, 1.0 / (hd ** 0.5),
            window=self.cfg.sliding_window or None)
        return self.o_proj(out.reshape(b, s, nh * hd)), k_buf, v_buf


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = Linear(h, m, **kw)
        self.up_proj = Linear(h, m, **kw)
        self.down_proj = Linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def _block(self, x, position_ids, attn_mask=None,
               startend_row_indices=None, attn=None):
        h = x + (attn or self.self_attn)(self.input_layernorm(x),
                                         position_ids, attn_mask,
                                         startend_row_indices)
        return h + self.mlp(self.post_attention_layernorm(h))

    def forward(self, x, position_ids, attn_mask=None,
                startend_row_indices=None):
        if not (self.cfg.recompute and self.training):
            return self._block(x, position_ids, attn_mask,
                               startend_row_indices)
        if self.cfg.recompute_granularity == "core_attn":
            return self._block(
                x, position_ids, attn_mask, startend_row_indices,
                attn=lambda *a: recompute(self.self_attn, *a))
        return recompute(self._block, x, position_ids, attn_mask,
                         startend_row_indices,
                         granularity=self.cfg.recompute_granularity)

    def forward_cached(self, x, k_buf, v_buf, plan):
        a, k_buf, v_buf = self.self_attn.forward_cached(
            self.input_layernorm(x), k_buf, v_buf, plan)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h)), k_buf, v_buf


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, **kw)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                attn_mask_startend_row_indices=None):
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device
            )[None].expand(input_ids.shape[0], -1)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, position_ids, attn_mask,
                      attn_mask_startend_row_indices)
        return self.norm(x)

    def forward_cached(self, input_ids, caches, offset):
        """caches: per layer a ``(k_buf, v_buf)`` pair; the forward's
        :class:`~.generation.CachePlan` is built once, before the
        layers."""
        b, s = input_ids.shape
        plan = CachePlan(offset, b, s, caches[0][0])
        x = self.embed_tokens(input_ids)
        new = []
        for layer, (kb, vb) in zip(self.layers, caches):
            x, kb, vb = layer.forward_cached(x, kb, vb, plan)
            new.append((kb, vb))
        return self.norm(x), new


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """``LlamaForCausalLM(cfg, device=None, seed=0)``: parameters are
    made on ``device`` (the card unless ``device="cpu"``) in
    ``cfg.dtype``; every Linear and Embedding weight is drawn from
    N(0, 0.02) by the model's ``generator``, a ``torch.Generator`` seeded
    with ``seed`` (which later draws ``generate``'s seed when none is
    given), the norms start at ones. Real weights arrive through
    ``load_state_dict`` (see ``models/convert.py``). ``generate()`` comes
    from :class:`~.generation.GenerationMixin`."""

    def __init__(self, cfg: LlamaConfig, *, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        self.cfg = cfg
        self.llama = LlamaModel(cfg, device=dev, dtype=dtype)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                              device=dev, dtype=dtype)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.init_weights(self.generator)
        if cfg.tie_word_embeddings:
            # nn.Linear's [out, in] = [vocab, hidden] is the embedding's
            # own layout, so the head shares the Parameter as is
            self.lm_head.weight = self.llama.embed_tokens.weight

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)

    @property
    def device(self):
        return self.lm_head.weight.device

    def forward(self, input_ids, position_ids=None, attn_mask=None,
                attn_mask_startend_row_indices=None):
        h = self.llama(input_ids, position_ids, attn_mask,
                       attn_mask_startend_row_indices)
        if self.cfg.fuse_linear_cross_entropy and self.training:
            # the criterion applies the head chunk by chunk with the CE;
            # the marker, not a shape test, tells it this is hidden
            h._fused_hidden = True
            return h
        return self.lm_head(h)

    # -- static-cache generation hooks (GenerationMixin) -------------------
    def _init_caches(self, batch, total_len, cache_dtype=None):
        cfg = self.cfg
        nkv = cfg.num_key_value_heads or cfg.num_attention_heads
        return init_static_caches(
            cfg.num_hidden_layers, batch, total_len, nkv,
            cfg.hidden_size // cfg.num_attention_heads, cache_dtype,
            resolve_dtype(cfg.dtype), device=self.device)

    def _forward_cached(self, input_ids, caches, offset):
        h, caches = self.llama.forward_cached(input_ids, caches, offset)
        return self.lm_head(h), caches


class LlamaPretrainingCriterion(nn.Module):
    """Shifted causal-LM loss: position t predicts label t+1, the mean over
    the labels that are not ``ignore_index``. With
    ``cfg.fuse_linear_cross_entropy`` and a marked hidden state it is the
    chunked head + cross entropy of :func:`_fused_ce`, which needs the
    head weight: ``LlamaPretrainingCriterion(cfg).bind(model)``."""

    def __init__(self, cfg: LlamaConfig = None, ignore_index=-100,
                 lm_head_weight=None, model=None):
        super().__init__()
        if cfg is not None and getattr(cfg, "tensor_parallel", False):
            raise NotImplementedError(
                "the tensor-parallel criterion (ParallelCrossEntropy) is "
                "not ported to paddle_tpu_torch yet")
        if model is not None or (cfg is not None and getattr(
                cfg, "moe_num_experts", 0)):
            # model= only feeds the MoE aux loss in the JAX package
            raise NotImplementedError(
                "the MoE auxiliary loss (and the criterion's model=) is "
                "not ported to paddle_tpu_torch yet; bind(model) takes "
                "the head weight")
        self.ignore_index = ignore_index
        self.fuse = cfg is not None and getattr(
            cfg, "fuse_linear_cross_entropy", False)
        self.chunk = getattr(cfg, "loss_chunk_size", 1024) \
            if cfg is not None else 1024
        # a plain attribute: nn.Module would register the head weight as
        # the criterion's own parameter
        object.__setattr__(self, "_head_w", lm_head_weight)

    def bind(self, model):
        object.__setattr__(self, "_head_w", model.lm_head.weight)
        return self

    def forward(self, logits, labels):
        labels = labels.long()
        if self.fuse and getattr(logits, "_fused_hidden", False):
            if self._head_w is None:
                raise RuntimeError(
                    "fuse_linear_cross_entropy needs the LM head weight: "
                    "LlamaPretrainingCriterion(cfg).bind(model)")
            return _fused_ce(logits, self._head_w, labels,
                             self.ignore_index, int(self.chunk))
        lg = logits[:, :-1, :]
        lb = labels[:, 1:]
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), lb.reshape(-1),
                               ignore_index=self.ignore_index)


class _HeadF32(torch.autograd.Function):
    """``h [..., H] @ w[V, H].T`` as float32 logits, the JAX head's
    ``preferred_element_type=float32``: on the card a bf16/f16 GEMM
    writes its float32 accumulator (``torch.mm(..., out_dtype=)``), on
    the CPU both operands are widened. Backward rounds the float32
    cotangent to the model dtype for its two GEMMs (what the TPU's
    default-precision matmul does with it)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        if h.is_cuda:
            out = torch.mm(h2, w.t(), out_dtype=torch.float32)
        else:
            out = torch.mm(h2.float(), w.float().t())
        return out.view(*h.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(h.dtype)
        gh = (g2 @ w).view(h.shape) if ctx.needs_input_grad[0] else None
        gw = (g2.t() @ h.reshape(-1, h.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gh, gw


def _head_logits(h, w):
    if h.dtype == torch.float32:
        return F.linear(h, w)
    return _HeadF32.apply(h, w)


def _chunk_loss(h_c, w, y_c, ignore):
    """(summed NLL, count) of one chunk: float32 logits from the head
    GEMM (:func:`_head_logits`) and the log-softmax in float32."""
    lsm = torch.log_softmax(_head_logits(h_c, w), dim=-1)
    live = y_c != ignore
    safe = torch.where(live, y_c, torch.zeros_like(y_c))
    nll = -lsm.gather(-1, safe[..., None])[..., 0]
    m = live.float()
    return (nll * m).sum(), m.sum()


def _fused_ce(h, w, labels, ignore, chunk):
    """Chunked head + cross entropy (the JAX package's ``_fused_ce_fn``):
    drop the last position, cut the sequence into ``min(chunk, S - 1)``
    pieces plus an uneven tail, and recompute each piece's ``[B, C, V]``
    logits in backward (``torch.utils.checkpoint``), so one chunk's
    logits are the most that live at once. Divides by the count of
    labels that are not ignored."""
    hq, yb = h[:, :-1, :], labels[:, 1:]
    sm = hq.shape[1]
    c = min(chunk, sm)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for lo in range(0, sm, c):
        s_, c_ = checkpoint(_chunk_loss, hq[:, lo:lo + c], w,
                            yb[:, lo:lo + c], ignore, use_reentrant=False,
                            preserve_rng_state=False)
        tot, cnt = tot + s_, cnt + c_
    return tot / torch.clamp(cnt, min=1.0)


def count_params(cfg: LlamaConfig) -> int:
    h, m, L, v = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    kv = (cfg.num_key_value_heads or cfg.num_attention_heads)
    hd = h // cfg.num_attention_heads
    attn = h * h + 2 * h * kv * hd + h * h
    mlp = 3 * h * m
    per_layer = attn + mlp + 2 * h
    return v * h + L * per_layer + h + (0 if cfg.tie_word_embeddings
                                        else v * h)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs a token, about 6 N plus the attention term (for
    MFU)."""
    n = count_params(cfg)
    attn_flops = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
    return 6.0 * n + attn_flops
