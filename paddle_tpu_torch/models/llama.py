"""LLaMA-2 family, inference only (counterpart:
``paddle_tpu/models/llama.py``).

Module names mirror the JAX package (``llama.layers.0.self_attn.q_proj``
...) so weights carry across key for key (``models/convert.py``). The
dense :meth:`LlamaForCausalLM.forward` is the teacher-forced reference
the serving engine's paged path is held against; its attention is plain
float32 PyTorch. Serving runs the trunk through
``serving/engine.py::_paged_forward`` instead, which reuses these
modules' weights.

Configuration flags outside this slice (tensor, sequence and context
parallelism, MoE, recompute, fused cross entropy in training) raise
``NotImplementedError``; none is silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device, resolve_dtype
from ..nn import RMSNorm
from ..nn.functional import fused_rotary_position_embedding, swiglu

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaForCausalLM"]


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
        "recompute": cfg.recompute,
    }
    for name, on in unsupported.items():
        if on:
            raise NotImplementedError(
                f"LlamaConfig.{name} is not ported to paddle_tpu_torch yet")
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
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, kv_out, **kw)
        self.v_proj = nn.Linear(h, kv_out, **kw)
        self.o_proj = nn.Linear(h, h, **kw)

    def forward(self, x, position_ids):
        """Dense causal (and, with ``sliding_window``, banded) GQA
        attention over the whole sequence, scored in float32."""
        b, s, _ = x.shape
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        g = nh // nkv
        q = self.q_proj(x).reshape(b, s, nh, hd)
        k = self.k_proj(x).reshape(b, s, nkv, hd)
        v = self.v_proj(x).reshape(b, s, nkv, hd)
        q, k = fused_rotary_position_embedding(
            q, k, position_ids=position_ids,
            rotary_emb_base=self.cfg.rope_theta)
        qg = q.reshape(b, s, nkv, g, hd).float()
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
            * (1.0 / hd ** 0.5)
        qpos = torch.arange(s, device=x.device)[:, None]
        kpos = torch.arange(s, device=x.device)[None, :]
        mask = kpos <= qpos
        if self.cfg.sliding_window:
            mask = mask & (kpos > qpos - int(self.cfg.sliding_window))
        sc = sc.masked_fill(~mask, float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", pr, v.float())
        return self.o_proj(out.reshape(b, s, nh * hd).to(x.dtype))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, m, **kw)
        self.up_proj = nn.Linear(h, m, **kw)
        self.down_proj = nn.Linear(m, h, **kw)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       **kw)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, x, position_ids):
        h = x + self.self_attn(self.input_layernorm(x), position_ids)
        return h + self.mlp(self.post_attention_layernorm(h))


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

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device
            )[None].expand(input_ids.shape[0], -1)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, position_ids)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``LlamaForCausalLM(cfg, device=None, seed=0)``: parameters are
    made on ``device`` (the card unless ``device="cpu"``) in
    ``cfg.dtype``; every Linear and Embedding weight is drawn from
    N(0, 0.02) by a ``torch.Generator`` seeded with ``seed``, the norms
    start at ones. Real weights arrive through ``load_state_dict``
    (see ``models/convert.py``)."""

    def __init__(self, cfg: LlamaConfig, *, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        self.cfg = cfg
        self.llama = LlamaModel(cfg, device=dev, dtype=dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias=False, device=dev, dtype=dtype)
        self.init_weights(torch.Generator(device=dev).manual_seed(seed))
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

    def forward(self, input_ids, position_ids=None):
        if self.cfg.fuse_linear_cross_entropy and self.training:
            raise NotImplementedError(
                "fused linear cross entropy (training) is not ported to "
                "paddle_tpu_torch yet")
        return self.lm_head(self.llama(input_ids, position_ids))
