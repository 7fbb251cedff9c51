"""Carry weights from the JAX package's LLaMA into the port.

``paddle_tpu`` keeps a Linear weight ``[in, out]``; ``torch.nn.Linear``
keeps ``[out, in]``. Every other tensor (embeddings, norm weights) has
the same layout in both.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_paddle_tpu"]

_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
            "mlp.down_proj")


def _expected_shapes(cfg):
    """``{key: shape}`` of the JAX model's ``state_dict()`` for ``cfg``
    (Linear shapes in the JAX ``[in, out]`` layout)."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh = cfg.num_attention_heads
    kv = (cfg.num_key_value_heads or nh) * (h // nh)
    lin = {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, kv),
           "self_attn.v_proj": (h, kv), "self_attn.o_proj": (h, h),
           "mlp.gate_proj": (h, m), "mlp.up_proj": (h, m),
           "mlp.down_proj": (m, h)}
    shapes = {"llama.embed_tokens.weight": (v, h),
              "llama.norm.weight": (h,)}
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    for i in range(cfg.num_hidden_layers):
        pre = f"llama.layers.{i}."
        shapes[pre + "input_layernorm.weight"] = (h,)
        shapes[pre + "post_attention_layernorm.weight"] = (h,)
        for name, shp in lin.items():
            shapes[pre + name + ".weight"] = shp
    return shapes


def _is_linear(key):
    return key == "lm_head.weight" or any(
        key.endswith(name + ".weight") for name in _LINEARS)


def state_dict_from_paddle_tpu(np_state: dict, cfg) -> dict:
    """Map the JAX model's ``state_dict()`` (as numpy arrays, under its
    own key names) to a ``state_dict`` for the port's
    :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM`.

    Raises ``KeyError`` on a missing or unexpected key and
    ``ValueError`` on a shape that does not match ``cfg``."""
    want = _expected_shapes(cfg)
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for key, shape in want.items():
        arr = np.asarray(np_state[key])
        if arr.shape != shape:
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape} "
                             "for this config")
        t = torch.tensor(arr)
        out[key] = t.T.contiguous() if _is_linear(key) else t
    if cfg.tie_word_embeddings:
        out["lm_head.weight"] = out["llama.embed_tokens.weight"]
    return out
