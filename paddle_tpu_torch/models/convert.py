"""Carry weights between the JAX package's LLaMA or GPT and the port.

``paddle_tpu`` keeps a Linear weight ``[in, out]``; ``torch.nn.Linear``
keeps ``[out, in]``. Every other tensor (embeddings, norm weights and
biases, Linear biases) has the same layout in both. The model is told
apart by its config (:class:`~.gpt.GPTConfig` or the LLaMA one).

A model converted to weight-only int8/int4 (``convert_to_weight_only``
in either package) carries each converted Linear as ``qweight`` and
``weight_scale`` in place of ``weight``; they cross with the same
transpose: the JAX package's codes ``[k, n]`` (int4 ``[k/2, n]``) and
grouped scales ``[k/g, n]`` are the port's ``[n, k]`` (``[n, k/2]``) and
``[n, k/g]``; per-channel scales ``[n]`` are the same in both. The codes
stay int8. Load them into a port model converted with the same
``algo`` and ``group_size``.
"""
from __future__ import annotations

import numpy as np
import torch

from .gpt import GPTConfig

__all__ = ["state_dict_from_paddle_tpu", "state_dict_to_paddle_tpu"]

_LINEARS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
            "mlp.down_proj", "attn.qkv_proj", "attn.out_proj", "fc_in",
            "fc_out")


def _gpt_shapes(cfg):
    """``{key: shape}`` of the JAX GPT's ``state_dict()`` (Linear weights
    ``[in, out]``)."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"gpt.wte.weight": (v, h),
              "gpt.wpe.weight": (cfg.max_position_embeddings, h),
              "gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)}
    layer = {"ln_1.weight": (h,), "ln_1.bias": (h,),
             "attn.qkv_proj.weight": (h, 3 * h),
             "attn.qkv_proj.bias": (3 * h,),
             "attn.out_proj.weight": (h, h), "attn.out_proj.bias": (h,),
             "ln_2.weight": (h,), "ln_2.bias": (h,),
             "fc_in.weight": (h, m), "fc_in.bias": (m,),
             "fc_out.weight": (m, h), "fc_out.bias": (h,)}
    for i in range(cfg.num_hidden_layers):
        shapes.update({f"gpt.h.{i}.{k}": shp for k, shp in layer.items()})
    if not cfg.tie_word_embeddings:
        shapes["lm_head.weight"] = (h, v)
    return shapes


def _embedding_key(cfg):
    """The key a tied head shares its weight with."""
    return ("gpt.wte.weight" if isinstance(cfg, GPTConfig)
            else "llama.embed_tokens.weight")


def _expected_shapes(cfg):
    """``{key: shape}`` of the JAX model's ``state_dict()`` for ``cfg``
    (Linear shapes in the JAX ``[in, out]`` layout)."""
    if isinstance(cfg, GPTConfig):
        return _gpt_shapes(cfg)
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


def _with_codes(want, have):
    """``want`` with each Linear weight that ``have`` holds as weight-only
    codes (``qweight`` and ``weight_scale`` in place of ``weight``) under
    those two keys, as ``("codes", k, n)`` and ``("scale", k, n)``
    specs."""
    out = {}
    for key, shape in want.items():
        base = key[:-len("weight")]
        if _is_linear(key) and key not in have and base + "qweight" in have:
            out[base + "qweight"] = ("codes", *shape)
            out[base + "weight_scale"] = ("scale", *shape)
        else:
            out[key] = shape
    return out


def _fits(spec, shape):
    """Whether ``shape`` (JAX layout) is what ``spec`` allows: a shape, or
    codes ``[k, n]`` / ``[k/2, n]``, or scales ``[n]`` / ``[k/g, n]``."""
    if not isinstance(spec[0], str):
        return tuple(shape) == tuple(spec)
    kind, k, n = spec
    if kind == "codes":
        return tuple(shape) in ((k, n), (k // 2, n))
    return tuple(shape) == (n,) or (len(shape) == 2 and shape[1] == n
                                    and 0 < shape[0] and k % shape[0] == 0)


def _transposed(key, ndim):
    """Whether ``key``'s tensor changes layout between the packages."""
    return _is_linear(key) or key.endswith(".qweight") or (
        key.endswith(".weight_scale") and ndim == 2)


def state_dict_from_paddle_tpu(np_state: dict, cfg) -> dict:
    """Map the JAX model's ``state_dict()`` (as numpy arrays, under its
    own key names) to a ``state_dict`` for the port's
    :class:`~paddle_tpu_torch.models.llama.LlamaForCausalLM` or
    :class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM`.

    Raises ``KeyError`` on a missing or unexpected key and
    ``ValueError`` on a shape that does not match ``cfg``."""
    want = _with_codes(_expected_shapes(cfg), set(np_state))
    missing = sorted(set(want) - set(np_state))
    extra = sorted(set(np_state) - set(want))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for key, shape in want.items():
        arr = np.asarray(np_state[key])
        if not _fits(shape, arr.shape):
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape} "
                             "for this config")
        t = torch.tensor(arr)
        out[key] = t.T.contiguous() if _transposed(key, t.dim()) else t
    if cfg.tie_word_embeddings:
        out["lm_head.weight"] = out[_embedding_key(cfg)]
    return out


def state_dict_to_paddle_tpu(state_dict: dict, cfg) -> dict:
    """The inverse of :func:`state_dict_from_paddle_tpu`: the port's
    ``state_dict()`` as float32 numpy arrays under the JAX model's keys
    and layouts (bf16 weights widen exactly). Raises ``KeyError`` on a
    missing or unexpected key and ``ValueError`` on a shape that does not
    match ``cfg``."""
    have = set(state_dict)
    if cfg.tie_word_embeddings:
        have.discard("lm_head.weight")  # the embedding, shared
    want = _with_codes(_expected_shapes(cfg), have)
    missing, extra = sorted(set(want) - have), sorted(have - set(want))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for key, shape in want.items():
        t = state_dict[key].detach().cpu()
        if t.dtype != torch.int8:    # codes stay int8
            t = t.float()
        arr = (t.T if _transposed(key, t.dim()) else t).contiguous().numpy()
        if not _fits(shape, arr.shape):
            raise ValueError(f"{key}: shape {arr.shape} in the JAX layout, "
                             f"expected {shape} for this config")
        out[key] = arr
    return out
