"""paddle_tpu_torch's LLaMA trunk against paddle_tpu on the CPU.

The same numpy inputs (and, for the model, the same numpy weights,
carried across by ``state_dict_from_paddle_tpu``) go through the JAX
function and its PyTorch counterpart. Elementwise functions agree to
1e-6 in float32; the 2-layer model's logits to 1e-4 (two frameworks'
float32 matmuls sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn import functional as TF

ATOL_F32 = 1e-6
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x._data if isinstance(x, Tensor) else x)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3.0
    w = rng.standard_normal(64).astype(np.float32)
    want = _np(JF.rms_norm(Tensor(jnp.asarray(x)), Tensor(jnp.asarray(w)),
                           1e-6))
    got = TF.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
    layer = RMSNorm(64, 1e-6, device="cpu")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               want, atol=ATOL_F32)


def test_rms_norm_casts_before_the_weight():
    """bf16: the normalised value is rounded to bf16 BEFORE the weight
    multiplies it, as in the JAX package."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    w = torch.full((64,), 1.7)
    xb, wb = x.bfloat16(), w.bfloat16()
    x32 = xb.float()
    norm = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6))
    want = norm.bfloat16() * wb
    assert torch.equal(TF.rms_norm(xb, wb), want)


@pytest.mark.parametrize("split", [False, True])
def test_swiglu_matches_jax(split):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 4.0
    y = rng.standard_normal((2, 7, 32)).astype(np.float32)
    if split:
        xy = np.concatenate([x, y], -1)
        want = _np(JIF.swiglu(Tensor(jnp.asarray(xy))))
        got = TF.swiglu(torch.from_numpy(xy))
    else:
        want = _np(JIF.swiglu(Tensor(jnp.asarray(x)),
                              Tensor(jnp.asarray(y))))
        got = TF.swiglu(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)


def test_rope_matches_jax_far_past_the_sequence():
    """Angles come from the positions themselves, so positions far past
    the sequence length (a decode step at position ~4000) are valid."""
    rng = np.random.default_rng(2)
    b, s, nh, nkv, d = 2, 6, 4, 2, 16
    q = rng.standard_normal((b, s, nh, d)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, d)).astype(np.float32)
    pos = np.stack([np.arange(s) + 4000, np.arange(s) * 531 + 17]
                   ).astype(np.int32)
    jq, jk, _ = JIF.fused_rotary_position_embedding(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)), None,
        position_ids=Tensor(jnp.asarray(pos)), rotary_emb_base=10000.0)
    tq, tk = TF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k),
        position_ids=torch.from_numpy(pos), rotary_emb_base=10000.0)
    np.testing.assert_allclose(tq.numpy(), _np(jq), atol=ATOL_F32)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL_F32)


def _transplanted(seed=0, **kw):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**{**TINY, **kw}))
    jm.eval()
    cfg = LlamaConfig(**{**TINY, **kw})
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm, sd, cfg


def test_tiny_llama_logits_match_jax():
    jm, tm, _, _ = _transplanted()
    ids = np.random.default_rng(3).integers(0, 97, (2, 11)).astype(
        np.int32)
    # one program (the JAX package's jit.to_static), not op by op
    want = _np(P.jit.to_static(lambda x: jm(x))(Tensor(jnp.asarray(ids))))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 11, 97)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_state_dict_conversion_transposes_and_refuses_mismatches():
    jm, tm, sd, cfg = _transplanted()
    out = state_dict_from_paddle_tpu(sd, cfg)
    key = "llama.layers.0.self_attn.k_proj.weight"
    assert sd[key].shape == (64, 32)           # JAX Linear: [in, out]
    assert tuple(out[key].shape) == (32, 64)   # nn.Linear: [out, in]
    np.testing.assert_array_equal(out[key].numpy(), sd[key].T)
    missing = dict(sd)
    del missing["llama.norm.weight"]
    with pytest.raises(KeyError, match="llama.norm.weight"):
        state_dict_from_paddle_tpu(missing, cfg)
    with pytest.raises(KeyError, match="extra.weight"):
        state_dict_from_paddle_tpu({**sd, "extra.weight": sd[key]}, cfg)
    bad = {**sd, key: sd[key][:, :16]}
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_paddle_tpu(bad, cfg)


FULL_ATTN = dict(recompute=True, recompute_granularity="full_attn")


@pytest.mark.parametrize("flag", [
    dict(tensor_parallel=True), dict(sequence_parallel=True),
    dict(context_parallel="ring"), dict(moe_num_experts=4), FULL_ATTN])
def test_unported_config_flags_raise(flag):
    """The flags outside the ported slices raise. ``full_attn`` recompute
    is ported now: it builds and trains, its attention forward running
    once a layer (the tagged output is kept for backward)."""
    if flag is FULL_ATTN:
        from paddle_tpu_torch.ops import fa_kernel
        m = LlamaForCausalLM(LlamaConfig(**{**TINY, **flag}), device="cpu")
        m.train()
        fa_kernel.reset_stats()
        m(torch.zeros(1, 4, dtype=torch.long)).float().sum().backward()
        assert fa_kernel.stats["plain_fwd_calls"] == TINY[
            "num_hidden_layers"]
        return
    with pytest.raises(NotImplementedError):
        LlamaForCausalLM(LlamaConfig(**{**TINY, **flag}), device="cpu")


def test_fused_cross_entropy_training_raises():
    """A fused-CE training forward returns the marked hidden state (no
    logits); the criterion raises until it is bound to the head weight."""
    cfg = LlamaConfig(**{**TINY, "fuse_linear_cross_entropy": True})
    m = LlamaForCausalLM(cfg, device="cpu")
    m.train()
    ids = torch.zeros(1, 4, dtype=torch.long)
    hidden = m(ids)
    assert hidden._fused_hidden and hidden.shape == (1, 4, TINY[
        "hidden_size"])
    with pytest.raises(RuntimeError, match="bind"):
        LlamaPretrainingCriterion(cfg)(hidden, ids)
    m.eval()
    assert m(ids).shape == (1, 4, TINY["vocab_size"])


def test_presets_match_jax():
    for name in ("llama2_7b", "mistral_7b", "tiny"):
        want = vars(getattr(JaxLlamaConfig, name)(dtype="bfloat16"))
        got = vars(getattr(LlamaConfig, name)(dtype="bfloat16"))
        assert got == want, name
