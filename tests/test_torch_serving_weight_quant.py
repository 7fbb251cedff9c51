"""Weight-only int8/int4 serving and generation of paddle_tpu_torch
against paddle_tpu on the CPU (float32, greedy), the JAX models' weights
carried across before the conversion, each package converting its own:

- ``ServingEngine(weight_quant="int8"|"int4")`` token for token against
  the JAX engine (one JAX run a dtype, module fixtures); the port's
  ragged step, the prefix cache, the int8 cache and a draft give
  the bucketed int8 engine's streams; ``lm_head`` stays a ``Linear`` and
  the draft is not converted;
- ``generate()`` over a converted LLaMA and GPT against the JAX models'
  greedy tokens; a program built before the conversion is not replayed
  after it;
- ``weight_quant="fp8"`` raises the reference's ``ValueError``, and the
  JAX engine's environment knob is not read.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.quant import convert_to_weight_only as jax_convert
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.quant import WeightOnlyLinear, convert_to_weight_only
from paddle_tpu_torch.serving import ServingEngine

from test_torch_weight_only import jax_ops_compiled_fast  # noqa: F401

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
ENG = dict(page_size=4, max_batch=2, prefill_chunk=8, num_pages=48)
NEW = 5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(jax_cls, jax_cfg, cls, cfg, seed=0):
    """The JAX model and the port's, with the same (unquantized)
    weights."""
    P.seed(seed)
    jm = jax_cls(jax_cfg)
    jm.eval()
    tm = cls(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    tm.eval()
    return jm, tm


def _llama():
    return _pair(JaxLlama, JaxLlamaConfig(**TINY), LlamaForCausalLM,
                 LlamaConfig(**TINY))


def _prompts():
    """Four requests, three over one 2-page prefix."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 97, 8).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(0, 97, n).astype(np.int32)])
           for n in (3, 9, 5)]
    out.append(rng.integers(0, 97, 6).astype(np.int32))
    return out


def _serve(eng, prompts):
    rids = [eng.add_request(p, max_new_tokens=NEW) for p in prompts]
    res = eng.run()
    return [res[r]["tokens"] for r in rids]


@pytest.fixture(scope="module", params=["int8", "int4"])
def served(request):
    """One JAX engine run with ``weight_quant``, and the port's model
    (unconverted: the port's engine converts it)."""
    jm, tm = _llama()
    jeng = JaxServingEngine(jm, weight_quant=request.param, **ENG)
    assert jm._weight_only_converted == 14
    return request.param, tm, _serve(jeng, _prompts())


def test_engine_matches_the_jax_engine_token_for_token(served):
    wq, tm, want = served
    eng = ServingEngine(tm, weight_quant=wq, device="cpu", **ENG)
    assert eng.weight_quant == wq
    assert tm._weight_only_converted == 14
    assert type(tm.lm_head) is Linear
    layer = tm.llama.layers[0]
    assert isinstance(layer.mlp.up_proj, WeightOnlyLinear)
    assert layer.mlp.up_proj.weight_dtype == wq
    assert _serve(eng, _prompts()) == want


def test_engine_paths_over_quantized_weights_give_one_stream(served):
    """The ragged step, the prefix cache and a draft over the int8
    or int4 model give the bucketed engine's streams; with the int8
    cache, bucketed and ragged agree. The draft keeps its Linears."""
    wq, tm, want = served
    ServingEngine(tm, weight_quant=wq, device="cpu", **ENG)
    draft = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    draft.load_state_dict(tm.state_dict(), strict=False)
    for kw in (dict(ragged=True), dict(prefix_cache=True),
               dict(draft_model=draft, speculative_k=3),
               dict(ragged=True, prefix_cache=True, draft_model=draft,
                    speculative_k=3)):
        eng = ServingEngine(tm, weight_quant=wq, device="cpu", **ENG, **kw)
        assert _serve(eng, _prompts()) == want, kw
    assert type(draft.llama.layers[0].mlp.up_proj) is Linear
    kv8 = [_serve(ServingEngine(tm, weight_quant=wq, device="cpu",
                                cache_dtype="int8", ragged=r, **ENG),
                  _prompts()) for r in (False, True)]
    assert kv8[0] == kv8[1]


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_generate_over_a_converted_model_matches_jax(model):
    if model == "llama":
        jm, tm = _llama()
    else:
        jm, tm = _pair(JaxGPT, JaxGPTConfig.tiny(vocab_size=97),
                       GPTForCausalLM, GPTConfig.tiny(vocab_size=97))
    ids = np.random.default_rng(1).integers(3, 97, (2, 8)).astype(np.int32)
    before = tm.generate(ids, max_new_tokens=6)
    programs = list(tm._gen_cache.values())
    jax_convert(jm, exclude=("lm_head",))
    convert_to_weight_only(tm, exclude=("lm_head",))
    want = np.asarray(jm.generate(ids, max_new_tokens=6)._data)
    got = tm.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    # the conversion changed the weights' addresses: a new program
    assert all(p not in tm._gen_cache.values() for p in programs)
    assert before.shape == got.shape


def test_bad_weight_quant_raises_and_the_env_knob_is_not_read(
        monkeypatch):
    _, tm = _llama()
    with pytest.raises(ValueError, match="weight_quant must be"):
        ServingEngine(tm, weight_quant="fp8", device="cpu", **ENG)
    monkeypatch.setenv("PADDLE_TPU_" + "SERVING_WEIGHT_QUANT", "int8")
    eng = ServingEngine(tm, device="cpu", **ENG)
    assert eng.weight_quant is None
    assert type(tm.llama.layers[0].mlp.up_proj) is Linear
