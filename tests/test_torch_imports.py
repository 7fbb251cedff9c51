"""Import hygiene and device policy of paddle_tpu_torch.

The port imports neither JAX nor the JAX package, not even a module of
it that does not itself import JAX; ``chip_smoke.py`` neither. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``
(or CPU tensors), and without a card they raise instead of falling back
to the host. A kernel wrapper takes its plain version only for a tensor
on the CPU; any other tensor goes to the CUDA kernel, which refuses a
tensor that is not on a CUDA device.
"""
import ast
import pathlib

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.nn.functional import (dropout,
                                            scaled_dot_product_attention)
from paddle_tpu_torch.ops import adamw_kernel, fa_kernel, weight_only_kernel
from paddle_tpu_torch.ops.flash_attention import (
    _attention_ref, _attention_ref_hash_dropout, dense_attention,
    flash_attention_bshd, flash_core_lse)
from paddle_tpu_torch.ops.flash_attention import stats as dense_stats
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import PagedKVCache, ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
SOURCES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
TINY = dict(vocab_size=50, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            max_position_embeddings=32)


def _imported_modules(path):
    """Absolute module names a file imports (relative imports are the
    package's own)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_paddle_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_matches_module_names_exactly():
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.serving")
    assert _forbidden("jax.numpy")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.serving.engine")
    assert not _forbidden("jaxtyping")
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for mod in ("serving/engine.py", "ops/fa_kernel.py",
                "ops/flash_attention.py", "ops/adamw_kernel.py",
                "optimizer/optimizer.py", "optimizer/optimizers.py",
                "optimizer/lr.py", "hapi/model.py", "models/llama.py",
                "models/gpt.py", "nn/common.py", "nn/norm.py",
                "nn/clip_grad.py", "regularizer.py", "amp/__init__.py",
                "amp/state.py", "distributed/fleet/recompute.py",
                "io/__init__.py", "metric/__init__.py", "hapi/callbacks.py",
                "framework/io_save.py", "models/generation.py",
                "ops/weight_only_kernel.py", "nn/quant/__init__.py",
                "quantization/__init__.py", "quantization/config.py",
                "quantization/observers.py", "quantization/quanters.py",
                "quantization/qat.py", "quantization/ptq.py"):
        assert f"paddle_tpu_torch/{mod}" in names, mod


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_a_card_raises(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_fall_back_to_the_cpu(no_cuda):
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(LlamaConfig(**TINY))
    with pytest.raises(RuntimeError):
        PagedKVCache(1, 1, 8, num_pages=4)
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(model, num_pages=8)
    eng = ServingEngine(model, num_pages=8, device="cpu")
    assert eng.cache.k_pages[0].device.type == "cpu"


def test_engine_refuses_a_model_on_another_device():
    model = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu").to("meta")
    with pytest.raises(ValueError, match="lies on"):
        ServingEngine(model, num_pages=8, device="cpu")


def test_training_entry_points_run_on_cpu_tensors_without_a_card(no_cuda):
    cfg = LlamaConfig(**TINY, fuse_linear_cross_entropy=True)
    with pytest.raises(RuntimeError):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    m = Model(model)
    m.prepare(AdamW(1e-3, parameters=model.parameters()),
              LlamaPretrainingCriterion(cfg).bind(model))
    ids = torch.arange(12).reshape(1, 2, 6) % TINY["vocab_size"]
    losses = m.train_batch_loop([ids], [ids])
    assert losses.shape == (1,) and torch.isfinite(losses).all()
    q = torch.randn(1, 8, 4, 16)
    assert flash_attention_bshd(q, q, q, causal=True).device.type == "cpu"


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_kernel_wrappers_refuse_tensors_off_a_card():
    """A tensor that is not on the CPU goes to the CUDA kernel, never to
    the plain version, and the wrapper refuses one not on a CUDA card."""
    q = _meta(1, 8, 4, 64)
    lse = _meta(1, 4, 8)
    with pytest.raises(ValueError, match="needs CUDA"):
        fa_kernel.fa_forward(q, q, q, causal=True)
    with pytest.raises(ValueError, match="needs CUDA"):
        fa_kernel.fa_backward(q, q, q, q, lse, q, causal=True)
    for one_kernel in (fa_kernel.fa_dq_cuda, fa_kernel.fa_dkv_cuda):
        with pytest.raises(ValueError, match="needs CUDA"):
            one_kernel(q, q, q, q, lse, lse, causal=True)
    p = torch.nn.Parameter(_meta(10))
    state = {"moment1": _meta(10), "moment2": _meta(10)}
    with pytest.raises(ValueError, match="K4 needs CUDA"):
        adamw_kernel.adamw_update([p], [_meta(10)], [state], lr=1e-3,
                                  step=1, b1=0.9, b2=0.999, eps=1e-8,
                                  wd=0.0, decoupled=True)
    codes = torch.empty(16, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="K7 needs CUDA"):
        weight_only_kernel.weight_only_matmul(_meta(2, 64), codes,
                                              _meta(16))
    with pytest.raises(ValueError, match="K7 needs CUDA"):
        weight_only_kernel.int8_matmul(
            torch.empty(2, 64, dtype=torch.int8, device="meta"), codes,
            _meta(16), 0.1, torch.float32)


@pytest.mark.parametrize("kwargs,missing", [
    (dict(mask=torch.ones(8, 8, dtype=torch.bool), dropout_p=0.1),
     "dense attention mask"),
    (dict(mask=torch.zeros(1, 4, 8, 8), dropout_p=0.1,
          q_seg=torch.zeros(1, 8, dtype=torch.int32),
          kv_seg=torch.zeros(1, 8, dtype=torch.int32)),
     "dense attention mask"),
    (dict(dropout_p=0.1, return_probs=True), "return_probs"),
    (dict(return_probs=True), "return_probs")])
def test_flash_attention_refuses_the_unported_arms(kwargs, missing):
    """What the kernels do not take — dropout beside a dense mask (the
    JAX package runs it in XLA) and the returned probabilities — runs
    the counted dense route (``missing`` names the case), with the
    kernels' counter hash at ``seed=``; without a seed, dropout raises."""
    q = torch.randn(1, 8, 4, 16)
    dense0 = dense_stats["dense"]
    kw = dict(kwargs, seed=3) if kwargs.get("dropout_p") else kwargs
    got = flash_attention_bshd(q, q, q, causal=True, **kw)
    assert dense_stats["dense"] == dense0 + 1, missing
    out = got[0] if kwargs.get("return_probs") else got
    mask = kwargs.get("mask")
    want = dense_attention(
        q, q, q, causal=True, dropout_p=kwargs.get("dropout_p", 0.0),
        seed=3, q_seg=kwargs.get("q_seg"), kv_seg=kwargs.get("kv_seg"),
        mask=None if mask is None else torch.where(
            mask.bool() if mask.dtype == torch.bool else mask == 0, 0.0,
            float("-inf")))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    if kwargs.get("dropout_p"):
        with pytest.raises(ValueError, match="seed="):
            flash_attention_bshd(q, q, q, causal=True, **kwargs)


def test_cross_length_and_sdpa_options_are_refused_not_dropped():
    """Cross-length attention and sdpa's mask run (K6's arms) with their
    semantics, the causal diagonal at Sk - Sq and the mask applied; the
    bool key-padding mask runs as segment ids and dropout as the counter
    hash, each with its semantics; dropout across Sq != Sk, which the
    kernels do not take, raises."""
    q, k = torch.randn(1, 8, 4, 16), torch.randn(1, 12, 4, 16)
    got = flash_attention_bshd(q, k, k, causal=True)
    torch.testing.assert_close(got, _attention_ref(q, k, k, causal=True))
    out, lse = flash_core_lse(q, k, k, True, None)
    torch.testing.assert_close(out, got)
    assert torch.isfinite(lse).all() and lse.shape == (1, 4, 8)
    keep = torch.rand(8, 8, generator=torch.Generator().manual_seed(0)) > .3
    keep.fill_diagonal_(True)
    torch.testing.assert_close(
        scaled_dot_product_attention(q, q, q, attn_mask=keep),
        _attention_ref(q, q, q, mask=keep))
    pad = torch.ones(1, 1, 1, 8, dtype=torch.bool)
    pad[..., 5:] = False
    torch.testing.assert_close(
        scaled_dot_product_attention(q, q, q, attn_mask=pad),
        _attention_ref(q, q, q, mask=pad))
    torch.testing.assert_close(
        scaled_dot_product_attention(q, q, q, dropout_p=0.1, is_causal=True,
                                     seed=7),
        _attention_ref_hash_dropout(q, q, q, 7, 0.1, causal=True))
    torch.testing.assert_close(
        scaled_dot_product_attention(q, k, k, dropout_p=0.1, seed=7),
        dense_attention(q, k, k, dropout_p=0.1, seed=7), rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        dropout(q, 0.1)
    with pytest.raises(ValueError, match="seed="):
        scaled_dot_product_attention(q, q, q, dropout_p=0.1, is_causal=True)
    out = scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                       training=False, is_causal=True)
    assert out.shape == q.shape


def test_arguments_the_port_would_not_read_are_refused():
    """No argument is accepted and then ignored: ``fit``'s
    ``accumulate_grad_batches`` and ``drop_last`` (which the JAX package
    never reads), ``prepare``'s AMP dtype other than bfloat16 (the JAX
    package reads only the level), the criterion's ``model=`` (the MoE
    aux loss) raise;
    ``use_multi_tensor`` is not an argument at all (the card's step is
    always the multi-tensor kernel). ``Model(inputs=, labels=)`` is read:
    the count of inputs splits fit's batches."""
    from paddle_tpu_torch.optimizer import Adam
    net = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    model = Model(net, inputs=["ids"], labels=["labels"])
    assert model._split_batch((1, 2, 3)) == ([1], [2, 3])
    for kw in (dict(accumulate_grad_batches=4), dict(drop_last=True)):
        with pytest.raises(NotImplementedError, match="never reads"):
            model.fit([], verbose=0, **kw)
    with pytest.raises(NotImplementedError, match="reads only 'level'"):
        model.prepare(amp_configs={"level": "O1", "dtype": "float16"})
    assert model.prepare(amp_configs={"level": "O2", "dtype": "bfloat16"}
                         )._amp_level == "O2"
    with pytest.raises(NotImplementedError, match="model="):
        LlamaPretrainingCriterion(LlamaConfig(**TINY), model=net)
    with pytest.raises(TypeError):
        Adam(1e-3, parameters=net.parameters(), use_multi_tensor=True)
    assert LlamaPretrainingCriterion(LlamaConfig(**TINY)).bind(net) \
        is not None


def test_gpt_entry_points_do_not_fall_back_to_the_cpu(no_cuda):
    """GPTForCausalLM runs on the card unless given device="cpu", and its
    unported options raise rather than being ignored."""
    cfg = GPTConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(cfg)
    net = GPTForCausalLM(cfg, device="cpu")
    assert net.device.type == "cpu" and net.generator.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="not ported"):
        GPTForCausalLM(GPTConfig.tiny(tensor_parallel=True), device="cpu")
    assert GPTForCausalLM(GPTConfig.tiny(recompute=True),
                          device="cpu").cfg.recompute
