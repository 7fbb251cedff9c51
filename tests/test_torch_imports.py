"""Import hygiene and device policy of paddle_tpu_torch.

The port imports neither JAX nor the JAX package, not even a module of
it that does not itself import JAX; ``chip_smoke.py`` neither. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``,
and without a card they raise instead of falling back to the host.
"""
import ast
import pathlib

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
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
    assert any(p.name == "engine.py" for p in SOURCES)


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
