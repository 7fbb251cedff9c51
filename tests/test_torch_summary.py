"""``hapi``'s summary, flops and VisualDL in paddle_tpu_torch against
paddle_tpu on the CPU.

- ``summary`` and ``flops`` totals (and the table's rows: names, output
  shapes, own parameters) on a tiny LLaMA with the JAX model's weights
  and on a Linear / LayerNorm / GELU stack, ``custom_ops`` included;
  ``Model.summary`` with and without ``input_size``. ``flops`` runs on
  zeros of ``input_size`` in float32 in both packages, which an
  embedding cannot index: for the LLaMA both packages' input makers are
  patched to int32 zeros.
- ``VisualDL``'s records after a 2-epoch ``fit`` (one step an epoch):
  the reference's kinds, steps and keys, the loss to 1e-5 (float32, as
  ``test_torch_fit.py``).
"""
import importlib
import json

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import io
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.hapi import Model, callbacks, flops, summary
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.optimizer import SGD

# the modules (each package's hapi exports its function by that name)
jsum = importlib.import_module("paddle_tpu.hapi.summary")
tsum = importlib.import_module("paddle_tpu_torch.hapi.summary")
# plain attention in both packages: the tables, counts and losses do not
# depend on the attention's arm, and the JAX package's flash kernel
# would run in interpret mode
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32,
            use_flash_attention=False)


@pytest.fixture(autouse=True)
def _fleet_set_aside():
    """``P.Model`` trains through its single-device stepper only while
    fleet is not initialized (see ``test_torch_train.py``)."""
    from paddle_tpu.distributed.fleet import fleet as jax_fleet
    from paddle_tpu.distributed.fleet import topology
    st = jax_fleet._state
    saved = (st.initialized, st.strategy, st.hcg,
             topology.get_hybrid_communicate_group())
    st.initialized, st.strategy, st.hcg = False, None, None
    topology.set_hybrid_communicate_group(None)
    yield
    st.initialized, st.strategy, st.hcg = saved[:3]
    topology.set_hybrid_communicate_group(saved[3])


def _llamas():
    P.seed(0)
    jm = JaxLlama(JaxConfig(**TINY))
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def _stacks():
    P.seed(1)
    jnet = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.LayerNorm(16),
                           P.nn.GELU(), P.nn.Linear(16, 4))
    tnet = torch.nn.Sequential(tnn.Linear(8, 16), tnn.LayerNorm(16),
                               torch.nn.GELU(), tnn.Linear(16, 4))
    return jnet, tnet


def _rows(capsys):
    """The table rows (name, class, shape, params) that summary printed."""
    out = capsys.readouterr().out.splitlines()
    return [line for line in out if line.endswith(tuple("0123456789"))
            and "(" in line]


def test_summary_matches_jax_on_llama_and_a_stack(capsys):
    jm, tm = _llamas()
    ids = np.zeros((1, 8), np.int64)
    want = jsum.summary(jm, input=P.to_tensor(ids))
    want_rows = _rows(capsys)
    got = summary(tm, input=torch.from_numpy(ids))
    n = sum(p.numel() for p in tm.parameters())
    assert got == want == {"total_params": n, "trainable_params": n}
    assert _rows(capsys) == want_rows

    jnet, tnet = _stacks()
    want = jsum.summary(jnet, (2, 3, 8))
    want_rows = _rows(capsys)
    assert summary(tnet, (2, 3, 8)) == want
    # the reference's Sequential names its children "0", "1", ... too
    assert [r.replace("Linear", "L") for r in _rows(capsys)] == \
        [r.replace("Linear", "L") for r in want_rows]


def test_flops_match_jax(monkeypatch, capsys):
    jnet, tnet = _stacks()
    assert flops(tnet, (2, 3, 8)) == jsum.flops(jnet, (2, 3, 8)) == \
        6 * (8 * 16 + 16) + 2 * 96 + 96 + 6 * (16 * 4 + 4)
    custom_t = {torch.nn.GELU: lambda m, shape: 7}
    custom_j = {P.nn.GELU: lambda m, shape: 7}
    assert flops(tnet, (2, 3, 8), custom_ops=custom_t, print_detail=True) \
        == jsum.flops(jnet, (2, 3, 8), custom_ops=custom_j,
                      print_detail=True)
    assert "Total Flops" in capsys.readouterr().out

    jm, tm = _llamas()
    real = (jsum._make_inputs, tsum._make_inputs)
    monkeypatch.setattr(jsum, "_make_inputs", lambda size, dt: real[0](
        size, "int32"))
    monkeypatch.setattr(tsum, "_make_inputs", lambda size, dt, dev: real[1](
        size, "int32", dev))
    want = jsum.flops(jm, (1, 8))
    # 8 tokens through every Linear (GQA: k and v project to 2 heads of
    # 8) and 2 FLOPs an element of the 3 RMSNorms
    h, kv, m, v = 32, 16, 48, 64
    assert want == 8 * (2 * h * h + 2 * h * kv + 3 * h * m + h * v) \
        + 3 * 2 * 8 * h
    assert flops(tm, (1, 8)) == want


def test_model_summary_matches_jax(capsys):
    jnet, tnet = _stacks()
    assert Model(tnet).summary() == P.Model(jnet).summary()
    assert Model(tnet).summary((2, 8)) == P.Model(jnet).summary((2, 8))
    tnet[0].weight.requires_grad_(False)
    assert Model(tnet).summary()["trainable_params"] == \
        sum(p.numel() for p in tnet.parameters()) - 8 * 16
    capsys.readouterr()


def _records(path):
    with open(path / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


def test_visualdl_records_match_jax(tmp_path):
    rows = np.random.default_rng(0).integers(0, 64, (2, 9)).astype(np.int32)
    jm, tm = _llamas()
    cfg = LlamaConfig(**TINY)
    jmodel = P.Model(jm, inputs=["ids"], labels=["labels"])
    jmodel.prepare(P.optimizer.SGD(0.1, parameters=jm.parameters()),
                   JaxCriterion(JaxConfig(**TINY)))
    jmodel.fit(P.io.DataLoader(P.io.TensorDataset([rows, rows]),
                               batch_size=2), epochs=2, verbose=0,
               callbacks=[P.callbacks.VisualDL(str(tmp_path / "jax"))])
    tmodel = Model(tm, inputs=["ids"], labels=["labels"])
    tmodel.prepare(SGD(0.1, parameters=tm.parameters()),
                   LlamaPretrainingCriterion(cfg))
    tmodel.fit(io.DataLoader(io.TensorDataset([rows, rows]), batch_size=2),
               epochs=2, verbose=0,
               callbacks=[callbacks.VisualDL(str(tmp_path / "port"))])
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert [(r["kind"], r["step"], sorted(r)) for r in got] == \
        [(r["kind"], r["step"], sorted(r)) for r in want] == \
        [("epoch", 0, ["kind", "loss", "step"]),
         ("epoch", 1, ["kind", "loss", "step"])]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], atol=1e-5, rtol=0)
    assert got[1]["loss"] < got[0]["loss"]
