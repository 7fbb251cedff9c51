"""``Model.fit`` / ``evaluate`` / ``predict`` of paddle_tpu_torch against
paddle_tpu on the CPU: a tiny LLaMA in float32 with the JAX model's
weights transplanted, a ``DataLoader(TensorDataset)`` of numpy token rows
made from a seed (``shuffle=False``: the two packages' shuffles differ),
``AdamW`` with ``ClipGradByGlobalNorm`` and ``LinearWarmup(
CosineAnnealingDecay)`` stepped by the ``LRScheduler`` callback, a
recording callback on each side. Also the DataLoader's batches, the
metrics, ``save``/``load`` and the arguments the port refuses.

Tolerances (float32): losses, evaluation losses and predicted logits
1e-5, as ``test_torch_train.py``; learning rates exactly; metrics to
1e-12 (the same numpy arithmetic).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import framework, io, metric
from paddle_tpu_torch.hapi import Model, callbacks
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32,
            loss_chunk_size=5, fuse_linear_cross_entropy=True)
ROWS, BATCH, SEQ = 10, 2, 9    # 5 steps
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def _rows(seed=0, n=ROWS):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (n, SEQ)).astype(np.int32)


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, 4), 2, 0.0, 1e-2)


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.lrs = [], []

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(self.model._optimizer.get_lr())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return Recorder()


def _jax_side(rows):
    """The JAX fit; also returns the weights before it (numpy)."""
    P.seed(0)
    jm = JaxLlama(JaxConfig(**TINY))
    sd0 = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    model = P.Model(jm, inputs=["ids"], labels=["labels"])
    model.prepare(P.optimizer.AdamW(
        _sched(P.optimizer.lr), parameters=jm.parameters(),
        grad_clip=P.nn.ClipGradByGlobalNorm(0.5)),
        JaxCriterion(JaxConfig(**TINY)).bind(jm))
    rec = _recorder(P.callbacks.Callback)
    model.fit(P.io.DataLoader(P.io.TensorDataset([rows, rows]),
                              batch_size=BATCH, shuffle=False),
              epochs=1, verbose=0,
              callbacks=[P.callbacks.LRScheduler(), rec])
    return sd0, model, rec


def _port_side(sd, rows):
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    model = Model(tm, inputs=["ids"], labels=["labels"])
    model.prepare(AdamW(_sched(tlr), parameters=tm.parameters(),
                        grad_clip=ClipGradByGlobalNorm(0.5)),
                  LlamaPretrainingCriterion(cfg).bind(tm))
    rec = _recorder(callbacks.Callback)
    model.fit(io.DataLoader(io.TensorDataset([rows, rows]),
                            batch_size=BATCH, shuffle=False),
              epochs=1, verbose=0, callbacks=[callbacks.LRScheduler(), rec])
    return model, rec


def test_fit_evaluate_predict_match_jax():
    rows = _rows()
    sd0, jmodel, jrec = _jax_side(rows)
    tmodel, trec = _port_side(sd0, rows)
    assert trec.lrs == jrec.lrs and len(trec.lrs) == ROWS // BATCH
    np.testing.assert_allclose(trec.losses, jrec.losses, atol=ATOL, rtol=0)
    assert tmodel._optimizer._clip_factor.item() < 1

    held = _rows(1, 4)
    # the trained JAX forward as one program (its jit.to_static) for
    # evaluate and predict: op by op, its eager compiles took ~3 s
    P.jit.to_static(jmodel.network)
    data = io.DataLoader(io.TensorDataset([held, held]), batch_size=BATCH)
    jdata = P.io.DataLoader(P.io.TensorDataset([held, held]),
                            batch_size=BATCH)
    got, want = tmodel.evaluate(data, verbose=0), jmodel.evaluate(
        jdata, verbose=0)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL, rtol=0)
    got = tmodel.predict(io.TensorDataset([held]), batch_size=BATCH,
                         stack_outputs=True)
    want = jmodel.predict(P.io.TensorDataset([held]), batch_size=BATCH,
                          stack_outputs=True)
    assert got[0].shape == (4, SEQ, TINY["vocab_size"])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=0)


def test_dataloader_batches_match_jax():
    rows, labels = _rows(2, 7), np.arange(7, dtype=np.int64)
    for kw in (dict(batch_size=3), dict(batch_size=3, drop_last=True),
               dict(batch_size=None)):
        got = list(io.DataLoader(io.TensorDataset([rows, labels]), **kw))
        want = list(P.io.DataLoader(P.io.TensorDataset([rows, labels]),
                                    **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b._data))
    sub = io.Subset(io.TensorDataset([rows]), [5, 1, 3])
    assert [int(b[0][0, 0]) for b in io.DataLoader(sub)] == \
        [rows[5, 0], rows[1, 0], rows[3, 0]]

    class Count(io.IterableDataset):
        def __iter__(self):
            return iter(np.arange(5, dtype=np.int64))
    assert [b.tolist() for b in io.DataLoader(Count(), batch_size=2)] == \
        [[0, 1], [2, 3], [4]]
    perm = [i for b in io.DataLoader(io.TensorDataset([labels]),
                                     batch_size=2, shuffle=True)
            for i in b[0].tolist()]
    assert sorted(perm) == list(range(7))


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((12, 6)).astype(np.float32)
    labels = rng.integers(0, 6, (12, 1))
    probs = rng.random((12, 2)).astype(np.float32)
    binary = rng.integers(0, 2, (12,))
    for t_m, j_m, args in (
            (metric.Accuracy(topk=(1, 3)), P.metric.Accuracy(topk=(1, 3)),
             (logits, labels)),
            (metric.Precision(), P.metric.Precision(), (probs[:, 1], binary)),
            (metric.Recall(), P.metric.Recall(), (probs[:, 1], binary)),
            (metric.Auc(num_thresholds=63), P.metric.Auc(num_thresholds=63),
             (probs, binary))):
        targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
        t_m.update(*t_m.compute(*targs))
        j_m.update(*j_m.compute(*args))
        np.testing.assert_allclose(t_m.accumulate(), j_m.accumulate(),
                                   atol=1e-12, rtol=0)
        assert t_m.name() == j_m.name()
    got = metric.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                          k=2)
    want = P.metric.accuracy(P.to_tensor(logits), P.to_tensor(labels), k=2)
    assert float(got) == float(want)


def test_save_and_load_round_trip_bf16_bits(tmp_path):
    rng = np.random.default_rng(6)
    obj = {"w": torch.from_numpy(rng.standard_normal((3, 5))).to(
               torch.bfloat16), "i": torch.arange(4),
           "nested": [torch.ones(2), {"n": 3, "s": "x"}], "f": 1.5}
    framework.save(obj, str(tmp_path / "a.pdparams"))
    got = framework.load(str(tmp_path / "a.pdparams"))
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            obj["w"])
    assert torch.equal(got["i"], obj["i"]) and got["nested"][1] == \
        {"n": 3, "s": "x"} and got["f"] == 1.5
    assert framework.load(str(tmp_path / "a.pdparams"),
                          return_numpy=True)["w"].dtype == np.float32
    import collections
    import pickle
    with open(tmp_path / "b", "wb") as f:
        pickle.dump({"x": collections.Counter("ab")}, f)
    with pytest.raises(pickle.UnpicklingError, match="Counter"):
        framework.load(str(tmp_path / "b"))


def test_unread_and_unported_arguments_are_refused():
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    model = Model(tm).prepare(AdamW(parameters=tm.parameters()),
                              LlamaPretrainingCriterion(cfg).bind(tm))
    data = io.TensorDataset([_rows(), _rows()])
    for kw in (dict(accumulate_grad_batches=2), dict(drop_last=True)):
        with pytest.raises(NotImplementedError, match="never reads"):
            model.fit(data, verbose=0, **kw)
    # ported since: worker processes, VisualDL and summary
    assert [b[0].tolist() for b in io.DataLoader(data, batch_size=2,
                                                  num_workers=2)] == \
        [b[0].tolist() for b in io.DataLoader(data, batch_size=2)]
    assert callbacks.VisualDL().log_dir == "./log"
    n = sum(p.numel() for p in tm.parameters())
    assert model.summary() == {"total_params": n, "trainable_params": n}
