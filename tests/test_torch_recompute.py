"""Recompute and checkpoint resume in paddle_tpu_torch on the CPU.

- ``recompute`` on equals recompute off BIT FOR BIT, losses and every
  gradient: LLaMA at ``recompute_granularity`` "full" and "core_attn",
  and GPT with hidden and attention dropout 0.1 (the replay draws the
  forward's masks from the model's generator);
- with recompute, the port tracks ``paddle_tpu`` loss for loss (1e-5,
  float32, as ``test_torch_train.py``) for LLaMA and GPT (GPT without
  dropout: the two packages draw masks from different generators);
- ``Model.fit`` under ``amp_configs`` O1 with recompute equals it
  without recompute bit for bit (the replay casts as the forward did,
  though ``Model`` leaves ``auto_cast`` before backward), and tracks
  ``paddle_tpu``'s fit loss for loss to 2e-2 (losses ~ln 64 from bf16
  GEMMs and attention, whose roundings of 2**-8 ``test_torch_amp.py``
  bounds on the logits), one layer, two steps;
- ``Model.save`` after N steps, a fresh ``Model.load``, N more steps
  equals 2N uninterrupted steps bit for bit: bf16 params under
  ``decorate(O2, master_grad=True)``, AdamW with ``L1Decay``,
  ``ClipGradByGlobalNorm`` and ``LinearWarmup(CosineAnnealingDecay)``;
- the refused granularity and options.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import amp, io
from paddle_tpu_torch.distributed.fleet import (recompute,
                                                recompute_sequential)
from paddle_tpu_torch.hapi import Model, callbacks
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import fa_kernel
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.regularizer import L1Decay

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32,
            loss_chunk_size=5, fuse_linear_cross_entropy=True)
STEPS, BATCH, SEQ, LR = 3, 2, 9, 1e-3


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


def _batches(seed=0, vocab=64):
    return np.random.default_rng(seed).integers(
        0, vocab, (STEPS, BATCH, SEQ)).astype(np.int32)


def _loss_and_grads(net, crit, ids):
    net.train()
    ids = torch.from_numpy(ids).long()
    loss = crit(net(ids), ids)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return loss.detach(), grads


def _assert_bit_equal(a, b):
    assert torch.equal(a[0], b[0]), (a[0].item(), b[0].item())
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name


@pytest.mark.parametrize("granularity", ["full", "core_attn"])
def test_llama_recompute_is_bit_equal_to_no_recompute(granularity):
    ids = _batches(1)[0]
    runs = []
    for rc in (False, True):
        cfg = LlamaConfig(**TINY, recompute=rc,
                          recompute_granularity=granularity)
        net = LlamaForCausalLM(cfg, device="cpu", seed=3)
        fa_kernel.reset_stats()
        runs.append(_loss_and_grads(
            net, LlamaPretrainingCriterion(cfg).bind(net), ids))
        # the attention's forward runs again in backward under recompute
        assert fa_kernel.stats["plain_fwd_calls"] == 2 * (1 + rc)
    _assert_bit_equal(*runs)


def test_gpt_recompute_with_dropout_is_bit_equal_to_no_recompute():
    ids = _batches(2)[0]
    runs = []
    for rc in (False, True):
        cfg = GPTConfig.tiny(recompute=rc, hidden_dropout_prob=0.1,
                             attention_dropout_prob=0.1)
        net = GPTForCausalLM(cfg, device="cpu", seed=4)
        crit = LlamaPretrainingCriterion()
        # two forwards: the second draws what it would without recompute
        runs.append([_loss_and_grads(net, crit, ids) for _ in range(2)])
    for a, b in zip(*runs):
        _assert_bit_equal(a, b)
    assert not torch.equal(runs[0][0][0], runs[0][1][0])


def _jax_loop(jm, crit, xs):
    model = P.Model(jm)
    model.prepare(P.optimizer.AdamW(LR, parameters=jm.parameters()), crit)
    return np.asarray(model.train_batch_loop([P.to_tensor(xs)],
                                             [P.to_tensor(xs)])._data)


def _port_loop(tm, crit, xs):
    model = Model(tm)
    model.prepare(AdamW(LR, parameters=tm.parameters()), crit)
    return model.train_batch_loop([xs], [xs]).numpy()


def test_recompute_tracks_jax_loss_for_loss():
    xs = _batches(3)
    P.seed(0)
    jcfg = JaxConfig(**TINY, recompute=True)
    jm = JaxLlama(jcfg)
    cfg = LlamaConfig(**TINY, recompute=True)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    want = _jax_loop(jm, JaxCriterion(jcfg).bind(jm), xs)
    got = _port_loop(tm, LlamaPretrainingCriterion(cfg).bind(tm), xs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    P.seed(0)
    jg = JaxGPT(JaxGPTConfig.tiny(recompute=True))
    gcfg = GPTConfig.tiny(recompute=True)
    tg = GPTForCausalLM(gcfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jg.state_dict().items()}
    tg.load_state_dict(state_dict_from_paddle_tpu(sd, gcfg))
    xs = _batches(4, vocab=gcfg.vocab_size)
    want = _jax_loop(jg, JaxCriterion(), xs)
    got = _port_loop(tg, LlamaPretrainingCriterion(), xs)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_o1_fit_with_recompute_replays_the_casts_and_tracks_jax():
    tiny = dict(TINY, num_hidden_layers=1)
    rows = np.random.default_rng(7).integers(
        0, 64, (2 * BATCH, SEQ)).astype(np.int64)
    P.seed(0)
    jcfg = JaxConfig(**tiny, recompute=True)
    jm = JaxLlama(jcfg)
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    jmodel = P.Model(jm, inputs=["ids"], labels=["labels"])
    jmodel.prepare(P.optimizer.AdamW(LR, parameters=jm.parameters()),
                   JaxCriterion(jcfg).bind(jm), amp_configs={"level": "O1"})
    want = []

    class JRec(P.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            want.append(logs["loss"])
    jmodel.fit(P.io.DataLoader(P.io.TensorDataset([rows, rows]),
                               batch_size=BATCH, shuffle=False),
               verbose=0, callbacks=[JRec()])
    runs = []
    for rc in (True, False):
        cfg = LlamaConfig(**tiny, recompute=rc)
        tm = LlamaForCausalLM(cfg, device="cpu")
        tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
        model = Model(tm, inputs=["ids"], labels=["labels"]).prepare(
            AdamW(LR, parameters=tm.parameters()),
            LlamaPretrainingCriterion(cfg).bind(tm),
            amp_configs={"level": "O1"})
        runs.append(_fit(model, io.TensorDataset([rows, rows]), 2))
    assert runs[0] == runs[1] and len(want) == 2
    np.testing.assert_allclose(runs[0], want, atol=2e-2, rtol=0)


def _resume_model():
    cfg = LlamaConfig(**TINY, recompute=True)
    net = amp.decorate(LlamaForCausalLM(cfg, device="cpu", seed=5),
                       level="O2", dtype="bfloat16", master_grad=True)
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-2, 6), 2, 0.0,
                             1e-2)
    opt = AdamW(sched, beta1=0.9, beta2=0.95, epsilon=1e-5,
                parameters=net.parameters(), weight_decay=L1Decay(1e-4),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    return Model(net, inputs=["ids"], labels=["labels"]).prepare(
        opt, LlamaPretrainingCriterion(cfg).bind(net),
        amp_configs={"level": "O2", "dtype": "bfloat16"})


def _fit(model, data, n):
    losses = []

    class Rec(callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
    model.fit(io.DataLoader(data, batch_size=BATCH, shuffle=False),
              verbose=0, num_iters=n,
              callbacks=[callbacks.LRScheduler(), Rec()])
    return losses


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    n = 3
    rows = np.random.default_rng(6).integers(
        0, 64, (2 * n * BATCH, SEQ)).astype(np.int64)
    data = io.TensorDataset([rows, rows])
    whole = _resume_model()
    want = _fit(whole, data, 2 * n)
    first = _resume_model()
    got = _fit(first, data, n)
    first.save(str(tmp_path / "ckpt"))
    fresh = _resume_model()
    fresh.load(str(tmp_path / "ckpt"))
    got += _fit(fresh, io.Subset(data, range(n * BATCH, 2 * n * BATCH)), n)
    assert got == want
    for (name, a), b in zip(whole.network.state_dict().items(),
                            fresh.network.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh._optimizer._step_count == 2 * n
    assert fresh._optimizer.get_lr() == whole._optimizer.get_lr()


def test_recompute_options_and_refusals():
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(2, 4, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(recompute(lin, x), lin(x))
    seq = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Tanh(),
                              torch.nn.Linear(4, 4))
    y = recompute_sequential({"segments": 2}, seq, x)
    assert torch.allclose(y, seq(x))
    y.sum().backward()
    assert x.grad is not None
    with pytest.raises(NotImplementedError, match="full_attn"):
        recompute(lin, x, granularity="full_attn")
    with pytest.raises(NotImplementedError, match="offload"):
        recompute(lin, x, offload=True)
    with pytest.raises(NotImplementedError, match="full_attn"):
        LlamaForCausalLM(LlamaConfig(**TINY, recompute=True,
                                     recompute_granularity="full_attn"),
                         device="cpu")
