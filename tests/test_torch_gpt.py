"""The GPT slice of paddle_tpu_torch against paddle_tpu on the CPU: a tiny
GPT in float32 with the JAX model's weights transplanted.

- logits, untied and tied head, with and without a right-padding bool
  mask ``[B, 1, 1, S]`` (the segment arms), and through the FlashMask
  branch;
- ``Model.train_batch_loop``: 3 AdamW steps loss for loss against
  ``P.Model`` on right-padded rows (labels -100 on the padding). The JAX
  step traces its dropout draws inside one compiled loop, where the test
  cannot hand both packages the same seeds, so this runs without
  dropout; attention dropout is held at the model's forward instead,
  where the test reads the JAX package's seed of each layer off its
  ``_flash_core_drop`` calls and gives the port the same (the JAX kernels
  in interpret mode, its kernel-dropout switch on);
- the model's generator: one seed decides weights, hidden-dropout masks
  and attention seeds; parameter and FLOP counts; the refusals.

Tolerances (float32): logits 1e-4 and losses 1e-5, as for the LLaMA
(``test_torch_llama.py``, ``test_torch_train.py``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.gpt import GPTConfig as JaxConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     GPTForCausalLMPipe,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu,
                                     state_dict_to_paddle_tpu)
from paddle_tpu_torch.models.gpt import count_params, flops_per_token
from paddle_tpu_torch.ops import fa_kernel
from paddle_tpu_torch.ops import flash_attention as TFA
from paddle_tpu_torch.optimizer import AdamW

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
STEPS, BATCH, SEQ, LR = 3, 2, 16, 1e-3
LENGTHS = (16, 11)      # row 1 right-padded from 11 on


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


def _pair(**kw):
    """The JAX model and the port's, with the same weights."""
    P.seed(0)
    jm = JaxGPT(JaxConfig.tiny(**kw))
    cfg = GPTConfig.tiny(**kw)
    tm = GPTForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm, cfg


def _padding(b, s, lengths):
    mask = np.zeros((b, 1, 1, s), bool)
    for i, n in enumerate(lengths):
        mask[i, ..., :n] = True
    return mask


def _flashmask(s):
    """C=1 FlashMask bounds of two packed documents ``[1, 1, S, 1]``."""
    idx = np.full((1, 1, s, 1), s, np.int32)
    idx[0, 0, : s // 2, 0] = s // 2
    return idx


LOGIT_CASES = [("untied", None), ("untied", "padding"), ("tied", None),
               ("tied", "padding"), ("untied", "flashmask")]


@pytest.mark.parametrize("head,masking", LOGIT_CASES,
                         ids=[f"{h}-{m}" for h, m in LOGIT_CASES])
def test_tiny_gpt_logits_match_jax(head, masking):
    jm, tm, _ = _pair(tie_word_embeddings=head == "tied")
    jm.eval()
    tm.eval()
    ids = np.random.default_rng(0).integers(0, 256, (BATCH, SEQ)).astype(
        np.int32)
    jargs, targs = {}, {}
    if masking == "padding":
        m = _padding(BATCH, SEQ, LENGTHS)
        jargs["attn_mask"] = P.to_tensor(m)
        targs["attn_mask"] = torch.from_numpy(m)
    elif masking == "flashmask":
        idx = _flashmask(SEQ)
        jargs["attn_mask_startend_row_indices"] = P.to_tensor(idx)
        targs["attn_mask_startend_row_indices"] = torch.from_numpy(idx)
    # one program (the JAX package's jit.to_static), not op by op
    want = np.asarray(P.jit.to_static(lambda x: jm(x, **jargs))(
        P.to_tensor(ids))._data)
    fa_kernel.reset_stats()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), **targs).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    assert fa_kernel.stats["plain_fwd_calls"] == 2     # one per layer


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_train_batch_loop_matches_jax_loss_for_loss_on_padded_rows(tie):
    jm, tm, cfg = _pair(tie_word_embeddings=tie)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (STEPS, BATCH, SEQ)).astype(np.int32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                          ids.shape).copy()
    mask = np.broadcast_to(_padding(BATCH, SEQ, LENGTHS),
                           (STEPS, BATCH, 1, 1, SEQ)).copy()
    labels = np.where(mask[:, :, 0, 0, :], ids, -100).astype(np.int32)
    jmodel = P.Model(jm)
    jmodel.prepare(P.optimizer.AdamW(LR, parameters=jm.parameters()),
                   JaxCriterion(JaxConfig.tiny(tie_word_embeddings=tie)))
    want = np.asarray(jmodel.train_batch_loop(
        [P.to_tensor(x) for x in (ids, pos, mask)],
        [P.to_tensor(labels)])._data)
    m = Model(tm)
    m.prepare(AdamW(LR, parameters=tm.parameters()),
              LlamaPretrainingCriterion(cfg))
    fa_kernel.reset_stats()
    got = m.train_batch_loop([ids, pos, mask], [labels])
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_ATOL, rtol=0)
    # every attention call took the plain versions' segment arm
    assert fa_kernel.stats["plain_fwd_calls"] == STEPS * 2
    assert fa_kernel.stats["plain_bwd_calls"] == STEPS * 2
    # the weights after three steps hold every gradient to its JAX
    # counterpart (as in test_torch_train.py), but for the key part of
    # each qkv bias: a bias on every key adds the same q . b_k to a whole
    # row of scores, so its gradient is 0 up to roundoff, which Adam
    # scales up to about lr a step in either framework
    h = cfg.hidden_size
    jsd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tsd = state_dict_to_paddle_tpu(tm.state_dict(), cfg)
    assert sorted(tsd) == sorted(jsd)
    for key in jsd:
        got, want = tsd[key], jsd[key]
        if key.endswith("qkv_proj.bias"):
            got = np.concatenate([got[:h], got[2 * h:]])
            want = np.concatenate([want[:h], want[2 * h:]])
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                   err_msg=key)


DROP_CFG = dict(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=128,
                attention_dropout_prob=0.1)


def test_attention_dropout_matches_jax_at_the_same_seeds(monkeypatch):
    """Training forward with attention dropout 0.1 and right-padded rows:
    the JAX package's kernel-dropout path (interpret mode) draws a seed
    per layer; the test reads them and hands the port the same. The JAX
    forward runs as one program (its ``jit.to_static``; the seeds come
    off the device by a callback): op by op, the interpret-mode kernels'
    eager loops took ~2 s more."""
    import jax
    monkeypatch.setattr(JFA, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(JFA, "_kernel_dropout_enabled", lambda: True)
    seeds = []
    real = JFA._flash_core_drop

    def spy(q, k, v, seed, *rest):
        jax.debug.callback(
            lambda s: seeds.append(int(np.asarray(s).reshape(-1)[0])), seed)
        return real(q, k, v, seed, *rest)
    monkeypatch.setattr(JFA, "_flash_core_drop", spy)
    P.seed(0)
    jm = JaxGPT(JaxConfig.tiny(**DROP_CFG))
    cfg = GPTConfig.tiny(**DROP_CFG)
    tm = GPTForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    jm.train()
    tm.train()
    ids = np.random.default_rng(2).integers(0, 64, (2, 128)).astype(np.int32)
    mask = _padding(2, 128, (128, 90))
    want = np.asarray(P.jit.to_static(lambda x, m: jm(x, None, m))(
        P.to_tensor(ids), P.to_tensor(mask))._data)
    jax.effects_barrier()
    assert len(seeds) == 2
    monkeypatch.setattr(tm.gpt, "attention_seeds", lambda *a: seeds)
    fa_kernel.reset_stats()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), None,
                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    tm.eval()
    with torch.no_grad():
        undropped = tm(torch.from_numpy(ids).long(), None,
                       torch.from_numpy(mask)).numpy()
    assert np.abs(undropped - got).max() > 1e-3   # dropout did act


def test_the_model_seed_decides_weights_and_every_dropout_draw():
    cfg = GPTConfig.tiny(hidden_dropout_prob=0.1,
                         attention_dropout_prob=0.1)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.from_numpy(_padding(2, 16, LENGTHS))

    def run(seed):
        net = GPTForCausalLM(cfg, device="cpu", seed=seed)
        net.train()
        drops = [m for m in net.modules()
                 if type(m).__name__ == "Dropout"]
        assert len(drops) == 1 + cfg.num_hidden_layers   # embed + block
        assert all(d.generator is net.generator for d in drops)
        with torch.no_grad():
            return net(ids, None, mask), net(ids, None, mask)
    (a1, a2), (b1, _) = run(0), run(0)
    assert torch.equal(a1, b1)            # same seed, same run
    assert not torch.equal(a1, a2)        # the generator moved on
    assert not torch.equal(a1, run(1)[0])
    net = GPTForCausalLM(cfg, device="cpu")
    net.eval()
    assert net.gpt.attention_seeds() == [None, None]
    with torch.no_grad():
        assert torch.equal(net(ids, None, mask), net(ids, None, mask))


def test_parameter_and_flop_counts():
    for tie in (False, True):
        cfg = GPTConfig.tiny(tie_word_embeddings=tie)
        net = GPTForCausalLM(cfg, device="cpu")
        assert count_params(cfg) == sum(p.numel() for p in net.parameters())
    big = GPTConfig.gpt3_1_3b()
    assert count_params(big) == 1_418_842_112
    # 6 N over the parameters that multiply + 12 L h S
    assert flops_per_token(big, 2048) == pytest.approx(9.0777e9, rel=1e-4)


def test_unported_gpt_paths_raise():
    net = GPTForCausalLM(GPTConfig.tiny(attention_dropout_prob=0.1),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="pipeline"):
        GPTForCausalLMPipe(GPTConfig.tiny())
    net.train()
    ids = torch.zeros(1, 16, dtype=torch.long)
    idx = torch.from_numpy(_flashmask(16))
    # FlashMask with attention dropout in training: the dense route at
    # the layer's seed from the model's generator
    dense0 = TFA.stats["dense"]
    train = net(ids, attn_mask_startend_row_indices=idx)
    assert TFA.stats["dense"] == dense0 + net.cfg.num_hidden_layers
    assert torch.isfinite(train).all()
    net.eval()
    assert net(ids, attn_mask_startend_row_indices=idx).shape == (1, 16, 256)
    assert TFA.stats["dense"] == dense0 + net.cfg.num_hidden_layers
