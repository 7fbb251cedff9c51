"""The training slice of paddle_tpu_torch against paddle_tpu on the CPU:
a tiny LLaMA in float32 with the JAX model's weights transplanted, the
pretraining criterion (fused chunked head + cross entropy, with an
uneven tail chunk, and the plain one) and AdamW, driven through
``Model.train_batch_loop`` on both sides from the same numpy batches.

Tolerances (float32): losses 1e-5 (the same function, two frameworks'
summation orders). Weights after three AdamW steps at lr 1e-3 agree to
2e-5 here, which also holds the gradients of every step to each other:
Adam moves a weight by about lr * sign(g) per step whatever g's size,
so a gradient whose sign differed between the frameworks would move the
weight apart by up to 2 * lr a step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.hapi import Model
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion,
                                     state_dict_from_paddle_tpu,
                                     state_dict_to_paddle_tpu)
from paddle_tpu_torch.ops import adamw_kernel, fa_kernel
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32,
            loss_chunk_size=3)
STEPS, BATCH, SEQ, LR = 3, 2, 9, 1e-3   # S - 1 = 8 = two chunks of 3 + 2
ATOL = 1e-5
WEIGHT_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fleet_set_aside():
    """``P.Model`` trains through its single-device stepper only while
    fleet is not initialized, and a test elsewhere in the process may
    leave it initialized: set that state aside here and put it back."""
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


def _batches(seed=0):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)


def _pair(fused):
    """The JAX model and the port's, with the same weights."""
    kw = {**TINY, "fuse_linear_cross_entropy": fused}
    P.seed(0)
    jm = JaxLlama(JaxConfig(**kw))
    cfg = LlamaConfig(**kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm, cfg


def _port_model(tm, cfg):
    m = Model(tm)
    m.prepare(AdamW(LR, parameters=tm.parameters()),
              LlamaPretrainingCriterion(cfg).bind(tm))
    return m


@pytest.mark.parametrize("fused", [True, False])
def test_train_batch_loop_matches_jax_loss_for_loss(fused):
    jm, tm, cfg = _pair(fused)
    xs = _batches()
    jcrit = JaxCriterion(JaxConfig(**{**TINY,
                                      "fuse_linear_cross_entropy": fused}))
    if fused:
        jcrit.bind(jm)
    jmodel = P.Model(jm)
    jmodel.prepare(P.optimizer.AdamW(LR, parameters=jm.parameters()), jcrit)
    want = np.asarray(jmodel.train_batch_loop(
        [P.to_tensor(xs)], [P.to_tensor(xs)])._data)

    fa_kernel.reset_stats()
    adamw_kernel.reset_stats()
    got = _port_model(tm, cfg).train_batch_loop([xs], [xs])
    assert got.shape == (STEPS,) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # every attention call and every optimizer step took a plain version
    assert fa_kernel.stats["plain_fwd_calls"] == STEPS * 2
    assert fa_kernel.stats["plain_bwd_calls"] == STEPS * 2
    assert adamw_kernel.stats["plain_calls"] == STEPS

    jsd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tsd = state_dict_to_paddle_tpu(tm.state_dict(), cfg)
    assert sorted(tsd) == sorted(jsd)
    for key in jsd:
        np.testing.assert_allclose(tsd[key], jsd[key], atol=WEIGHT_ATOL,
                                   rtol=0, err_msg=key)


def test_train_batch_loop_equals_sequential_train_batch():
    xs = _batches(1)
    _, tm_a, cfg = _pair(True)
    ma = _port_model(tm_a, cfg)
    seq = [ma.train_batch([xs[i]], [xs[i]]) for i in range(STEPS)]
    _, tm_b, _ = _pair(True)
    loop = _port_model(tm_b, cfg).train_batch_loop([xs], [xs])
    np.testing.assert_allclose(loop.numpy(), seq, atol=1e-6, rtol=0)
    for (name, a), b in zip(tm_a.state_dict().items(),
                            tm_b.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_fused_loss_and_grads_equal_the_unfused_ones():
    """Chunks of 3 over 8 positions with an uneven tail and an ignored
    label: the chunked head + CE equals the plain CE over full logits,
    in value and in the gradients of the hidden state and head."""
    _, tm, cfg = _pair(True)
    ids = torch.from_numpy(_batches(2)[0]).long()
    labels = ids.clone()
    labels[0, 4] = -100
    tm.train()
    hidden = tm(ids)
    assert hidden._fused_hidden and hidden.shape[-1] == cfg.hidden_size
    crit = LlamaPretrainingCriterion(cfg).bind(tm)
    h = hidden.detach().requires_grad_()
    fused = crit(_marked(h), labels)
    g_fused = torch.autograd.grad(fused, (h, tm.lm_head.weight))
    plain = crit(tm.lm_head(h), labels)
    g_plain = torch.autograd.grad(plain, (h, tm.lm_head.weight))
    torch.testing.assert_close(fused, plain, atol=1e-6, rtol=0)
    for a, b in zip(g_fused, g_plain):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(RuntimeError, match="bind"):
        LlamaPretrainingCriterion(cfg)(hidden, labels)


def test_fused_ce_keeps_float32_logits_in_bf16():
    """bf16 hidden state and head: the chunked CE's logits are the head
    product's float32 accumulator, as the JAX ``_fused_ce_fn``'s
    ``preferred_element_type=float32`` keeps them. Loss to 2e-6 (logits
    rounded to bf16 would move it by ~1e-5); gradients (bf16 on both
    sides) to 1e-2 of their norm."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models.llama import _fused_ce_fn
    from paddle_tpu_torch.models.llama import _fused_ce

    rng = np.random.default_rng(3)
    b, s, h, v, chunk = 2, 41, 64, 512, 16     # 40 = 2 chunks + tail 8
    hid = rng.standard_normal((b, s, h)).astype(np.float32)
    w = (0.3 * rng.standard_normal((v, h))).astype(np.float32)
    lab = rng.integers(0, v, (b, s)).astype(np.int32)
    lab[1, 7] = -100
    jh, jw = (jnp.asarray(x, jnp.bfloat16) for x in (hid, w.T))
    # jitted: one compile, where op by op the scan's eager compiles took
    # seconds
    want, (jgh, jgw) = jax.jit(jax.value_and_grad(
        _fused_ce_fn(-100, v, chunk), argnums=(0, 1)))(jh, jw,
                                                       jnp.asarray(lab))
    th = torch.from_numpy(hid).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    got = _fused_ce(th, tw, torch.from_numpy(lab).long(), -100, chunk)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=2e-6, rtol=0)
    for g, jg in ((th.grad, jgh), (tw.grad, jgw.T)):
        assert g.dtype == torch.bfloat16
        ref = np.asarray(jg, np.float32)
        err = np.linalg.norm(g.float().numpy() - ref) / np.linalg.norm(ref)
        assert err < 1e-2, err


def _marked(h):
    h._fused_hidden = True
    return h


# -- Mistral: the sliding window, and packed documents -----------------------

MISTRAL = dict(sliding_window=8, num_key_value_heads=2)
MISTRAL_SEQ = 32


def _mistral_pair():
    """``LlamaConfig.tiny(sliding_window=8, num_key_value_heads=2)`` in
    both packages, the JAX model's weights in the port's."""
    P.seed(0)
    jm = JaxLlama(JaxConfig.tiny(**MISTRAL))
    cfg = LlamaConfig.tiny(**MISTRAL)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm, cfg


def test_mistral_window_train_batch_loop_matches_jax_loss_for_loss():
    """The window (8 of 32 positions) runs through flashmask_attention
    on both sides: K6's plain version and the banded K2/K3 here."""
    jm, tm, cfg = _mistral_pair()
    xs = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (STEPS, BATCH, MISTRAL_SEQ)).astype(np.int32)
    jmodel = P.Model(jm)
    jmodel.prepare(P.optimizer.AdamW(LR, parameters=jm.parameters()),
                   JaxCriterion(JaxConfig.tiny(**MISTRAL)))
    want = np.asarray(jmodel.train_batch_loop(
        [P.to_tensor(xs)], [P.to_tensor(xs)])._data)
    fa_kernel.reset_stats()
    got = _port_model(tm, cfg).train_batch_loop([xs], [xs])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    layers = cfg.num_hidden_layers
    assert fa_kernel.stats["plain_fwd_calls"] == STEPS * layers
    assert fa_kernel.stats["plain_bwd_calls"] == STEPS * layers


def _packed_batch(seed, vocab):
    """Two rows of packed documents: ids, position ids that restart at
    each document, and the C=1 ``startend_row_indices [B, 1, S, 1]`` whose
    value at key j is the end of j's document."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (BATCH, MISTRAL_SEQ)).astype(np.int32)
    pos = np.zeros((BATCH, MISTRAL_SEQ), np.int32)
    idx = np.zeros((BATCH, 1, MISTRAL_SEQ, 1), np.int32)
    for b, lens in enumerate(((5, 14, 13), (20, 12))):
        lo = 0
        for n in lens:
            pos[b, lo:lo + n] = np.arange(n)
            idx[b, 0, lo:lo + n, 0] = lo + n
            lo += n
    return ids, pos, idx


def test_packed_documents_step_by_hand_matches_jax():
    """``attn_mask_startend_row_indices`` with the window folded in
    (column-wise min), two steps by hand in both packages: forward,
    criterion, backward, the optimizer's step, clear_grad. The loss and
    the first layer's q_proj / k_proj gradients agree. The JAX package's
    forward and criterion run as one program (its ``jit.to_static``),
    which its backward differentiates: op by op, the first step's eager
    compiles took ~13 s of this test."""
    jm, tm, cfg = _mistral_pair()
    jcrit = JaxCriterion(JaxConfig.tiny(**MISTRAL))
    jopt = P.optimizer.AdamW(LR, parameters=jm.parameters())

    @P.jit.to_static
    def jax_loss(ids, pos, idx):
        return jcrit(jm(ids, position_ids=pos,
                        attn_mask_startend_row_indices=idx), ids)
    tcrit = LlamaPretrainingCriterion(cfg)
    topt = AdamW(LR, parameters=tm.parameters())
    jattn, tattn = jm.llama.layers[0].self_attn, tm.llama.layers[0].self_attn
    tm.train()
    for step in range(2):
        ids, pos, idx = _packed_batch(step, cfg.vocab_size)
        jloss = jax_loss(P.to_tensor(ids), P.to_tensor(pos),
                         P.to_tensor(idx))
        jloss.backward()
        tids = torch.from_numpy(ids).long()
        tloss = tcrit(tm(tids, position_ids=torch.from_numpy(pos).long(),
                         attn_mask_startend_row_indices=torch.from_numpy(
                             idx)), tids)
        tloss.backward()
        np.testing.assert_allclose(tloss.item(), float(jloss._data),
                                   atol=ATOL, rtol=0)
        for name in ("q_proj", "k_proj"):
            jg = np.asarray(getattr(jattn, name).weight.grad._data)
            tg = getattr(tattn, name).weight.grad.numpy()
            np.testing.assert_allclose(tg, jg.T, atol=1e-4, rtol=0,
                                       err_msg=f"step {step} {name}")
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
