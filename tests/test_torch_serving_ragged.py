"""paddle_tpu_torch's unified ragged serving step (``ServingEngine(
ragged=True)``) against paddle_tpu on the CPU.

- The port's ragged engine against the JAX engine with ``ragged=True`` on
  the same transplanted tiny LLaMA: greedy tokens equal token for token,
  through a preemption and through steps that mix a prefill chunk with
  decode lanes; each request's first-token logits within 1e-4 (two
  frameworks' float32 matmuls sum in different orders). Again with GQA
  (4 over 2 heads) and a sliding window shorter than the prompts.
- The port's ragged engine against its own bucketed engine: token for
  token, greedy and seeded-sampled, so the counter-keyed noise is shown
  not to depend on the schedule.
- The reference's dispatch accounting: a mixed step is one dispatch and
  one fetch; the ragged path has at most two program classes, fewer than
  the bucketed path's.
- K5's plan built once for every layer gives the outputs of
  ``ragged_paged_attention``, and its two forms together cover every
  token as the plain version does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import attention as JA
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import attention as TA
from test_torch_paged_attention import MIXED, as_jax, as_torch, ragged_case

TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
ENGINE = dict(page_size=4, max_batch=4, prefill_chunk=8)

# greedy and seeded-sampled requests, the reference's MIXED_REQ
MIXED_REQ = [dict(), dict(do_sample=True, temperature=0.9, seed=7),
             dict(do_sample=True, top_k=5, seed=3), dict(),
             dict(do_sample=True, top_p=0.8, seed=11), dict()]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _transplanted(seed=0, **kw):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY, **kw))
    jm.eval()
    cfg = LlamaConfig(**TINY, **kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def _serve(engine_cls, model, prompts, req_kws=None, max_new=8, **kw):
    """Serve the prompts; returns (tokens per request, {req_id: first
    token's logits row (port) or the dispatch's whole logits (JAX)},
    {req_id: the port's row}, the number of steps that mixed a prefill
    chunk with decode lanes, the engine)."""
    first, rows = {}, {}
    holder = []

    def on_event(ev):
        rid = ev["req_id"]
        if ev["type"] != "token" or rid in first:
            return
        eng = holder[0]
        if isinstance(eng, ServingEngine):
            rows[rid] = eng._rows[rid]
            first[rid] = eng.logits_row(rid).numpy().copy()
        else:
            first[rid] = np.asarray(eng._logits_dev, np.float32)

    opts = dict(ENGINE, num_pages=200, on_event=on_event)
    opts.update(kw)
    if engine_cls is ServingEngine:
        opts["device"] = "cpu"
    eng = engine_cls(model, **opts)
    holder.append(eng)
    req_kws = req_kws or [dict()] * len(prompts)
    rids = [eng.add_request(p, max_new_tokens=max_new, **r)
            for p, r in zip(prompts, req_kws)]
    mixed = 0
    while not eng.scheduler.all_done():
        m = eng.metrics
        d0, p0 = m.decode_steps.value, m.prefill_chunks.value
        eng.step()
        mixed += (m.decode_steps.value > d0 and m.prefill_chunks.value > p0)
    res = eng.results()
    return ([list(map(int, res[r]["tokens"])) for r in rids],
            [first[r] for r in rids], [rows.get(r) for r in rids], mixed,
            eng)


def _against_jax(jm, tm, prompts, **kw):
    jt, jf, _, jmixed, jeng = _serve(JaxServingEngine, jm, prompts,
                                     ragged=True, **kw)
    tt, tf, trows, tmixed, teng = _serve(ServingEngine, tm, prompts,
                                         ragged=True, **kw)
    assert tt == jt
    assert tmixed == jmixed and tmixed > 0, "no mixed prefill+decode step"
    for got, want, row in zip(tf, jf, trows):
        np.testing.assert_allclose(got, want[row], atol=1e-4)
    return jeng, teng


def test_ragged_engine_matches_jax_through_a_preemption():
    jm, tm = _transplanted(seed=1)
    prompts = [np.random.default_rng(1).integers(0, 97, 3).astype(np.int32)
               for _ in range(4)]
    TA.reset_stats()
    jeng, teng = _against_jax(jm, tm, prompts, max_new=12, num_pages=10)
    assert teng.metrics.preemptions.value > 0, "no preemption"
    assert teng.metrics.preemptions.value == jeng.metrics.preemptions.value
    assert TA.stats["kernel_launches"] == 0
    assert TA.stats["plain_calls"] == (
        TINY["num_hidden_layers"] * teng.metrics.step_dispatches.value)
    assert teng.cache.free_pages == teng.cache.allocatable_pages


def test_ragged_engine_matches_jax_with_gqa_and_a_window():
    jm, tm = _transplanted(seed=2, num_key_value_heads=2, sliding_window=6)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 97, n).astype(np.int32)
               for n in (17, 4, 11, 23)]
    _against_jax(jm, tm, prompts, max_new=6)


@pytest.mark.parametrize("num_pages", [200, 10])
def test_ragged_streams_equal_the_bucketed_streams(num_pages):
    """Greedy and seeded-sampled streams, with and without preemption:
    a token's noise depends on its request's (seed, token index) alone,
    not on the lane or the batch it rides in."""
    _, tm = _transplanted(seed=3)
    rng = np.random.default_rng(3)
    n = 6 if num_pages == 200 else 4
    prompts = [rng.integers(0, 97, int(rng.integers(3, 14)))
               .astype(np.int32) for _ in range(n)]
    kws = MIXED_REQ[:n]
    base, *_ = _serve(ServingEngine, tm, prompts, kws, max_new=10,
                      num_pages=num_pages)
    got, _, _, _, reng = _serve(ServingEngine, tm, prompts, kws,
                                max_new=10, num_pages=num_pages,
                                ragged=True)
    assert got == base
    if num_pages == 10:
        assert reng.metrics.preemptions.value > 0, "no preemption"


def test_mixed_step_one_dispatch_one_fetch():
    """A step carrying a prefill chunk AND decode lanes issues ONE
    dispatch and ONE host fetch; the ragged path has <= 2 classes."""
    _, tm = _transplanted()
    rng = np.random.default_rng(3)
    eng = ServingEngine(tm, page_size=4, num_pages=200, max_batch=4,
                        prefill_chunk=8, ragged=True, device="cpu")
    eng.add_request(rng.integers(0, 97, 4).astype(np.int32),
                    max_new_tokens=10)
    eng.step()                       # short prompt finishes prefill
    eng.add_request(rng.integers(0, 97, 30).astype(np.int32),
                    max_new_tokens=4)
    mixed = 0
    m = eng.metrics
    for _ in range(6):
        d0, f0 = m.step_dispatches.value, m.step_fetches.value
        s0, p0 = m.decode_steps.value, m.prefill_chunks.value
        eng.step()
        if m.decode_steps.value > s0 and m.prefill_chunks.value > p0:
            mixed += 1
            assert m.step_dispatches.value - d0 == 1
            assert m.step_fetches.value - f0 == 1
    assert mixed > 0, "no mixed prefill+decode step occurred"
    eng.run()
    assert m.step_program_classes.value <= 2


def test_bucketed_path_counts_more_classes():
    _, tm = _transplanted()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, int(rng.integers(3, 14)))
               .astype(np.int32) for _ in range(6)]
    *_, beng = _serve(ServingEngine, tm, prompts, max_new=6)
    *_, reng = _serve(ServingEngine, tm, prompts, max_new=6, ragged=True)
    assert reng.metrics.step_program_classes.value <= 2
    assert beng.metrics.step_program_classes.value \
        > reng.metrics.step_program_classes.value
    ex = reng.metrics.export()
    assert ex["step_dispatches"] > 0 and ex["step_program_classes"] <= 2


@pytest.mark.parametrize("window", [None, 5])
def test_the_plan_built_once_gives_the_ragged_entry(window):
    """K5's plan from ``ragged_plan`` (built once a step, before the layer
    loop) through ``planned_attention`` equals ``ragged_paged_attention``
    and the JAX package's; and the plan's two forms, the split form's
    plain passes for its split tokens and the plain version for its
    tiles' tokens, cover every token once with the same result."""
    c = ragged_case(MIXED, pad_tokens=3, pad_lanes=1, seed=5)
    k, v = as_torch(c)
    q, pt, cl, ql, qoff = (torch.from_numpy(c[n]) for n in
                           ("q", "pt", "cl", "ql", "qoff"))
    kw = dict(scale=0.35, window=window)
    plan = TA.ragged_plan(ql, qoff, q.shape[0], q.shape[1] // k.shape[2])
    got = TA.planned_attention(q, k, v, pt, cl, plan, **kw)
    want = TA.ragged_paged_attention(q, k, v, pt, cl, ql, qoff, **kw)
    assert torch.equal(got, want)
    n = int(ql.sum())
    jk, jv = as_jax(c)
    jwant = np.asarray(JA.ragged_paged_attention(
        jnp.asarray(c["q"]), jk, jv, *(jnp.asarray(c[x]) for x in
                                        ("pt", "cl", "ql", "qoff")), **kw))
    np.testing.assert_allclose(got[:n].numpy(), jwant[:n], atol=1e-5)
    split_tok, tiles = plan.tiles
    m, l, acc = TA.split_partials_plain(q, k, v, pt, cl, plan.positions,
                                        plan.token_lane, **kw)
    forms = torch.where(split_tok.bool()[:, None, None],
                        TA.combine_splits_plain(m, l, acc), got)
    tiled = torch.zeros(q.shape[0], dtype=torch.int32)
    for first, count in tiles.tolist():
        tiled[first:first + count] += 1
    assert torch.equal(tiled + split_tok, torch.ones_like(tiled))
    assert tiled[:n].sum() > 0 and split_tok[:n].sum() > 0
    torch.testing.assert_close(forms, want, atol=1e-5, rtol=0)
