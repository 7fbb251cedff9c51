"""Speculative decoding in paddle_tpu_torch's ServingEngine
(``draft_model=``, ``speculative_k=``) against paddle_tpu on the CPU, the
counterparts of tests/test_serving_spec.py.

Verification is deterministic-sample matching: the ``[B, k+1]`` verify
step recomputes the target's own counter-keyed sample at every position
(token t is a pure function of (weights, history, seed, t)), so the
speculative engine's streams equal the plain engine's, greedy and
sampled, whatever the draft; a self-draft accepts every usable proposal.

- The allocator's rollback (``free_tail``), a fork's shared pages only
  decref'd.
- The verify step's logits against one-token decode, and
  ``fused_sample_multi``'s per-position keys.
- Greedy streams and the acceptance counts against the JAX engine on the
  same transplanted weights, prompts and draft (float32; one JAX run for
  the module). Sampled streams are held within the port only (threefry
  against the counter hash is a recorded difference).
- Streams against the port's plain engine: a random draft, a self-draft
  (acceptance exactly 1.0), under preemption, with forks, eos inside an
  accepted prefix, the per-request opt-out; the ragged step's
  speculative lanes against the bucketed speculative engine. Both page
  pools return to ``allocatable_pages`` after every run.
- Admission reserves k+1 slots a lane; the guards; the metrics.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.serving import (PagedKVCache, ServingEngine,
                                      ServingMetrics)
from paddle_tpu_torch.serving import sampling as TS
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

ENG_KW = dict(page_size=4, num_pages=200, max_batch=8, prefill_chunk=8)
K = 3


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(layers, hidden):
    return dict(vocab_size=97, hidden_size=hidden,
                intermediate_size=2 * hidden, num_hidden_layers=layers,
                num_attention_heads=4, max_position_embeddings=64)


def tiny(seed=0, layers=2, hidden=32):
    return LlamaForCausalLM(LlamaConfig(**_cfg(layers, hidden)),
                            device="cpu", seed=seed)


def tiny_draft(seed=5):
    """A narrow 1-layer draft: random weights, so it proposes little the
    target accepts; the streams must not depend on it."""
    return tiny(seed, layers=1, hidden=16)


def transplanted(seed, layers, hidden):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**_cfg(layers, hidden)))
    jm.eval()
    cfg = LlamaConfig(**_cfg(layers, hidden))
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def prompts_of(n, base=0, lo=3):
    return [np.random.default_rng(base + i).integers(0, 97, lo + i)
            .astype(np.int32) for i in range(n)]


def mixed_requests(n=8):
    """Greedy and seeded-sampled lanes interleaved, with temperature,
    top-k and top-p on the sampled ones (the reference's sweep)."""
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append({})
        elif i % 4 == 1:
            out.append(dict(do_sample=True, seed=100 + i, temperature=0.9,
                            top_k=5))
        else:
            out.append(dict(do_sample=True, seed=200 + i, temperature=1.3,
                            top_p=0.8))
    return out


def run_engine(model, prompts, req_kws, max_new=6, engine=ServingEngine,
               **ekw):
    kw = dict(ENG_KW, **ekw)
    if engine is ServingEngine:
        kw["device"] = "cpu"
    eng = engine(model, **kw)
    rids = [eng.add_request(p, max_new_tokens=max_new, **r)
            for p, r in zip(prompts, req_kws)]
    res = eng.run()
    return [res[r]["tokens"] for r in rids], eng


def pools_returned(eng):
    for c in (eng.cache, eng._draft_cache):
        assert c.free_pages == c.allocatable_pages


# ---------------------------------------------------------------------------
# allocator: free_tail rollback


def tiny_cache(**kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 9)
    return PagedKVCache(1, 1, 4, device="cpu", **kw)


class TestFreeTail:
    def test_rollback_releases_whole_pages_only(self):
        c = tiny_cache()
        c.alloc_seq("a")
        c.append_slots("a", 11)            # 3 pages, the last 3/4 full
        free0 = c.free_pages
        c.free_tail("a", 9)                # still 3 pages
        assert c.free_pages == free0 and c.seq_len("a") == 9
        c.free_tail("a", 4)                # 1 page kept, 2 released
        assert c.free_pages == free0 + 2
        slots, _ = c.append_slots("a", 8)  # regrown with no aliasing
        assert len(set(slots.tolist())) == 8

    def test_rollback_to_zero_and_guards(self):
        c = tiny_cache()
        c.alloc_seq("a")
        c.append_slots("a", 6)
        c.free_tail("a", 0)
        assert c.seq_len("a") == 0 and c.free_pages == 8
        with pytest.raises(ValueError, match="outside"):
            c.free_tail("a", 1)
        with pytest.raises(KeyError):
            c.free_tail("nope", 0)

    def test_fork_shared_pages_only_decref(self):
        c = tiny_cache()
        c.alloc_seq("p")
        c.append_slots("p", 8)             # 2 full pages
        c.fork("p", "c")
        c.append_slots("c", 4)             # a page of the child's own
        free0 = c.free_pages
        c.free_tail("c", 8)
        assert c.free_pages == free0 + 1   # only the child's page
        assert c.seq_len("p") == 8 and c.seq_len("c") == 8
        for p in c._tables["p"]:
            assert c.refcount(p) == 2      # shared pages survive for both
        # rolling the child back INTO the shared pages decrefs them only
        c.free_tail("c", 0)
        assert c.free_pages == free0 + 1
        assert all(c.refcount(p) == 1 for p in c._tables["p"])
        c.free_seq("c")
        c.free_seq("p")
        assert c.free_pages == 8


# ---------------------------------------------------------------------------
# the verify step


def test_fused_sample_multi_keys_position_j_at_steps0_plus_j():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 4, 11, generator=g)
    samp = (torch.tensor([True, False, True]),
            torch.tensor([0.9, 1.0, 1.3]), torch.tensor([5, 0, 0]),
            torch.tensor([1.0, 1.0, 0.8]), torch.tensor([7, 8, 9]))
    steps0 = torch.tensor([0, 5, 12], dtype=torch.int32)
    tok, lp = TS.fused_sample_multi(logits, *samp, steps0)
    for j in range(4):
        t1, l1 = TS.fused_sample(logits[:, j], *samp, steps0 + j)
        assert torch.equal(tok[:, j], t1) and torch.equal(lp[:, j], l1)


def test_extend_logits_match_sequential_decode():
    """The [1, k+1] verify step's logits at each position equal k+1
    one-token decode steps over the paged cache at 1e-5."""
    m = tiny(seed=4)
    prompt = prompts_of(1, 4, 7)[0]
    eng = ServingEngine(m, device="cpu", **ENG_KW)
    eng.add_request(prompt, max_new_tokens=K + 2)
    seq_logits = []
    while not eng.scheduler.all_done():
        evs = eng.step()
        if any(e["type"] == "token" for e in evs):
            seq_logits.append(eng.last_logits[0].clone())
    spec = ServingEngine(m, draft_model=m, speculative_k=K, device="cpu",
                         **ENG_KW)
    spec.add_request(prompt, max_new_tokens=K + 2)
    evs = []
    while not any(e["type"] == "token" for e in evs):
        evs += spec.step()                 # the prefill emits token 1
    spec.step()                            # the first round
    ml = spec.last_logits
    assert ml.shape == (1, K + 1, 97)
    for j in range(K + 1):
        torch.testing.assert_close(ml[0, j], seq_logits[1 + j], rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX engine (greedy, float32, same weights and draft)


# the JAX comparison: two lanes (buckets 1 and 2 only: few JAX programs)
JAX_KW = dict(max_batch=2, prefill_chunk=4, max_new=8)


@pytest.fixture(scope="module")
def jax_spec_run():
    """One JAX speculative run of 6 greedy prompts whose draft is the
    target with its weights perturbed (it agrees with the target on some
    proposals, not all), and the port's models with the same weights."""
    jm, tm = transplanted(0, 2, 32)
    rng = np.random.default_rng(1)
    sd = {k: np.asarray(v._data) + 0.01 * rng.standard_normal(
        v._data.shape).astype(np.float32) for k, v in jm.state_dict().items()}
    cfg = LlamaConfig(**_cfg(2, 32))
    jd = JaxLlama(JaxLlamaConfig(**_cfg(2, 32)))
    jd.set_state_dict(sd)
    jd.eval()
    td = LlamaForCausalLM(cfg, device="cpu")
    td.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    prompts = prompts_of(6)
    toks, eng = run_engine(jm, prompts, [{}] * 6, engine=JaxServingEngine,
                           draft_model=jd, speculative_k=K, **JAX_KW)
    ex = eng.metrics.export()
    return dict(tm=tm, td=td, prompts=prompts, tokens=toks,
                counts={k: ex[k] for k in (
                    "spec_rounds", "spec_draft_tokens",
                    "spec_accepted_tokens", "spec_fallbacks")})


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_streams_and_acceptance_match_jax(jax_spec_run, ragged):
    r = jax_spec_run
    assert 0 < r["counts"]["spec_accepted_tokens"] \
        < r["counts"]["spec_draft_tokens"]
    toks, eng = run_engine(r["tm"], r["prompts"], [{}] * 6,
                           draft_model=r["td"], speculative_k=K,
                           ragged=ragged, **JAX_KW)
    assert toks == r["tokens"]
    ex = eng.metrics.export()
    got = {k: ex[k] for k in r["counts"]}
    want = dict(r["counts"])
    if ragged:  # the rounds interleave with prefill chunks otherwise
        got.pop("spec_rounds")
        want.pop("spec_rounds")
    assert got == want
    pools_returned(eng)


# ---------------------------------------------------------------------------
# token exactness against the port's plain engine


def test_8way_exactness_random_draft():
    """A random draft (few acceptances) still gives the plain engine's
    streams, greedy and sampled."""
    m = tiny()
    prompts, kws = prompts_of(8), mixed_requests()
    base, _ = run_engine(m, prompts, kws)
    spec, eng = run_engine(m, prompts, kws, draft_model=tiny_draft(),
                           speculative_k=K)
    assert base == spec
    assert eng.metrics.spec_rounds.value > 0
    pools_returned(eng)


def test_8way_exactness_and_full_acceptance_self_draft():
    m = tiny(seed=1)
    prompts, kws = prompts_of(8, 10, 4), mixed_requests()
    base, _ = run_engine(m, prompts, kws)
    spec, eng = run_engine(m, prompts, kws, draft_model=m, speculative_k=K)
    assert base == spec
    ex = eng.metrics.export()
    assert ex["spec_draft_tokens"] > 0
    assert ex["spec_accepted_tokens"] == ex["spec_draft_tokens"]
    assert ex["spec_acceptance_rate"] == 1.0
    # one fetch a round: the propose dispatch reads nothing back
    assert ex["step_fetches"] == ex["spec_rounds"] + ex["prefill_chunks"]
    pools_returned(eng)


@pytest.mark.parametrize("ragged", [False, True])
def test_exactness_under_preemption(ragged):
    """Page pressure preempts lanes mid-speculation; recompute and the
    draft's catch-up reproduce the streams."""
    m = tiny(seed=2)
    prompts = [np.random.default_rng(2).integers(0, 97, 3).astype(np.int32)
               for _ in range(4)]
    base, _ = run_engine(m, prompts, [{}] * 4, max_new=12, num_pages=64,
                         max_batch=4)
    spec, eng = run_engine(m, prompts, [{}] * 4, max_new=12, num_pages=12,
                           max_batch=4, draft_model=tiny_draft(seed=7),
                           speculative_k=2, ragged=ragged)
    assert base == spec
    assert eng.metrics.preemptions.value > 0, "no preemption forced"
    pools_returned(eng)


def test_exactness_with_forks():
    """n > 1: the children share the prompt's pages and start with no
    draft state; their first round pays the catch-up."""
    m = tiny(seed=3)
    prompt = prompts_of(1, 3, 9)[0]
    kws = [dict(do_sample=True, seed=11, n=3)]

    def collect(**ekw):
        _, eng = run_engine(m, [prompt], kws, max_new=5, **ekw)
        return sorted(tuple(v["tokens"]) for v in eng.results().values()), \
            eng

    base, _ = collect()
    spec, eng = collect(draft_model=m, speculative_k=2)
    assert base == spec and len(spec) == 3
    assert eng.metrics.cow_copies.value > 0
    pools_returned(eng)


def test_eos_mid_accepted_prefix_stops_exactly():
    m = tiny(seed=4)
    prompt = prompts_of(1, 44, 5)[0]
    ref, _ = run_engine(m, [prompt], [{}], max_new=8)
    eos = ref[0][2]                        # stop at the third token
    assert eos not in ref[0][:2]
    eng = ServingEngine(m, draft_model=m, speculative_k=4, eos_token_id=eos,
                        device="cpu", **ENG_KW)
    rid = eng.add_request(prompt, max_new_tokens=8)
    res = eng.run()[rid]
    assert res["tokens"] == ref[0][:3] and res["finish_reason"] == "stop"
    pools_returned(eng)


def test_per_request_opt_out():
    m = tiny(seed=5)
    prompt = prompts_of(1, 5, 5)[0]
    want, _ = run_engine(m, [prompt], [{}])
    eng = ServingEngine(m, draft_model=m, speculative_k=K, device="cpu",
                        **ENG_KW)
    rid = eng.add_request(prompt, max_new_tokens=6, speculative=False)
    assert eng.run()[rid]["tokens"] == want[0]
    assert eng.metrics.spec_rounds.value == 0   # plain decode only
    # opted-out and speculative lanes side by side
    r1 = eng.add_request(prompt, max_new_tokens=6, speculative=False)
    r2 = eng.add_request(prompt, max_new_tokens=6)
    res = eng.run()
    assert eng.metrics.spec_rounds.value > 0
    assert res[r1]["tokens"] == want[0] and res[r2]["tokens"] == want[0]
    pools_returned(eng)


def test_ragged_speculative_lanes_match_the_bucketed_rounds():
    """Verify lanes (q = k+1) ride the token-packed step beside plain
    lanes and prefill chunks: the bucketed speculative engine's streams,
    one dispatch a step beside the draft's, at most two step classes."""
    m = tiny(seed=6)
    prompts, kws = prompts_of(8, 60, 5), mixed_requests()
    kws[3] = dict(kws[3], speculative=False)
    draft = tiny_draft(seed=9)
    bucketed, _ = run_engine(m, prompts, kws, max_new=7, draft_model=draft,
                             speculative_k=K)
    ragged, eng = run_engine(m, prompts, kws, max_new=7, draft_model=draft,
                             speculative_k=K, ragged=True)
    assert ragged == bucketed
    ex = eng.metrics.export()
    assert ex["step_program_classes"] <= 2 and ex["spec_rounds"] > 0
    assert eng._ragged_tok_mixed == 8 * (K + 1) + 8
    pools_returned(eng)


def test_guards():
    m = tiny(seed=7)
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(m, speculative_k=2, device="cpu", **ENG_KW)
    with pytest.raises(ValueError, match="speculative_k"):
        ServingEngine(m, draft_model=m, speculative_k=0, device="cpu",
                      **ENG_KW)
    with pytest.raises(ValueError, match="speculative_k"):
        ServingEngine(m, draft_model=m, speculative_k=17, device="cpu",
                      **ENG_KW)
    other = LlamaForCausalLM(LlamaConfig(**dict(_cfg(1, 16), vocab_size=50)),
                             device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(m, draft_model=other, device="cpu", **ENG_KW)
    short = LlamaForCausalLM(LlamaConfig(**dict(
        _cfg(1, 16), max_position_embeddings=32)), device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ServingEngine(m, draft_model=short, device="cpu", **ENG_KW)
    with pytest.raises(TypeError, match="draft_model"):
        ServingEngine(m, draft_model=object(), device="cpu", **ENG_KW)
    assert ServingEngine(m, draft_model=m, device="cpu",
                         **ENG_KW).spec_k == 4


# ---------------------------------------------------------------------------
# admission reserves the worst-case verify burst


class TestSpecAdmission:
    def test_scheduler_reserves_k_token_growth(self):
        c = tiny_cache()
        spec = Scheduler(c, max_batch=4, prefill_chunk=8,
                         watermark_frac=0.25, spec_reserve_tokens=4)
        plain = Scheduler(c, max_batch=4, prefill_chunk=8,
                          watermark_frac=0.25)
        r = Request(prompt=np.zeros(8, np.int32), max_new_tokens=4)
        assert spec.worst_case_need(r) == 4   # 8 + 1 + 4 tokens
        assert plain.worst_case_need(r) == 3
        a = Request(prompt=np.zeros(8, np.int32), max_new_tokens=4)
        b = Request(prompt=np.zeros(8, np.int32), max_new_tokens=4)
        spec.add(a)
        spec.add(b)
        spec.schedule(0.0)
        assert a.state == "prefilling" and b.state == "waiting"

    def test_running_lanes_reserve_next_burst(self):
        c = tiny_cache()
        s = Scheduler(c, max_batch=4, prefill_chunk=8, watermark_frac=0.25,
                      spec_reserve_tokens=4)
        a = Request(prompt=np.zeros(4, np.int32), max_new_tokens=8)
        s.add(a)
        s.schedule(0.0)
        c.alloc_seq(a.seq_id)
        c.append_slots(a.seq_id, 4)
        s.prefill_advanced(a, 4)
        assert a.state == "running"
        assert s._committed_pages() == s.worst_case_need(a) > 0

    def test_verify_burst_never_preempts_admitted_decode(self):
        m = tiny(seed=9)
        prompts = prompts_of(4, 90, 4)
        spec, eng = run_engine(m, prompts, [{}] * 4, max_new=8,
                               num_pages=17, max_batch=4, draft_model=m,
                               speculative_k=2)
        assert eng.metrics.preemptions.value == 0
        assert eng.metrics.spec_rounds.value > 0
        base, _ = run_engine(m, prompts, [{}] * 4, max_new=8, num_pages=64,
                             max_batch=4)
        assert spec == base


def test_metrics_exported():
    ex = ServingMetrics().export()
    for key in ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
                "spec_fallbacks", "spec_acceptance_rate"):
        assert key in ex, key
    m = tiny(seed=10)
    _, eng = run_engine(m, prompts_of(2, 10, 5), [{}] * 2, draft_model=m,
                        speculative_k=2)
    ex = eng.metrics.export()
    assert ex["spec_acceptance_rate"] == 1.0 and ex["spec_rounds"] > 0
    assert ex["spec_fallbacks"] == 0
