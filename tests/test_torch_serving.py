"""paddle_tpu_torch's serving slice against paddle_tpu on the CPU: the
page allocator's invariants (mirroring tests/test_serving.py::
TestPagedKVCache), the in-place K/V scatter, fused sampling against the
JAX filter masks, its counter-keyed noise (a lane's noise its own
(seed, step)'s whatever the batch, sampled frequencies within 3 sigma of
the filtered softmax over 4000 seeds, no host read), and the engine end
to end — the JAX ServingEngine and
the port's on the same transplanted tiny model, greedy tokens equal token
for token through a preemption, first-token logits within 1e-4 (two
frameworks' float32 matmuls sum in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import sampling as JS
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.serving import (OutOfPages, PagedKVCache,
                                      ServingEngine, quantize_q8)
from paddle_tpu_torch.serving import attention as TA
from paddle_tpu_torch.serving import sampling as TS

TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cache(**kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 9)  # 8 allocatable
    return PagedKVCache(1, 1, 4, device="cpu", **kw)


# ---------------------------------------------------------------------------
# page allocator invariants


class TestPagedKVCache:
    def test_exact_capacity_fill(self):
        c = tiny_cache()
        c.alloc_seq("a")
        slots, copies = c.append_slots("a", 32)
        assert not copies
        assert c.free_pages == 0
        assert len(set(slots.tolist())) == 32
        assert all(s >= c.page_size for s in slots)  # never scratch
        with pytest.raises(OutOfPages):
            c.append_slots("a", 1)
        c.free_seq("a")
        assert c.free_pages == 8

    def test_out_of_pages_is_transactional(self):
        c = tiny_cache()
        c.alloc_seq("a")
        c.append_slots("a", 30)
        c.alloc_seq("b")
        with pytest.raises(OutOfPages):
            c.append_slots("b", 5)
        assert c.seq_len("b") == 0
        assert c.free_pages == 0
        slots, _ = c.append_slots("a", 2)  # spare tail slots still work
        assert len(slots) == 2

    def test_double_free_and_unknown_raise(self):
        c = tiny_cache()
        c.alloc_seq("a")
        c.append_slots("a", 4)
        c.free_seq("a")
        with pytest.raises(KeyError):
            c.free_seq("a")
        with pytest.raises(KeyError):
            c.free_seq("nope")

    def test_no_cross_sequence_slot_aliasing(self):
        c = tiny_cache(num_pages=17)
        seen = set()
        for sid in range(4):
            c.alloc_seq(sid)
            slots, _ = c.append_slots(sid, 7)
            s = set(slots.tolist())
            assert not (s & seen)
            seen |= s

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_budget_sizing_matches_jax(self, dtype):
        per_page = PagedKVCache.page_bytes_per_page(2, 4, 8, 16, dtype)
        assert per_page == JaxPagedKVCache.page_bytes_per_page(
            2, 4, 8, 16, dtype)
        c = PagedKVCache(2, 4, 8, page_size=16, dtype=dtype,
                         hbm_budget_bytes=10 * per_page + 5, device="cpu")
        assert c.num_pages == 10
        assert tuple(c.k_pages[0].shape) == (10, 16, 4, 8)
        assert (c.k_scales is not None) == (dtype == "int8")
        with pytest.raises(ValueError, match="budget"):
            PagedKVCache(2, 4, 8, page_size=16, hbm_budget_bytes=per_page,
                         device="cpu")

    def test_fork_shares_pages_until_write(self):
        c = tiny_cache()
        c.alloc_seq("p")
        c.append_slots("p", 6)
        used = c.used_pages
        c.fork("p", "c")
        assert c.used_pages == used
        slots, copies = c.append_slots("c", 1)
        assert len(copies) == 1
        src, dst = copies[0]
        assert c.refcount(src) == 1 and c.refcount(dst) == 1
        pslots, pcopies = c.append_slots("p", 1)
        assert not pcopies
        assert slots[0] != pslots[0]

    def test_fork_full_tail_page_needs_no_cow(self):
        c = tiny_cache()
        c.alloc_seq("p")
        c.append_slots("p", 8)
        c.fork("p", "c")
        _, copies = c.append_slots("c", 1)
        assert not copies

    @pytest.mark.parametrize("dtype", ["float32", "int8"])
    def test_apply_copies_in_place(self, dtype):
        c = tiny_cache(dtype=dtype)
        c.alloc_seq("p")
        slots, _ = c.append_slots("p", 2)
        page = int(slots[0]) // c.page_size
        c.k_pages[0][page] = 7
        if dtype == "int8":
            c.k_scales[0][page] = 0.5
        c.fork("p", "c")
        _, copies = c.append_slots("c", 1)
        c.apply_copies(copies)
        (src, dst), = copies
        assert src == page
        assert torch.equal(c.k_pages[0][dst], c.k_pages[0][src])
        if dtype == "int8":
            assert torch.equal(c.k_scales[0][dst], c.k_scales[0][src])

    def test_free_tail_releases_whole_pages(self):
        c = tiny_cache()
        c.alloc_seq("a")
        c.append_slots("a", 10)  # 3 pages
        c.free_tail("a", 5)      # 2 pages kept
        assert c.pages_held("a") == 2 and c.free_pages == 6
        with pytest.raises(ValueError):
            c.free_tail("a", 6)

    def test_same_slots_as_jax_allocator(self):
        """Same operations, same slot ids and page tables."""
        ops = [("alloc", "a"), ("append", "a", 6), ("alloc", "b"),
               ("append", "b", 9), ("append", "a", 3), ("free", "b"),
               ("alloc", "c"), ("append", "c", 5), ("fork", "a", "d"),
               ("append", "d", 2)]
        jc = JaxPagedKVCache(1, 1, 4, page_size=4, num_pages=12)
        tc = tiny_cache(num_pages=12)
        for op in ops:
            for c in (jc, tc):
                if op[0] == "alloc":
                    c.alloc_seq(op[1])
                elif op[0] == "free":
                    c.free_seq(op[1])
                elif op[0] == "fork":
                    c.fork(op[1], op[2])
            if op[0] == "append":
                js, jcp = jc.append_slots(op[1], op[2])
                ts, tcp = tc.append_slots(op[1], op[2])
                np.testing.assert_array_equal(ts, js)
                assert tcp == jcp
        for sid in ("a", "c", "d"):
            np.testing.assert_array_equal(tc.page_table(sid, 6),
                                          jc.page_table(sid, 6))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_write_scatters_in_place(self, dtype):
        c = PagedKVCache(1, 2, 8, page_size=4, num_pages=6, dtype=dtype,
                         device="cpu")
        k_pool = c.k_pages[0]
        g = torch.Generator().manual_seed(0)
        k = torch.randn(3, 2, 8, generator=g)
        v = torch.randn(3, 2, 8, generator=g)
        slots = torch.tensor([5, 6, 13])
        c.write(0, slots, k, v)
        assert c.k_pages[0] is k_pool  # the pool itself, not a copy
        flat_k = c.k_pages[0].view(-1, 2, 8)
        if dtype == "int8":
            codes, scales = quantize_q8(k)
            assert torch.equal(flat_k[slots], codes)
            assert torch.equal(c.k_scales[0].view(-1, 2)[slots], scales)
        else:
            assert torch.equal(flat_k[slots], k.to(c.dtype))
            assert torch.equal(c.v_pages[0].view(-1, 2, 8)[slots],
                               v.to(c.dtype))


# ---------------------------------------------------------------------------
# fused sampling


def _logits_with_ties():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((4, 20)).astype(np.float32) * 2.0
    lg[1, [3, 7, 11]] = lg[1].max() + 1.0   # a three-way tie on top
    lg[2, [0, 5]] = 1.25                     # ties at the k-th value
    return lg


@pytest.mark.parametrize("top_k", [0, 1, 3, 20, 25])
def test_top_k_mask_matches_jax(top_k):
    lg = _logits_with_ties()
    k = np.full(4, top_k, np.int32)
    want = np.asarray(JS._filter_top_k(jnp.asarray(lg), jnp.asarray(k)))
    got = TS._filter_top_k(torch.from_numpy(lg), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.75, 0.999, 1.0])
def test_top_p_mask_matches_jax(top_p):
    lg = _logits_with_ties()
    k = np.asarray([0, 5, 2, 0], np.int32)
    keep = np.asarray(JS._filter_top_k(jnp.asarray(lg), jnp.asarray(k)))
    filtered = np.where(keep, lg, -np.inf).astype(np.float32)
    p = np.full(4, top_p, np.float32)
    want = np.asarray(JS._filter_top_p(jnp.asarray(filtered),
                                       jnp.asarray(p)))
    got = TS._filter_top_p(torch.from_numpy(filtered), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sample_capable", [False, True])
def test_greedy_lanes_match_jax(sample_capable):
    lg = _logits_with_ties()
    b = lg.shape[0]
    samp = (np.zeros(b, np.bool_), np.full(b, 0.7, np.float32),
            np.full(b, 3, np.int32), np.full(b, 0.8, np.float32),
            np.arange(b, dtype=np.int32), np.arange(b, dtype=np.int32))
    jt, jl = JS.fused_sample(jnp.asarray(lg),
                             *(jnp.asarray(a) for a in samp),
                             sample_capable=sample_capable)
    tt, tl = TS.fused_sample(torch.from_numpy(lg),
                             *(torch.from_numpy(a) for a in samp),
                             sample_capable=sample_capable)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)


def test_sampled_lanes_stay_in_the_filter_and_replay():
    lg = _logits_with_ties()
    b = lg.shape[0]
    samp = [torch.ones(b, dtype=torch.bool), torch.full((b,), 0.9),
            torch.full((b,), 3, dtype=torch.int32), torch.full((b,), 0.9),
            torch.tensor([11, 12, 13, 14], dtype=torch.int32),
            torch.tensor([0, 5, 2, 9], dtype=torch.int32)]
    x = torch.from_numpy(lg)
    keep = TS._filter_top_k(x / 0.9, samp[2])
    for _ in range(3):
        tok, lp = TS.fused_sample(x, *samp)
        assert keep[torch.arange(b), tok.long()].all()
        assert torch.isfinite(lp).all() and (lp <= 0).all()
    tok2, _ = TS.fused_sample(x, *samp)
    assert torch.equal(tok, tok2)  # keyed on (seed, step): replays


def test_lane_noise_ignores_lane_order_and_batch_size():
    """Lane i's noise is a function of its own (seed, step): the same
    row in any order, in a batch of any size, and alone."""
    seeds = torch.tensor([5, 0, 2 ** 31 - 1, 5, 77], dtype=torch.int32)
    steps = torch.tensor([0, 3, 9, 1, 0], dtype=torch.int32)
    full = TS.lane_noise(seeds, steps, 40)
    perm = torch.tensor([3, 0, 4, 2, 1])
    assert torch.equal(TS.lane_noise(seeds[perm], steps[perm], 40),
                       full[perm])
    for i in range(5):
        assert torch.equal(TS.lane_noise(seeds[i:i + 1], steps[i:i + 1],
                                         40)[0], full[i])
    assert not torch.equal(full[0], full[3])  # the step moves the noise
    assert torch.isfinite(full).all()


def test_sampled_frequencies_match_the_filtered_softmax():
    """Over 4000 seeds, each token's frequency is within 3 sigma of its
    probability under the filtered, temperature-scaled softmax."""
    n, v = 4000, 8
    lg = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]])
    temp, top_k = 0.8, 5
    tok, _ = TS.fused_sample(
        lg.expand(n, v), torch.ones(n, dtype=torch.bool),
        torch.full((n,), temp), torch.full((n,), top_k, dtype=torch.int32),
        torch.ones(n), torch.arange(n, dtype=torch.int32),
        torch.full((n,), 3, dtype=torch.int32))
    p = torch.softmax(lg[0, :top_k] / temp, dim=0).double()
    freq = torch.bincount(tok.long(), minlength=v).double() / n
    assert (freq[top_k:] == 0).all()
    sigma = (p * (1 - p) / n).sqrt()
    assert ((freq[:top_k] - p).abs() <= 3 * sigma).all(), (freq, p)


def test_fused_sample_reads_nothing_on_the_host(monkeypatch):
    lg = torch.from_numpy(_logits_with_ties())
    b = lg.shape[0]
    samp = (torch.tensor([True, False, True, True]), torch.full((b,), 0.7),
            torch.full((b,), 3, dtype=torch.int32), torch.full((b,), 0.9),
            torch.arange(b, dtype=torch.int32),
            torch.arange(b, dtype=torch.int32))

    def no_host_read(*a, **k):
        raise AssertionError("fused_sample read a tensor on the host")

    monkeypatch.setattr(torch.Tensor, "tolist", no_host_read)
    monkeypatch.setattr(torch.Tensor, "item", no_host_read)
    for capable in (True, False):
        tok, lp = TS.fused_sample(lg, *samp, sample_capable=capable)
        assert tok.shape == lp.shape == (b,)


# ---------------------------------------------------------------------------
# the engine end to end against the JAX engine


def _transplanted(seed=0):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def _serve(engine_cls, model, prompts, **kw):
    """Run the prompts greedily; returns tokens per request, each
    request's first-token logits and the engine."""
    first = {}
    eng = None

    def on_event(ev):
        if ev["type"] == "token" and ev["req_id"] not in first:
            if isinstance(eng, ServingEngine):
                first[ev["req_id"]] = eng.last_logits[0].numpy().copy()
            else:
                first[ev["req_id"]] = eng._last_logits_probe

    eng = engine_cls(model, page_size=4, max_batch=2, prefill_chunk=4,
                     on_event=on_event, **kw)
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    res = eng.run()
    return ([res[r]["tokens"] for r in rids], [first[r] for r in rids],
            eng)


def test_engine_matches_jax_engine_through_a_preemption():
    jm, tm = _transplanted()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (5, 11, 7)]
    # 6 allocatable pages of 4 tokens: the third request's decode growth
    # preempts the newest live request once
    jt, jf, jeng = _serve(JaxServingEngine, jm, prompts, num_pages=7)
    TA.reset_stats()
    tt, tf, teng = _serve(ServingEngine, tm, prompts, num_pages=7,
                          device="cpu")
    assert jeng.metrics.preemptions.value == 1
    assert teng.metrics.preemptions.value == 1
    assert tt == jt
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert TA.stats["kernel_launches"] == 0
    assert TA.stats["plain_calls"] == (
        TINY["num_hidden_layers"] * teng.metrics.step_dispatches.value)
    assert teng.cache.free_pages == teng.cache.allocatable_pages


def test_int8_cache_engine_matches_jax_engine():
    jm, tm = _transplanted(seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 97, n).astype(np.int32) for n in (6, 9)]
    jt, jf, _ = _serve(JaxServingEngine, jm, prompts, num_pages=32,
                       cache_dtype="int8")
    tt, tf, _ = _serve(ServingEngine, tm, prompts, num_pages=32,
                       cache_dtype="int8", device="cpu")
    assert tt == jt
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_engine_sampling_forks_and_cancel():
    """n=2 sampling forks at prefill completion (copy-on-write of the
    shared tail page), a seeded request replays exactly, cancel frees."""
    _, tm = _transplanted(seed=2)
    prompt = np.arange(1, 7, dtype=np.int32)

    def serve():
        eng = ServingEngine(tm, page_size=4, num_pages=32, max_batch=4,
                            prefill_chunk=4, device="cpu")
        rid = eng.add_request(prompt, max_new_tokens=5, do_sample=True,
                              top_k=5, seed=7, n=2)
        res = eng.run()
        return eng, rid, res

    eng, rid, res = serve()
    assert len(res) == 2 and all(len(r["tokens"]) == 5
                                 for r in res.values())
    assert eng.metrics.cow_copies.value >= 1
    assert eng.cache.free_pages == eng.cache.allocatable_pages
    _, _, res2 = serve()
    assert [r["tokens"] for r in res.values()] == \
        [r["tokens"] for r in res2.values()]
    other = eng.add_request(prompt, max_new_tokens=4)
    eng.step()
    assert eng.cancel(other)
    assert eng.results()[other]["finish_reason"] == "cancelled"
    assert eng.cache.free_pages == eng.cache.allocatable_pages
    assert not eng.cancel(other)


@pytest.mark.parametrize("arg", [
    dict(prefix_cache=True), dict(draft_model=object()),
    dict(speculative_k=2), dict(weight_quant="int8"),
    dict(chaos=object()), dict(host_pool=object()),
    dict(distill=object()), dict(mesh=object()), dict(tp_degree=2)])
def test_unported_engine_arguments_raise(arg):
    """The arguments outside the port raise NotImplementedError; the
    speculative ones are ported and refuse what is wrong (a draft that
    is no causal LM, a k without a draft)."""
    _, tm = _transplanted()
    want = (TypeError if "draft_model" in arg else
            ValueError if "speculative_k" in arg else NotImplementedError)
    with pytest.raises(want):
        ServingEngine(tm, num_pages=8, device="cpu", **arg)
