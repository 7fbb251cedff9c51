"""The prefix cache in paddle_tpu_torch's serving engine against
paddle_tpu on the CPU: the radix tree and its allocator, prefix-aware
admission, the speculative engine over cached pages, and page migration
between the two packages' engines on the reference's wire format.

- One scripted sequence of allocator operations (acquire, commit, fork,
  copy-on-write, ``free_tail`` over cached pages, free, LRU eviction
  under pressure, ``drop_prefix``, ``clear_prefix``) drives both
  ``PagedKVCache``s; after every operation the page tables, lengths,
  refcounts, free list, cached and reclaimable counts and the hit, miss
  and eviction counters are equal.
- One JAX engine run (module fixture, bucketed, ``prefix_cache=True``)
  over requests that share a 2-page prefix: the port's bucketed and
  ragged engines give its streams, each request's ``cached_pages`` and
  its prefix metrics; with the cache off the port gives the same
  streams.
- The speculative engine with the cache on gives the plain engine's
  streams, and its rejected tails leave the cached pages resident.
- A request prefilled by the JAX engine (``prefill_only`` ->
  ``export_request`` -> the reference's ``serialize_pages``) is adopted
  by the port's engine, which decodes the JAX engine's own
  continuation; the port's prefill is adopted by the JAX engine the
  other way. ``GeometryMismatch`` and ``PrefixDrift`` where the
  reference raises them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import pagewire as jwire
from paddle_tpu.serving.kv_cache import GeometryMismatch as JaxGeometry
from paddle_tpu.serving.kv_cache import PagedKVCache as JaxPagedKVCache
from paddle_tpu.serving.kv_cache import PrefixDrift as JaxPrefixDrift
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.serving import (GeometryMismatch, OutOfPages,
                                      PagedKVCache, PrefixDrift,
                                      ServingEngine, deserialize_pages,
                                      serialize_pages)

TINY = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
ENG = dict(page_size=4, max_batch=2, prefill_chunk=8, num_pages=48)
NEW = 5
METRICS = ("prefix_hit_pages", "prefix_miss_pages", "prefix_evictions",
           "prefill_chunks")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the allocator, op for op against the reference


def _tok(i, n):
    return np.arange(i, i + n, dtype=np.int32) % 97


def _state(c):
    return dict(tables={k: list(v) for k, v in c._tables.items()},
                lens=dict(c._lens), rc=c._rc.tolist(), free=list(c._free),
                cached=c.cached_pages, reclaimable=c.reclaimable_pages,
                available=c.available_pages, depth=c.prefix_tree_depth,
                counts=(c.prefix_hit_pages, c.prefix_miss_pages,
                        c.prefix_evictions))


def _call(c, op, *args):
    """The operation's result, as comparable across the packages (an
    exception by its class name)."""
    try:
        out = getattr(c, op)(*args)
    except (OutOfPages, ValueError, KeyError, RuntimeError) as e:
        return type(e).__name__
    if op == "append_slots":
        slots, copies = out
        return slots.tolist(), copies
    return out


SHARED = _tok(0, 8)
A = np.concatenate([SHARED, _tok(40, 3)])       # 11 tokens: 2 full pages
B = np.concatenate([SHARED, _tok(60, 6)])       # 14: 3 full pages
C = np.concatenate([_tok(20, 8), _tok(0, 5)])   # 13: unrelated
SCRIPT = [
    ("acquire_prefix", "a", A, A.size), ("append_slots", "a", 11),
    ("commit_prefix", "a", A, 8), ("record_prefix_stats", A, 11, 0),
    ("acquire_prefix", "b", B, B.size), ("append_slots", "b", 6),
    ("commit_prefix", "b", B, 14), ("record_prefix_stats", B, 14, 2),
    ("fork", "b", "b2"), ("append_slots", "b2", 1),
    # the rollback crosses b2's cached third page: it stays resident
    ("free_tail", "b2", 7), ("free_seq", "a"),
    ("probe_prefix", A, A.size), ("probe_prefix", B, B.size),
    ("acquire_prefix", "a2", A, A.size), ("append_slots", "a2", 3),
    ("free_seq", "b"), ("free_seq", "b2"),
    # pressure: more pages than the free list holds evicts LRU leaves
    ("acquire_prefix", "c", C, C.size), ("append_slots", "c", 13),
    ("commit_prefix", "c", C, 13), ("alloc_seq", "d"),
    ("append_slots", "d", 20), ("append_slots", "d", 40),
    ("free_seq", "d"), ("free_seq", "c"), ("free_seq", "a2"),
    ("free_seq", "a2"), ("probe_prefix", C, C.size + 1),
    ("drop_prefix", C), ("drop_prefix", A),
    ("acquire_prefix", "e", B, B.size), ("append_slots", "e", 14),
    ("commit_prefix", "e", B, 14), ("free_seq", "e"),
    ("clear_prefix",), ("acquire_prefix", "f", B, B.size)]


def test_allocator_matches_jax_op_for_op():
    kw = dict(page_size=4, num_pages=12, prefix_cache=True)
    jc = JaxPagedKVCache(1, 1, 4, **kw)
    tc = PagedKVCache(1, 1, 4, device="cpu", **kw)
    assert _state(tc) == _state(jc)
    for i, (op, *args) in enumerate(SCRIPT):
        got, want = _call(tc, op, *args), _call(jc, op, *args)
        assert got == want, (i, op)
        assert _state(tc) == _state(jc), (i, op)
    # the script reached every branch it names
    assert jc.prefix_evictions > 0 and jc.prefix_hit_pages > 0
    assert "OutOfPages" in [_call(tc, "append_slots", "f", 60)]


# ---------------------------------------------------------------------------
# the engine against the JAX engine


def _transplanted(seed=0):
    P.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def _prompts():
    """Six requests over one 2-page prefix (lengths 9-17) and one that
    shares nothing."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 97, 8).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(0, 97, n).astype(np.int32)])
           for n in (3, 6, 1, 9, 4, 5)]
    out.append(rng.integers(0, 97, 10).astype(np.int32))
    return out


HELD = 1            # the JAX engine's prefill_only twin of this prompt
ADOPT_BACK = 4      # the port prefills this one for the JAX engine


def _serve(eng, prompts, **kw):
    rids = [eng.add_request(p, max_new_tokens=NEW, **kw) for p in prompts]
    res = eng.run()
    return [res[r]["tokens"] for r in rids], [
        eng._requests[r].cached_pages for r in rids]


def _metrics(eng):
    return {k: getattr(eng.metrics, k).value for k in METRICS}


@pytest.fixture(scope="module")
def runs():
    """The JAX engine's run (two waves of the prompts, the second all
    hits, and a prefill_only twin of one prompt, exported), the port's
    prefill_only export of another, adopted by the same JAX engine."""
    jm, tm = _transplanted()
    prompts = _prompts()
    jeng = JaxServingEngine(jm, prefix_cache=True, **ENG)
    waves = [_serve(jeng, prompts) for _ in range(2)]
    metrics = _metrics(jeng)
    held = jeng.add_request(prompts[HELD], max_new_tokens=NEW,
                            prefill_only=True)
    jeng.run()
    jax_payload = jwire.serialize_pages(*jeng.export_request(held))
    assert jeng.release_request(held)
    # the port prefills a prompt for the JAX engine, skipping what that
    # engine holds of its prefix
    p = prompts[ADOPT_BACK]
    teng = ServingEngine(tm, prefix_cache=True, device="cpu", **ENG)
    rid = teng.add_request(p, max_new_tokens=NEW, prefill_only=True)
    teng.run()
    # the skip must match the adopter's tree: a whole chain drifts
    whole = jwire.deserialize_pages(serialize_pages(
        *teng.export_request(rid)))[:3]
    with pytest.raises(JaxPrefixDrift) as e:
        jeng.adopt_request(*whole, max_new_tokens=NEW)
    skip = jeng.cache.probe_prefix(p, p.size + 1)
    assert e.value.cached_pages == skip
    meta, k, v = teng.export_request(rid, skip_pages=skip)
    jmeta, jk, jv, _ = jwire.deserialize_pages(serialize_pages(meta, k, v))
    jrid = jeng.adopt_request(jmeta, jk, jv, max_new_tokens=NEW)
    adopted = jeng.run()[jrid]["tokens"]
    return dict(jm=jm, tm=tm, prompts=prompts, waves=waves,
                metrics=metrics, jax_payload=jax_payload,
                jax_adopted=adopted, skip=skip)


@pytest.mark.parametrize("ragged", [False, True])
def test_engine_matches_jax_engine_with_the_prefix_cache(runs, ragged):
    eng = ServingEngine(runs["tm"], prefix_cache=True, device="cpu",
                        ragged=ragged, **ENG)
    waves = [_serve(eng, runs["prompts"]) for _ in range(2)]
    assert waves == runs["waves"]
    assert _metrics(eng) == runs["metrics"]
    (_, first), (_, second) = waves
    # the first wave hits after the first prefill commits (the queued
    # requests re-match at the head of the prefill queue); the second
    # hits every full prompt page but the last token's
    assert first[0] == 0 and first[1:6] == [2] * 5
    assert second[:6] == [(p.size - 1) // 4 for p in runs["prompts"][:6]]
    c = eng.cache
    assert c.free_pages + c.reclaimable_pages == c.allocatable_pages
    assert c.reclaimable_pages == c.cached_pages > 0
    # with the cache off, the same streams from more prefill chunks
    cold = ServingEngine(runs["tm"], device="cpu", ragged=ragged, **ENG)
    assert _serve(cold, runs["prompts"])[0] == waves[0][0]
    assert cold.metrics.prefix_hit_pages.value == 0


def test_speculative_engine_keeps_cached_pages_resident(runs):
    tm, prompts = runs["tm"], runs["prompts"]
    draft = LlamaForCausalLM(LlamaConfig(**dict(
        TINY, num_hidden_layers=1, hidden_size=16, intermediate_size=32)),
        device="cpu", seed=5)
    for ragged in (False, True):
        eng = ServingEngine(tm, prefix_cache=True, device="cpu",
                            ragged=ragged, draft_model=draft,
                            speculative_k=3, **ENG)
        waves = [_serve(eng, prompts) for _ in range(2)]
        assert [w[0] for w in waves] == [w[0] for w in runs["waves"]]
        m = eng.metrics
        # a random draft: rounds with rejections rolled back over pages
        assert m.spec_accepted_tokens.value < m.spec_draft_tokens.value
        assert m.prefix_hit_pages.value > 0
        c = eng.cache
        assert c.reclaimable_pages == c.cached_pages > 0
        assert c.free_pages + c.cached_pages == c.allocatable_pages
        assert eng._draft_cache.cached_pages == 0


def test_jax_prefill_adopted_by_the_port(runs):
    """The reference's payload, deserialized by the port, continues in
    the port's engine as the JAX engine's own stream; its prompt's full
    pages enter the adopter's tree."""
    meta, k, v, _ = deserialize_pages(runs["jax_payload"])
    prompt = runs["prompts"][HELD]
    assert meta["skip_pages"] == 0 and meta["out_tokens"] == \
        runs["waves"][0][0][HELD][:1]
    eng = ServingEngine(runs["tm"], prefix_cache=True, device="cpu", **ENG)
    with pytest.raises(GeometryMismatch):
        eng.adopt_request(dict(meta, page_size=8), k, v,
                          max_new_tokens=NEW)
    with pytest.raises(GeometryMismatch):
        eng.adopt_request(meta, k[:1], v, max_new_tokens=NEW)
    rid = eng.adopt_request(meta, k, v, max_new_tokens=NEW)
    assert eng.run()[rid]["tokens"] == runs["waves"][0][0][HELD]
    assert eng.cache.cached_pages == prompt.size // 4
    assert eng.metrics.pages_imported.value == meta["n_pages"]
    # a second adoption of the same payload meets the adopter's tree:
    # the reference's PrefixDrift, carrying what it holds
    with pytest.raises(PrefixDrift) as e:
        eng.adopt_request(meta, k, v, max_new_tokens=NEW)
    assert e.value.cached_pages == eng.cache.probe_prefix(
        prompt, prompt.size + 1)
    assert eng.cache.free_pages + eng.cache.cached_pages == \
        eng.cache.allocatable_pages


def test_port_prefill_adopted_by_jax(runs):
    """The port's export (skipping the JAX engine's cached prefix)
    continues in the JAX engine as the port's own stream."""
    # the JAX engine holds every full page of the prompt: the payload
    # is its partial last page alone
    assert runs["skip"] == runs["prompts"][ADOPT_BACK].size // 4 == 3
    assert runs["jax_adopted"] == runs["waves"][0][0][ADOPT_BACK]


def test_prefill_only_hold_lifecycle_and_geometry(runs):
    tm, prompts = runs["tm"], runs["prompts"]
    eng = ServingEngine(tm, device="cpu", **ENG)
    with pytest.raises(ValueError):
        eng.add_request(prompts[0], max_new_tokens=3, n=2, do_sample=True,
                        prefill_only=True)
    rid = eng.add_request(prompts[0], max_new_tokens=NEW, prefill_only=True,
                          deadline_s=60.0)
    res = eng.run()
    assert res[rid]["finish_reason"] == "prefilled"
    assert eng.cache.pages_held(rid) == 3
    meta, k, v = eng.export_request(rid)
    assert meta["seq_len"] == prompts[0].size and len(k) == 2
    assert eng.cache.geometry() == {"n_layers": 2, "n_kv_heads": 2,
                                    "head_dim": 8, "page_size": 4,
                                    "dtype": "float32", "tp_degree": 1}
    jc = JaxPagedKVCache(2, 2, 8, page_size=4, num_pages=8)
    assert jc.geometry() == eng.cache.geometry()
    jmeta, jk, jv, _ = jwire.deserialize_pages(serialize_pages(meta, k, v))
    with pytest.raises(JaxGeometry):
        JaxPagedKVCache(2, 2, 8, page_size=4, num_pages=8,
                        dtype="bfloat16").import_pages("x", jmeta, jk, jv)
    assert jc.import_pages("x", jmeta, jk, jv) == 3
    for got, want in zip(jc.k_pages + jc.v_pages, k + v):
        np.testing.assert_array_equal(
            np.asarray(got)[jc._tables["x"]], want.numpy())
    # cancel releases a held request's pages; a second release is a no-op
    assert eng.cancel(rid) and not eng.release_request(rid)
    assert eng.cache.free_pages == eng.cache.allocatable_pages
    with pytest.raises(KeyError):
        eng.export_request(rid)
    rid = eng.add_request(prompts[1], max_new_tokens=NEW, prefill_only=True,
                          deadline_s=60.0)
    eng.run()
    assert eng.sweep_held_deadlines() == 0
    assert eng.sweep_held_deadlines(now=eng._now() + 120) == 1
    assert eng.metrics.held_expired.value == 1
    assert eng.cache.free_pages == eng.cache.allocatable_pages
