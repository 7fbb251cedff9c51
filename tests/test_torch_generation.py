"""``generate()`` of paddle_tpu_torch against paddle_tpu on the CPU.

Tiny float32 models with the JAX models' weights carried across
(``state_dict_from_paddle_tpu``) and the same numpy prompts in both
packages:

- ``cached_attention`` against the JAX function to 1e-5 in its arms
  (float32, bf16, int8, GQA, the window, S > 1 at a nonzero offset), the
  written cache included; ``quantize_q8`` bit-equal to ``_quantize_q8``;
  ``_filter_logits`` element for element;
- greedy ``generate`` token for token: LLaMA (MHA, GQA), Mistral with a
  window shorter than prompt + new tokens, GPT, the int8 cache, and
  ``repetition_penalty`` + ``min_new_tokens`` + ``eos``; beam search;
  speculative greedy with a self-draft and with another draft, and its
  round count; the guards raise what the reference raises.

Sampled streams cannot match JAX's threefry bits, so sampling is held to
the port's own properties: one seed gives one stream, ``top_k=1`` is
greedy, and speculative sampling's marginal matches the target's at a
small vocabulary. Then the program cache's keys: the cache dtype, an
in-place weight update (kept) against a replaced parameter (a new
program), the draft's identity; and the cache's bound, whose dropped
programs are freed.

Each JAX reference run is shared through module-scoped fixtures.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import generation as JG
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.models import generation as G
from paddle_tpu_torch.serving.attention import quantize_q8

ATTN_ATOL = 1e-5
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
B, S, NEW = 2, 8, 8


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(jax_cls, jax_cfg_cls, cls, cfg_cls, seed=0, **kw):
    """The JAX model and the port's, with the same weights."""
    P.seed(seed)
    jm = jax_cls(jax_cfg_cls(**kw))
    cfg = cfg_cls(**kw)
    tm = cls(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


def _llama(seed=0, **kw):
    return _pair(JaxLlama, JaxLlamaConfig, LlamaForCausalLM, LlamaConfig,
                 seed, **{**TINY, **kw})


def _newest(model):
    """The model's most recently used generate program."""
    return next(reversed(model._gen_cache.values()))


def _jax_gen(jm, ids, **kw):
    return np.asarray(jm.generate(ids, **kw)._data)


def _prompts(seed=0, b=B, s=S, vocab=97):
    return np.random.default_rng(seed).integers(3, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def llama():
    return _llama()


@pytest.fixture(scope="module")
def llama_gqa():
    return _llama(num_key_value_heads=2)


@pytest.fixture(scope="module")
def greedy_ref(llama):
    ids = _prompts()
    return ids, _jax_gen(llama[0], ids, max_new_tokens=NEW)


# -- the cache and the attention --------------------------------------------

def _jax_buf(x):
    return jnp.asarray(x) if not isinstance(x, tuple) else (
        jnp.asarray(x[0]), jnp.asarray(x[1])[..., None])


@pytest.mark.parametrize("arm", ["float32", "bf16", "int8", "gqa", "window",
                                 "prompt_at_offset"])
def test_cached_attention_matches_jax(arm):
    """Both write the new K/V at the offset of caches whose every slot
    holds stale values, then attend; the outputs and the written caches
    agree."""
    rng = np.random.default_rng(5)
    nh, nkv, d, t = 4, 4, 16, 32
    s, off, win = 1, 9, None
    if arm in ("gqa", "window", "prompt_at_offset"):
        nkv = 2
    if arm == "window":
        s, off, win = 4, 12, 6
    if arm == "prompt_at_offset":
        s, off = 5, 7
    if arm == "int8":
        s, off = 2, 7

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, kn, vn = rnd(B, s, nh, d), rnd(B, s, nkv, d), rnd(B, s, nkv, d)
    kb, vb = rnd(B, t, nkv, d), rnd(B, t, nkv, d)
    dt = torch.bfloat16 if arm == "bf16" else torch.float32
    jdt = jnp.bfloat16 if arm == "bf16" else jnp.float32
    if arm == "int8":
        kb, vb = (tuple(x.numpy() for x in quantize_q8(torch.from_numpy(a)))
                  for a in (kb, vb))
        tkb, tvb = (tuple(torch.from_numpy(x.copy()) for x in a)
                    for a in (kb, vb))
    else:
        tkb, tvb = (torch.from_numpy(a).to(dt) for a in (kb, vb))
    # jit for speed; the int8 arm eagerly, as the function is written
    # (XLA's fusion rounds x / s differently from the eager division)
    fn = JG.cached_attention if arm == "int8" else jax.jit(
        JG.cached_attention, static_argnums=(6, 7))
    jout, jkb, jvb = fn(
        jnp.asarray(q, jdt), jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
        _jax_buf(kb) if arm == "int8" else jnp.asarray(kb, jdt),
        _jax_buf(vb) if arm == "int8" else jnp.asarray(vb, jdt), off,
        d ** -0.5, win)
    out, tkb, tvb = G.cached_attention(
        torch.from_numpy(q).to(dt), torch.from_numpy(kn).to(dt),
        torch.from_numpy(vn).to(dt), tkb, tvb,
        G.CachePlan(torch.tensor(off), B, s, tkb), d ** -0.5, window=win)
    assert out.dtype == dt and out.shape == (B, s, nh, d)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), atol=ATTN_ATOL)
    if arm == "int8":
        for got, want in zip(tkb + tvb, jkb + jvb):
            want = np.asarray(want)
            np.testing.assert_array_equal(got.numpy(),
                                          want.reshape(got.shape))
    else:
        for got, want in ((tkb, jkb), (tvb, jvb)):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_quantize_q8_is_the_jax_quantiser_bit_for_bit():
    x = np.random.default_rng(1).standard_normal((3, 5, 2, 16)).astype(
        np.float32) * 3.0
    x[0, 0, 0] = 0.0                                     # an all-zero row
    jc, js = JG._quantize_q8(jnp.asarray(x))
    tc, ts = quantize_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[..., 0])


def test_static_caches_round_up_to_the_page_and_take_the_reference_dtypes():
    caches = G.init_static_caches(2, 3, 21, 2, 8, None, torch.bfloat16,
                                  device="cpu")
    assert len(caches) == 2 and caches[0][0].shape == (3, 32, 2, 8)
    assert caches[0][0].dtype == torch.bfloat16
    assert caches[0][0].data_ptr() != caches[0][1].data_ptr()
    (kq, ks), _ = G.init_static_caches(1, 3, 16, 2, 8, "int8",
                                       device="cpu")[0]
    assert kq.dtype == torch.int8 and kq.shape == (3, 16, 2, 8)
    assert ks.dtype == torch.float32 and ks.shape == (3, 16, 2)
    for ok, want in ((None, None), ("int8", "int8"), (np.int8, "int8"),
                     (torch.int8, "int8"), ("bfloat16", "bfloat16"),
                     (torch.float16, "float16"), (np.float32, "float32")):
        assert G._normalize_cache_dtype(ok) == want
        if ok is not None and not isinstance(ok, torch.dtype):
            assert JG._normalize_cache_dtype(ok) == want
    for bad in ("float64", "int4", np.int32, torch.int32):
        with pytest.raises(ValueError, match="unsupported cache_dtype"):
            G._normalize_cache_dtype(bad)


def test_a_bf16_cache_holds_what_a_float32_cache_holds():
    """GPT's reference cache is float32 even for a bf16 model; the port
    keeps bf16: bf16 K/V widened to float32 is exact, so the attention is
    the same bit for bit."""
    g = torch.Generator().manual_seed(3)
    q, kn, vn = (torch.randn(2, 3, 4, 16, generator=g).bfloat16()
                 for _ in range(3))
    stale = torch.randn(2, 16, 4, 16, generator=g).bfloat16()
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        kb, vb = stale.to(dt, copy=True), stale.to(dt, copy=True)
        outs.append(G.cached_attention(q, kn, vn, kb, vb,
                                       G.CachePlan(5, 2, 3, kb), 0.25)[0])
    assert torch.equal(outs[0], outs[1])
    net = GPTForCausalLM(GPTConfig.tiny(dtype="bfloat16"), device="cpu")
    assert net._init_caches(1, 20)[0][0].dtype == torch.bfloat16


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 5, 0.8), (1.0, 0, 0.5), (1.3, 10, 1.0), (0.9, 0, 1.0),
    (1.0, 200, 0.95)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    lg = np.random.default_rng(2).standard_normal((3, 97)).astype(
        np.float32) * 2.0
    lg[1, 10:13] = lg[1].max()          # a tie at the top
    want = np.asarray(JG._filter_logits(jnp.asarray(lg), temperature, top_k,
                                        top_p))
    got = G._filter_logits(torch.from_numpy(lg), temperature, top_k,
                           top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6)


# -- generate against the reference -----------------------------------------

def test_greedy_llama_matches_jax(llama, greedy_ref):
    ids, want = greedy_ref
    got = llama[1].generate(ids, max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["gqa", "mistral_window", "gpt", "int8",
                                  "rp_min_new_eos"])
def test_greedy_generate_matches_jax(case, llama, llama_gqa, greedy_ref):
    ids = _prompts(1)
    kw = dict(max_new_tokens=NEW)
    if case == "gqa":
        jm, tm = llama_gqa
    elif case == "mistral_window":
        jm, tm = _llama(num_key_value_heads=2, sliding_window=6)
    elif case == "gpt":
        jm, tm = _pair(JaxGPT, JaxGPTConfig.tiny, GPTForCausalLM,
                       GPTConfig.tiny, vocab_size=97)
    elif case == "int8":
        (jm, tm), kw["cache_dtype"] = llama, "int8"
    else:
        jm, tm = llama
        # an eos the plain run emits early, banned for 3 tokens
        eos = int(greedy_ref[1][0, 1])
        ids = greedy_ref[0]
        kw.update(repetition_penalty=1.3, min_new_tokens=3,
                  eos_token_id=eos)
    want = _jax_gen(jm, ids, **kw)
    got = tm.generate(ids, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "rp_min_new_eos":
        assert (want[:, :3] != eos).all() and (want == eos).any()


def test_beam_search_matches_jax(llama, greedy_ref):
    jm, tm = llama
    ids, plain = greedy_ref
    eos = int(plain[1, 2])
    kw = dict(max_new_tokens=NEW, num_beams=3, length_penalty=0.6,
              eos_token_id=eos)
    want = _jax_gen(jm, ids, **kw)
    np.testing.assert_array_equal(tm.generate(ids, **kw).numpy(), want)
    assert _newest(tm).best_scores.shape == (B,)


@pytest.mark.parametrize("draft", ["self", "other"])
def test_speculative_greedy_matches_jax(draft, llama):
    jm, tm = llama
    if draft == "self":
        jd, td = jm, tm
    else:
        jd, td = _llama(seed=7, num_hidden_layers=1)
    ids = _prompts(2)
    kw = dict(max_new_tokens=12, speculative_k=3)
    want = _jax_gen(jm, ids, draft_model=jd, **kw)
    got = tm.generate(ids, draft_model=td, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert tm._last_spec_rounds == jm._last_spec_rounds
    prog = _newest(tm)
    assert tm._last_spec_rounds == len(prog.accepted)
    rows = prog.accepted_rows[:len(prog.accepted)]
    assert rows.min(1).values.tolist() == prog.accepted
    if draft == "self":
        assert tm._last_spec_rounds == -(-(12 - 1) // 4)


@pytest.mark.parametrize("kw,exc", [
    (dict(repetition_penalty=0.0), ValueError),
    (dict(min_new_tokens=9), ValueError),
    (dict(min_new_tokens=2, eos_token_id=97), ValueError),
    (dict(repetition_penalty=1.2, num_beams=2), NotImplementedError),
    (dict(min_new_tokens=1, eos_token_id=3, draft="self"),
     NotImplementedError),
    (dict(num_beams=2, do_sample=True), NotImplementedError),
    (dict(num_beams=2, draft="self"), NotImplementedError),
    (dict(max_new_tokens=60), ValueError),
    (dict(max_new_tokens=60, num_beams=2), ValueError),
    (dict(draft="self", speculative_k=17), ValueError),
    (dict(draft="other_vocab"), ValueError),
    (dict(cache_dtype="float64"), ValueError)])
def test_guards_raise_what_the_reference_raises(kw, exc, llama):
    jm, tm = llama
    ids = _prompts()
    kw = {"max_new_tokens": NEW, **kw}
    draft = kw.pop("draft", None)
    jd = td = None
    if draft == "self":
        jd, td = jm, tm
    elif draft == "other_vocab":
        jd = JaxLlama(JaxLlamaConfig(**{**TINY, "vocab_size": 50}))
        td = LlamaForCausalLM(LlamaConfig(**{**TINY, "vocab_size": 50}),
                              device="cpu")
    with pytest.raises(exc):
        jm.generate(ids, draft_model=jd, **kw)
    with pytest.raises(exc):
        tm.generate(ids, draft_model=td, **kw)


@pytest.mark.parametrize("program", ["vanilla", "beam", "speculative"])
def test_max_new_tokens_below_one_is_refused_by_name(program, llama):
    """The reference returns ``[B, 1]`` from its vanilla program and
    raises a bare ``IndexError`` from its beam program; the port refuses
    ``max_new_tokens < 1`` in every program before anything runs."""
    tm = llama[1]
    kw = {"beam": dict(num_beams=2),
          "speculative": dict(draft_model=tm)}.get(program, {})
    for n in (0, -1):
        with pytest.raises(ValueError, match="max_new_tokens"):
            tm.generate(_prompts(), max_new_tokens=n, **kw)


# -- the port's own checks ----------------------------------------------------

SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)


def test_sampling_is_a_function_of_the_seed(llama):
    tm = llama[1]
    ids = np.repeat(_prompts(3)[:1], 4, axis=0)      # identical rows
    a = tm.generate(ids, max_new_tokens=NEW, seed=11, **SAMPLE)
    assert torch.equal(a, tm.generate(ids, max_new_tokens=NEW, seed=11,
                                      **SAMPLE))
    assert not torch.equal(a, tm.generate(ids, max_new_tokens=NEW,
                                          seed=12, **SAMPLE))
    assert len({tuple(r) for r in a.tolist()}) > 1   # rows draw apart
    # seed=None: one seed from the model's generator
    tm.generator.manual_seed(5)
    b = tm.generate(ids, max_new_tokens=NEW, **SAMPLE)
    tm.generator.manual_seed(5)
    assert torch.equal(b, tm.generate(ids, max_new_tokens=NEW, **SAMPLE))


def test_top_k_1_sampling_is_greedy(llama, greedy_ref):
    ids, want = greedy_ref
    got = llama[1].generate(ids, max_new_tokens=NEW, do_sample=True,
                            top_k=1, seed=3)
    np.testing.assert_array_equal(got.numpy(), want)


def _peaked(model, scale):
    """Sharpen a tiny model's distributions (its random logits are nearly
    flat) so that a draft and a target differ clearly."""
    with torch.no_grad():
        model.lm_head.weight.mul_(scale)
    return model


def test_speculative_sampling_keeps_the_target_marginal():
    """Speculative sampling with a different draft: the empirical
    distribution of the second generated token over 3000 rows of one
    prompt matches the target's exact marginal (summed over the first
    token) within 0.06 in total variation, as vanilla sampling does; the
    draft's own marginal is far from it."""
    cfg = dict(vocab_size=12, hidden_size=32, intermediate_size=48,
               num_hidden_layers=1, num_attention_heads=2,
               max_position_embeddings=32)
    target = _peaked(LlamaForCausalLM(LlamaConfig(**cfg), device="cpu",
                                      seed=1), 60.0)
    draft = _peaked(LlamaForCausalLM(LlamaConfig(**cfg), device="cpu",
                                     seed=2), 60.0)
    prompt = torch.tensor([[3, 7, 1, 9]])
    kw = dict(do_sample=True, temperature=1.0, top_k=0, top_p=1.0)

    def exact(model):
        with torch.no_grad():
            p0 = torch.softmax(model(prompt)[0, -1], -1)
            seqs = torch.cat([prompt.repeat(12, 1),
                              torch.arange(12)[:, None]], 1)
            p1 = torch.softmax(model(seqs)[:, -1], -1)
        return (p0[:, None] * p1).sum(0)

    def tv(ids, p):
        freq = torch.bincount(ids[:, 1].long(), minlength=12) / ids.shape[0]
        return 0.5 * (freq - p).abs().sum().item()

    n = 3000
    want = exact(target)
    rows = prompt.repeat(n, 1)
    spec = target.generate(rows, max_new_tokens=3, draft_model=draft,
                           speculative_k=2, seed=4, **kw)
    vanilla = target.generate(rows, max_new_tokens=3, seed=4, **kw)
    assert tv(vanilla, want) < 0.06
    assert tv(spec, want) < 0.06
    assert 0.5 * (exact(draft) - want).abs().sum().item() > 0.3


def test_program_cache_keys():
    """Programs are keyed by the signature (the cache dtype among it) and
    the parameters' addresses: an in-place update keeps the program and
    is seen by it, a replaced parameter makes a new one and drops the old;
    two live drafts keep separate entries, a dead one is swept."""
    _, tm = _llama()
    ids = _prompts()
    base = tm.generate(ids, max_new_tokens=4)
    tm.generate(ids, max_new_tokens=4, cache_dtype="int8")
    assert len(tm._gen_cache) == 2
    prog = _newest(tm)
    with torch.no_grad():
        w = tm.lm_head.weight
        saved = w.clone()
        w.mul_(-1.0)                       # in place: the same program
    flipped = tm.generate(ids, max_new_tokens=4, cache_dtype="int8")
    assert _newest(tm) is prog and len(tm._gen_cache) == 2
    fresh = _llama()[1]
    with torch.no_grad():
        fresh.lm_head.weight.mul_(-1.0)
    np.testing.assert_array_equal(
        flipped.numpy(), fresh.generate(ids, max_new_tokens=4,
                                        cache_dtype="int8").numpy())
    tm.lm_head.weight = torch.nn.Parameter(saved)    # replaced
    assert torch.equal(tm.generate(ids, max_new_tokens=4), base)
    assert _newest(tm) is not prog and len(tm._gen_cache) == 1
    d1 = _llama(seed=3, num_hidden_layers=1)[1]
    d2 = _llama(seed=3, num_hidden_layers=1)[1]
    progs = []
    for d in (d1, d2, d1, d2):
        tm.generate(ids, max_new_tokens=4, draft_model=d, speculative_k=2)
        progs.append(_newest(tm))
    assert progs[2] is progs[0] and progs[3] is progs[1]
    specs = list(tm._gen_cache.values())
    assert len(specs) == 2 and {p.draft_ref() for p in specs} == {d1, d2}
    # d2's program is the most recently used: only the sweep of dead
    # drafts, not the bound, drops it ahead of d1's
    del d, d2, specs, progs
    import gc
    gc.collect()
    tm.generate(ids, max_new_tokens=4, draft_model=_llama(
        seed=4, num_hidden_layers=1)[1], speculative_k=2)
    drafts = [p.draft_ref() for p in tm._gen_cache.values()]
    assert d1 in drafts and len(drafts) == 2


def test_program_cache_is_bounded_and_frees_what_it_drops():
    """An evaluation loop over prompts of many lengths: each length is a
    signature of its own, yet the model keeps at most MAX_PROGRAMS
    programs, the least recently used dropped, and a dropped program's
    static caches are freed (nothing else holds them)."""
    import gc
    import weakref
    _, tm = _llama()
    refs = []
    for s in range(4, 10):
        want = tm.generate(_prompts(s, s=s), max_new_tokens=3)
        refs.append(weakref.ref(_newest(tm)))
        assert len(tm._gen_cache) <= G.MAX_PROGRAMS
    gc.collect()
    alive = [r() for r in refs if r() is not None]
    assert alive == list(tm._gen_cache.values())
    assert len(alive) == G.MAX_PROGRAMS
    # the newest signature again: the same program, the same tokens
    np.testing.assert_array_equal(
        tm.generate(_prompts(9, s=9), max_new_tokens=3).numpy(), want.numpy())
    assert _newest(tm) is alive[-1]


def test_generate_runs_in_eval_mode_and_restores_training(llama,
                                                          greedy_ref):
    tm = llama[1]
    tm.train()
    try:
        got = tm.generate(greedy_ref[0], max_new_tokens=NEW)
        assert tm.training
    finally:
        tm.eval()
    np.testing.assert_array_equal(got.numpy(), greedy_ref[1])
