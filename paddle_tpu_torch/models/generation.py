"""Autoregressive generation over a static KV cache (counterpart:
``paddle_tpu/models/generation.py``).

- Each layer's cache is a static ``[B, T, KV, D]`` K/V pair
  (:func:`init_static_caches`), or for ``cache_dtype="int8"`` a pair of
  ``(codes int8 [B, T, KV, D], scales float32 [B, T, KV])`` tuples. ``T``
  is ``prompt + new tokens`` rounded up to a multiple of K5's page size
  16, and the int8 scales carry no trailing 1 (the JAX package keeps
  ``T`` exact and scales ``[B, T, KV, 1]``): slots past ``offset + S``
  are masked, so no output changes.
- :func:`cached_attention` writes the new K/V at ``offset + arange(S)``
  (``index_copy_`` with the offset as a device tensor, so that the write
  can be captured in a CUDA graph) and attends the queries over the
  whole buffer with the absolute-position mask ``k_pos <= q_pos`` and an
  optional window. On CUDA tensors that is one call of K5, the ragged
  paged attention kernel, through ``serving.attention.planned_attention``:
  a static cache ``[B, T, KV, D]`` is the page pool ``[B·T/16, 16, KV,
  D]`` (a view) under the page table ``arange(B·T/16).view(B, T/16)``,
  and the int8 scales ``[B, T, KV]`` are K5's scale pool. On CPU tensors
  it is the plain version, the JAX package's einsum form.
- :class:`GenerationMixin` adds ``generate()`` to a causal LM that has
  ``_init_caches(batch, total_len, cache_dtype)`` and
  ``_forward_cached(input_ids, caches, offset)``: greedy, temperature /
  top-k / top-p sampling, ``eos`` with a finished-row mask,
  ``repetition_penalty``, ``min_new_tokens``, beam search and
  speculative decoding with a draft model. The prefill runs eagerly;
  every later step runs from static buffers whose state (the offset, the
  step, the last tokens) lives on the device, so that on the card each
  decode step (each speculative round) is one CUDA graph replay, captured
  at the signature's first use. The host fetches one thing per call, the
  result; a speculative round also reads its accepted count to decide
  whether to loop (the JAX package's ``while_loop`` decides on the
  device).
- The programs (static buffers and graphs) are cached on the model per
  the JAX package's signature plus the parameters' ``data_ptr``\\ s: an
  in-place weight update keeps a program, replacing a parameter makes a
  new one (and drops those of the old parameters). A program holds its
  signature's whole static cache (2.7 GB for LLaMA-2-7B at 8 × 640), so
  a model keeps at most :data:`MAX_PROGRAMS`, the least recently used
  dropped first, before the new one allocates (the JAX package keeps
  only compiled functions and frees each call's caches).
- Sampling noise is the counter hash of ``serving/sampling.py``
  (:func:`~..serving.sampling.lane_noise`), keyed on ``(seed, stream,
  step · B + row, vocabulary entry)``; PyTorch cannot reproduce JAX's
  threefry bits, so a sampled stream is reproducible within the port
  only. ``seed=None`` draws one seed from the model's ``generator``
  before the loop.

``stats`` counts the plain version's calls, graphs captured and
replayed, and the host fetches of ``generate``.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..ops.fa_kernel import _mul32
from ..serving import attention as _attention
from ..serving.attention import paged_plan, planned_attention, quantize_q8
from ..serving.sampling import _fmix32, lane_noise, lane_uniform

__all__ = ["GenerationMixin", "CachePlan", "cached_attention",
           "cached_attention_plain", "init_static_caches", "stats",
           "reset_stats", "PAGE", "MAX_PROGRAMS"]

PAGE = 16  # K5's page size: T is rounded up to a multiple of it
MAX_PROGRAMS = 2  # generate programs (static caches + graphs) per model

stats = {"plain_calls": 0, "graphs_captured": 0, "graph_replays": 0,
         "host_fetches": 0}

_SEED_HIGH = 2 ** 31 - 1
# noise streams: vanilla sampling, the draft's draws, the acceptance
# uniforms and the residual draws of speculative sampling
_MAIN, _DRAFT, _ACCEPT, _RESID = 0, 1, 2, 3


def reset_stats():
    for key in stats:
        stats[key] = 0


def _round_up(n):
    return -(-int(n) // PAGE) * PAGE


def init_static_caches(n_layers, batch, total_len, n_kv, head_dim,
                       cache_dtype=None, float_dtype=torch.float32,
                       device=None):
    """Per layer a ``(k, v)`` pair of zeroed ``[B, T, KV, D]`` buffers in
    ``float_dtype`` (or ``cache_dtype``), or for ``cache_dtype="int8"``
    ``(codes int8 [B, T, KV, D], scales float32 [B, T, KV])`` tuples; ``T``
    is ``total_len`` rounded up to a multiple of :data:`PAGE`."""
    t = _round_up(total_len)
    shape = (batch, t, n_kv, head_dim)

    def one():
        if cache_dtype == "int8":
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3], dtype=torch.float32,
                                device=device))
        dt = float_dtype if cache_dtype is None else getattr(torch,
                                                             cache_dtype)
        return torch.zeros(shape, dtype=dt, device=device)

    return [(one(), one()) for _ in range(n_layers)]


def _normalize_cache_dtype(cache_dtype):
    """Accept None, "int8" (or an int8 dtype-like: the quantized cache) or
    a float dtype-like of bfloat16, float16 or float32; reject the rest."""
    if cache_dtype is None:
        return None
    if isinstance(cache_dtype, torch.dtype):
        name = str(cache_dtype).removeprefix("torch.")
    else:
        try:
            name = str(np.dtype(cache_dtype))
        except TypeError:
            name = str(cache_dtype)
    if name == "int8":
        return "int8"
    if name in ("bfloat16", "float16", "float32"):
        return name
    raise ValueError(f"unsupported cache_dtype {cache_dtype!r}: use None, "
                     "'int8' (quantized codes+scales), or a float dtype")


class CachePlan:
    """What every layer of one cached forward of ``[B, S]`` tokens at
    ``offset`` over caches shaped as ``k_buf`` (one layer's K buffer or
    int8 tuple) shares, built once before the layers: the written slots
    ``idx`` (int64 ``[S]``, ``offset + arange(S)``), the offset, and on
    the card K5's page table, context lengths and plan."""

    def __init__(self, offset, b, s, k_buf):
        buf = k_buf[0] if isinstance(k_buf, tuple) else k_buf
        t, device = buf.shape[1], buf.device
        off = torch.as_tensor(offset, device=device).to(torch.int64)
        self.offset = off.reshape(())
        self.idx = self.offset + torch.arange(s, device=device)
        self.page_table = self.context_lens = self.k5 = None
        if device.type == "cuda":
            self.page_table = torch.arange(
                b * t // PAGE, dtype=torch.int32,
                device=device).view(b, t // PAGE)
            q_off = self.offset.to(torch.int32).expand(b).contiguous()
            self.context_lens = (q_off + s).contiguous()
            self.k5 = paged_plan(q_off, s)


def _write(buf, idx, x):
    """Write ``x [B, S, KV, D]`` into ``buf`` at slots ``idx``, quantized
    for an int8 ``(codes, scales)`` tuple."""
    if isinstance(buf, tuple):
        codes, scales = quantize_q8(x)
        buf[0].index_copy_(1, idx, codes)
        buf[1].index_copy_(1, idx, scales)
    else:
        buf.index_copy_(1, idx, x.to(buf.dtype))


def cached_attention(q, k_new, v_new, k_buf, v_buf, plan, scale,
                     window=None):
    """Write k/v at the plan's offset into the static cache and attend
    ``q`` over the whole buffer with the absolute-position causal mask
    (and Mistral's ``window``: keys older than ``q_pos - window + 1``
    masked).

    q ``[B, S, H, D]``; k_new/v_new ``[B, S, KV, D]``; k_buf/v_buf
    ``[B, T, KV, D]`` buffers or int8 ``(codes, scales)`` tuples (written
    in place); ``plan`` the forward's :class:`CachePlan` (the JAX
    function's ``offset`` and what every layer shares). Returns ``(out
    [B, S, H, D] in q.dtype, k_buf, v_buf)``. On CUDA tensors one K5
    call, which raises on what it does not take; on CPU tensors
    :func:`cached_attention_plain`."""
    b, s, nh, d = q.shape
    quant = isinstance(k_buf, tuple)
    _write(k_buf, plan.idx, k_new)
    _write(v_buf, plan.idx, v_new)
    if not q.is_cuda:
        out = cached_attention_plain(q, k_buf, v_buf, plan.offset, scale,
                                     window)
        return out, k_buf, v_buf
    nkv = k_new.shape[2]
    if quant:
        kp = (k_buf[0].view(-1, PAGE, nkv, d), k_buf[1].view(-1, PAGE, nkv))
        vp = (v_buf[0].view(-1, PAGE, nkv, d), v_buf[1].view(-1, PAGE, nkv))
    else:
        if k_buf.dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(
                f"cached_attention: a {k_buf.dtype} cache has no K5 arm on "
                "the card; use cache_dtype bfloat16, float32 or int8")
        kp = k_buf.view(-1, PAGE, nkv, d)
        vp = v_buf.view(-1, PAGE, nkv, d)
    out = planned_attention(q.reshape(b * s, nh, d), kp, vp,
                            plan.page_table, plan.context_lens, plan.k5,
                            scale=scale, window=window)
    return out.reshape(b, s, nh, d), k_buf, v_buf


def cached_attention_plain(q, k_buf, v_buf, offset, scale, window=None):
    """The plain version, on any device: the JAX package's einsum form over
    the (already written) buffers, in float32 (int8: scores on the codes,
    K's scales applied after the dot, V's folded into the
    probabilities)."""
    stats["plain_calls"] += 1
    b, s, nh, d = q.shape
    quant = isinstance(k_buf, tuple)
    nkv = (k_buf[0] if quant else k_buf).shape[2]
    t = (k_buf[0] if quant else k_buf).shape[1]
    g = nh // nkv
    qg = q.reshape(b, s, nkv, g, d).float()
    if quant:
        (kq, ks), (vq, vs) = k_buf, v_buf
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kq.float())
        sc = sc * scale * ks.permute(0, 2, 1)[:, :, None, None, :]
    else:
        sc = torch.einsum("bskgd,btkd->bkgst", qg, k_buf.float()) * scale
    off = torch.as_tensor(offset, device=q.device).to(torch.int64)
    qpos = off + torch.arange(s, device=q.device)
    kpos = torch.arange(t, device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    if window:  # 0/None both mean disabled
        mask = mask & (kpos[None, :] > qpos[:, None] - int(window))
    sc = sc.masked_fill(~mask, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    if quant:
        p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
        out = torch.einsum("bkgst,btkd->bskgd", p, vq.float())
    else:
        out = torch.einsum("bkgst,btkd->bskgd", p, v_buf.float())
    return out.reshape(b, s, nh, d).to(q.dtype)


# -- sampling ----------------------------------------------------------------

def _filter_logits(logits, temperature, top_k, top_p):
    """The sampling stack's logit transform, the JAX package's rules:
    float32 logits over ``max(temperature, 1e-6)``; top-k masks what lies
    below the k-th value; top-p keeps the smallest sorted prefix whose
    mass reaches ``top_p`` (ties of its last value included)."""
    lg = logits.float() / max(temperature, 1e-6)
    v = lg.shape[-1]
    if top_k and top_k > 0:
        kth = torch.topk(lg, min(top_k, v), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    if top_p < 1.0:
        srt = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        cut = torch.clamp((cum < top_p).sum(-1, keepdim=True), max=v - 1)
        lg = torch.where(lg < srt.gather(-1, cut), float("-inf"), lg)
    return lg


def _stream_seeds(seed, stream, b):
    """One 32-bit key per row for noise stream ``stream`` of ``seed`` (an
    int64 ``[1]`` device tensor)."""
    key = _fmix32(_mul32(seed & 0xFFFFFFFF, 0x9E3779B1)
                  ^ _mul32(torch.full_like(seed, stream), 0x632BE5AB))
    return key.expand(b)


def _counters(step, b, device):
    """``step · B + row``: each row's counter at ``step`` (a device
    tensor or an int)."""
    step = torch.as_tensor(step, device=device).to(torch.int64)
    return step * b + torch.arange(b, device=device)


def _gumbel(seed, stream, step, b, v):
    """Gumbel noise ``[B, V]`` keyed on (seed, stream, step · B + row,
    entry)."""
    return lane_noise(_stream_seeds(seed, stream, b),
                      _counters(step, b, seed.device), v)


def _sample_token(logits, do_sample, temperature, top_k, top_p, seed=None,
                  step=0, stream=_MAIN):
    """logits ``[B, V]`` → int64 token ``[B]``: the argmax (greedy), or
    Gumbel-max over the filtered logits with the counter-hash noise of
    ``step``."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    lg = _filter_logits(logits, temperature, top_k, top_p)
    b, v = lg.shape
    return torch.argmax(lg + _gumbel(seed, stream, step, b, v), dim=-1)


# -- CUDA graphs -------------------------------------------------------------

class _Graph:
    """``body`` (no arguments, reads and writes static buffers) captured
    as a CUDA graph after one warm-up run on a side stream. K5's counters
    move by the capture's change at every replay; the warm-up and the
    capture count nothing."""

    def __init__(self, body, device, pool):
        saved = dict(_attention.stats)
        saved_plain = stats["plain_calls"]
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        before = dict(_attention.stats)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            body()
        self.launches = {k: _attention.stats[k] - before[k] for k in before}
        self.plain = stats["plain_calls"] - saved_plain
        _attention.stats.update(saved)
        stats["plain_calls"] = saved_plain
        stats["graphs_captured"] += 1

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            _attention.stats[k] += n
        stats["plain_calls"] += self.plain
        stats["graph_replays"] += 1


class _Program:
    """The static buffers of one generate signature and, on the card, the
    CUDA graphs of its steps. ``run(name, body)`` runs ``body`` eagerly on
    the CPU and as a replay of its graph (captured at first use, before
    any state of the call is set) on the card."""

    def __init__(self, device):
        self.device = device
        self.graphs = {}
        self._pool = None

    def live(self):
        """Whether the program can still run (a speculative one needs its
        draft)."""
        return True

    def rewind(self):
        """Set a decode step's state (the offset ``off``, the step ``i``)
        to just after the prefill; the tokens and caches keep what they
        hold, so that a step can also be replayed again for timing."""
        self.off.fill_(self.s)
        self.i.zero_()

    def capture(self, name, body):
        if self.device.type != "cuda" or name in self.graphs:
            return
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self.graphs[name] = _Graph(body, self.device, self._pool)

    def run(self, name, body):
        if self.device.type == "cuda":
            self.graphs[name].replay()
        else:
            body()


def _fetch(x):
    """A device-to-host copy (a copy on the CPU too: the result must not
    alias the program's buffers)."""
    stats["host_fetches"] += 1
    return x.to("cpu", copy=True)


# -- generate ----------------------------------------------------------------

_SPEC_UIDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SPEC_UID_NEXT = 0


def _draft_uid(draft):
    """Monotonic uid per live draft model (weak-keyed, never reused): part
    of the speculative program's key."""
    global _SPEC_UID_NEXT
    uid = _SPEC_UIDS.get(draft)
    if uid is None:
        uid = _SPEC_UID_NEXT
        _SPEC_UID_NEXT += 1
        _SPEC_UIDS[draft] = uid
    return uid


def _param_ptrs(model):
    return tuple(p.data_ptr() for p in model.parameters())


class _EvalMode:
    """Generation is inference: the models run in eval mode, and those
    that were training are put back afterwards."""

    def __init__(self, *models):
        self.was = [(m, m.training) for m in models]

    def __enter__(self):
        for m, _ in self.was:
            m.eval()

    def __exit__(self, *exc):
        for m, w in self.was:
            m.train(w)


class GenerationMixin:
    """Adds ``generate()`` to a causal LM exposing
    ``_init_caches(batch, total_len, cache_dtype)`` and
    ``_forward_cached(input_ids, caches, offset)`` → ``(logits [B, S, V],
    caches)``, a ``cfg`` and a ``generator``."""

    def _gen_program(self, sig, build, draft=None):
        """The program of ``sig`` (whose last item is the parameters'
        pointers), or a new one from ``build()``. Before building, drop
        what can no longer hit (programs over parameters that are gone,
        speculative ones whose draft died: draft uids are never reused)
        and then the least recently used beyond ``MAX_PROGRAMS - 1``, so
        that their caches are freed before the new ones are allocated."""
        cache = getattr(self, "_gen_cache", None)
        if cache is None:
            cache = self._gen_cache = OrderedDict()
        prog = cache.get(sig)
        if prog is not None and (draft is None
                                 or prog.draft_ref() is draft):
            cache.move_to_end(sig)
            return prog
        for key in [k for k, p in cache.items()
                    if k[-1] != sig[-1] or not p.live()]:
            del cache[key]
        while len(cache) >= MAX_PROGRAMS:
            cache.popitem(last=False)
        prog = cache[sig] = build()
        return prog

    def _max_positions(self):
        return getattr(getattr(self, "cfg", None), "max_position_embeddings",
                       None)

    def _gen_seed(self, seed):
        """An int64 ``[1]`` seed on the model's device: ``seed``, or one
        drawn from the model's generator (no host read)."""
        dev = self.device
        if seed is not None:
            return torch.tensor([int(seed) & 0xFFFFFFFF], dtype=torch.int64,
                                device=dev)
        g = self.generator
        return torch.randint(0, _SEED_HIGH, (1,), generator=g,
                             device=g.device).to(dev)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 seed=None, num_beams=1, length_penalty=0.0,
                 cache_dtype=None, draft_model=None, speculative_k=4,
                 repetition_penalty=1.0, min_new_tokens=0):
        """Generated token ids ``[B, max_new_tokens]`` (int32, on the
        host: the call's one fetch).

        ``num_beams > 1`` runs beam search (``do_sample`` must be False):
        the beams ride the batch dimension, the caches are reordered by a
        gather every step, and ``length_penalty`` applies the GNMT
        ``((5 + len) / 6) ** p`` normalisation at the final selection.
        ``repetition_penalty`` divides the logits of every token already
        seen (prompt and generated) by the penalty where positive and
        multiplies them where negative; ``min_new_tokens`` bans
        ``eos_token_id`` for the first N generated tokens: both on the
        greedy / sampling path only. ``draft_model`` runs speculative
        decoding with ``speculative_k`` proposals a round."""
        dev = self.device
        if isinstance(input_ids, torch.Tensor):
            ids = input_ids.to(device=dev, dtype=torch.int64)
        else:
            ids = torch.as_tensor(np.asarray(input_ids),
                                  dtype=torch.int64).to(dev)
        b, s = ids.shape
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        eos = -1 if eos_token_id is None else int(eos_token_id)
        cache_dtype = _normalize_cache_dtype(cache_dtype)
        rp = float(repetition_penalty)
        min_new = int(min_new_tokens)
        if rp <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, got {rp}")
        if (rp != 1.0 or min_new > 0) and \
                (int(num_beams) > 1 or draft_model is not None):
            raise NotImplementedError(
                "repetition_penalty / min_new_tokens are wired into the "
                "greedy/sampling decode loop only (num_beams=1, no "
                "draft_model)")
        if min_new > max_new:
            raise ValueError(f"min_new_tokens({min_new}) exceeds "
                             f"max_new_tokens({max_new})")
        vocab = getattr(getattr(self, "cfg", None), "vocab_size", None)
        if min_new > 0 and eos >= 0 and vocab is not None \
                and eos >= int(vocab):
            raise ValueError(f"eos_token_id({eos}) out of range for "
                             f"vocab_size({vocab})")
        if draft_model is not None:
            if int(num_beams) > 1:
                raise NotImplementedError(
                    "speculative decoding is single-beam (num_beams=1); "
                    "greedy and sampling are both supported")
            sample_cfg = (float(temperature), int(top_k),
                          float(top_p)) if do_sample else None
            return self._speculative_generate(
                ids, max_new, draft_model, int(speculative_k), eos,
                cache_dtype, sample_cfg, seed)
        maxpos = self._max_positions()
        if maxpos is not None and s + max_new > maxpos:
            raise ValueError(
                f"generate: prompt_len({s}) + max_new_tokens({max_new}) "
                f"exceeds max_position_embeddings({maxpos})")
        if int(num_beams) > 1:
            if do_sample:
                raise NotImplementedError(
                    "beam sampling is not supported: use num_beams>1 "
                    "with do_sample=False, or sampling with num_beams=1")
            return self._beam_generate(ids, max_new, int(num_beams), eos,
                                       float(length_penalty), cache_dtype)
        sig = (b, s, max_new, bool(do_sample), float(temperature),
               int(top_k), float(top_p), eos, cache_dtype, rp, min_new,
               _param_ptrs(self))
        prog = self._gen_program(sig, lambda: _VanillaProgram(
            self, b, s, max_new, bool(do_sample), float(temperature),
            int(top_k), float(top_p), eos, cache_dtype, rp, min_new))
        with _EvalMode(self):
            return prog(ids, self._gen_seed(seed))

    def _beam_generate(self, ids, max_new, k, eos, lenpen, cache_dtype):
        b, s = ids.shape
        sig = (b, s, max_new, "beam", k, eos, lenpen, cache_dtype,
               _param_ptrs(self))
        prog = self._gen_program(sig, lambda: _BeamProgram(
            self, b, s, max_new, k, eos, lenpen, cache_dtype))
        with _EvalMode(self):
            return prog(ids)

    def _speculative_generate(self, ids, max_new, draft, k, eos,
                              cache_dtype, sample_cfg=None, seed=None):
        if getattr(draft.cfg, "vocab_size", None) != \
                getattr(self.cfg, "vocab_size", None):
            raise ValueError("draft and target models must share a "
                             "vocabulary")
        if not 1 <= k <= 16:
            raise ValueError(f"speculative_k must be in [1, 16], got {k}")
        if draft.device != self.device:
            raise ValueError(f"the draft lies on {draft.device}, the target "
                             f"on {self.device}")
        b, s = ids.shape
        for m_ in (self, draft):
            maxpos = m_._max_positions()
            if maxpos is not None and s + max_new + k + 1 > maxpos:
                raise ValueError(
                    f"prompt_len({s}) + max_new({max_new}) + k+1 exceeds "
                    f"max_position_embeddings({maxpos})")
        # the program holds the draft by weakref, checked by identity at
        # every hit, under a per-draft uid that is never reused (two live
        # drafts of one shape keep separate entries)
        sig = (b, s, max_new, "spec", _draft_uid(draft), k, eos,
               cache_dtype, sample_cfg, _param_ptrs(draft),
               _param_ptrs(self))
        prog = self._gen_program(sig, lambda: _SpecProgram(
            self, draft, b, s, max_new, k, eos, cache_dtype, sample_cfg),
            draft)
        with _EvalMode(self, draft):
            out = prog(ids, self._gen_seed(seed))
        # rounds == ceil((max_new - 1) / (k + 1)) at full acceptance
        self._last_spec_rounds = len(prog.accepted)
        return out


class _VanillaProgram(_Program):
    """Greedy / sampling: the prefill, then ``max_new - 1`` decode steps,
    each one graph replay on the card (embed, the layers with K5, head,
    adjust, sample, the finished mask, the token into the output)."""

    def __init__(self, model, b, s, max_new, do_sample, temperature, top_k,
                 top_p, eos, cache_dtype, rp, min_new):
        super().__init__(model.device)
        dev = self.device
        self.model, self.b, self.s, self.max_new = model, b, s, max_new
        self.sample = (do_sample, temperature, top_k, top_p)
        self.eos, self.rp, self.min_new = eos, rp, min_new
        self.use_rp = rp != 1.0
        self.use_minnew = min_new > 0 and eos >= 0
        self.caches = model._init_caches(b, s + max_new, cache_dtype)
        self.tok = torch.zeros(b, dtype=torch.int64, device=dev)
        self.off = torch.zeros((), dtype=torch.int64, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.seed = torch.zeros(1, dtype=torch.int64, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.seen = torch.zeros(b, model.cfg.vocab_size if self.use_rp
                                else 1, dtype=torch.bool, device=dev)
        self.out = torch.zeros(b, max_new, dtype=torch.int32, device=dev)

    def _adjust(self, logits, new_idx):
        """Repetition penalty and the eos ban below ``min_new_tokens``
        (``new_idx``: 1-based index of the token about to be sampled);
        never called on the plain path."""
        lg = logits.float()
        if self.use_rp:
            pen = torch.where(lg > 0, lg / self.rp, lg * self.rp)
            lg = torch.where(self.seen, pen, lg)
        if self.use_minnew:
            lg = lg.clone()
            lg[:, self.eos] = torch.where(new_idx <= self.min_new,
                                          float("-inf"), lg[:, self.eos])
        return lg

    def _pick(self, logits, new_idx):
        plain = not (self.use_rp or self.use_minnew)
        lg = logits if plain else self._adjust(logits, new_idx)
        return _sample_token(lg, *self.sample, seed=self.seed,
                             step=new_idx - 1)

    def step(self):
        """One decode step on the static buffers."""
        logits, _ = self.model._forward_cached(self.tok[:, None],
                                               self.caches, self.off)
        nxt = self._pick(logits[:, -1], self.i + 2)
        nxt = torch.where(self.finished, self.eos, nxt)
        if self.use_rp:
            self.seen.scatter_(1, nxt[:, None], True)
        self.finished |= nxt == self.eos
        self.out.index_copy_(1, (self.i + 1).view(1),
                             nxt[:, None].to(torch.int32))
        self.tok.copy_(nxt)
        self.off += 1
        self.i += 1

    def __call__(self, ids, seed):
        if self.max_new > 1:
            self.capture("step", self.step)
        self.seed.copy_(seed)
        logits, _ = self.model._forward_cached(ids, self.caches, 0)
        self.seen.zero_()
        if self.use_rp:
            self.seen.scatter_(1, ids, True)
        tok = self._pick(logits[:, -1],
                         torch.ones((), dtype=torch.int64,
                                    device=self.device))
        if self.use_rp:
            self.seen.scatter_(1, tok[:, None], True)
        self.finished.copy_(tok == self.eos)
        self.out[:, 0] = tok.to(torch.int32)
        self.tok.copy_(tok)
        self.rewind()
        for _ in range(self.max_new - 1):
            self.run("step", self.step)
        return _fetch(self.out)


class _BeamProgram(_Program):
    """Beam search: the prefill at batch B, the top-K first tokens, the
    caches repeated K times (rows ``[b0 beams..., b1 beams...]``); then
    ``max_new - 1`` steps, each one graph replay on the card, that
    reorder the caches by the chosen beams in place (the buffers keep
    their addresses). Finished beams continue with ``eos`` alone at zero
    cost."""

    def __init__(self, model, b, s, max_new, k, eos, lenpen, cache_dtype):
        super().__init__(model.device)
        dev = self.device
        self.model, self.b, self.s, self.max_new, self.k = (model, b, s,
                                                            max_new, k)
        self.eos, self.lenpen, self.cache_dtype = eos, lenpen, cache_dtype
        v = model.cfg.vocab_size
        self.caches = model._init_caches(b * k, s + max_new, cache_dtype)
        self.tok = torch.zeros(b * k, dtype=torch.int64, device=dev)
        self.off = torch.zeros((), dtype=torch.int64, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.scores = torch.zeros(b, k, device=dev)
        self.toks = torch.zeros(b, k, max_new, dtype=torch.int32,
                                device=dev)
        self.finished = torch.zeros(b, k, dtype=torch.bool, device=dev)
        self.lengths = torch.ones(b, k, device=dev)
        self.eos_row = torch.full((v,), float("-inf"), device=dev)
        self.eos_row[max(eos, 0)] = 0.0

    def _tensors(self):
        for kv in self.caches:
            for buf in kv:
                yield from (buf if isinstance(buf, tuple) else (buf,))

    def step(self):
        b, k = self.b, self.k
        logits, _ = self.model._forward_cached(self.tok[:, None],
                                               self.caches, self.off)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        v = lp.shape[-1]
        lp = torch.where(self.finished[:, :, None], self.eos_row,
                         lp.view(b, k, v))
        flat = (self.scores[:, :, None] + lp).reshape(b, k * v)
        scores, idx = torch.topk(flat, k, dim=-1)
        beam = idx // v
        tokn = idx % v
        rows = (torch.arange(b, device=self.device)[:, None] * k
                + beam).reshape(-1)
        for buf in self._tensors():
            buf.copy_(buf.index_select(0, rows))
        self.toks.copy_(self.toks.gather(
            1, beam[:, :, None].expand(-1, -1, self.max_new)))
        self.toks.index_copy_(2, (self.i + 1).view(1),
                              tokn[:, :, None].to(torch.int32))
        fin = self.finished.gather(1, beam)
        self.lengths.copy_(self.lengths.gather(1, beam)
                           + torch.where(fin, 0.0, 1.0))
        self.finished.copy_(fin | (tokn == self.eos))
        self.scores.copy_(scores)
        self.tok.copy_(tokn.reshape(-1))
        self.off += 1
        self.i += 1

    def __call__(self, ids):
        b, k = self.b, self.k
        if self.max_new > 1:
            self.capture("step", self.step)
        caches = self.model._init_caches(b, self.s + self.max_new,
                                         self.cache_dtype)
        logits, caches = self.model._forward_cached(ids, caches, 0)
        lp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        scores, tok0 = torch.topk(lp, k, dim=-1)
        for kv, kv0 in zip(self.caches, caches):
            for buf, buf0 in zip(kv, kv0):
                pairs = zip(buf, buf0) if isinstance(buf, tuple) else \
                    ((buf, buf0),)
                for dst, src in pairs:
                    dst.copy_(src.repeat_interleave(k, dim=0))
        del caches
        self.scores.copy_(scores)
        self.toks.zero_()
        self.toks[:, :, 0] = tok0.to(torch.int32)
        self.finished.copy_(tok0 == self.eos)
        self.lengths.fill_(1.0)
        self.tok.copy_(tok0.reshape(-1))
        self.rewind()
        for _ in range(self.max_new - 1):
            self.run("step", self.step)
        scores = self.scores
        if self.lenpen:
            scores = scores / ((5.0 + self.lengths) / 6.0) ** self.lenpen
        best = torch.argmax(scores, dim=1)
        # the chosen beams' (normalised) scores, left on the device
        self.best_scores = scores.gather(1, best[:, None])[:, 0]
        return _fetch(self.toks.gather(
            1, best[:, None, None].expand(-1, 1, self.max_new))[:, 0])


class _SpecProgram(_Program):
    """Speculative decoding: draft-propose / target-verify rounds. Each
    round (one graph replay on the card) runs the draft k+1 single-token
    steps from the current token (the last one lands the draft's K/V at
    ``pos + k``, so that a fully accepted round leaves no hole), the
    target once over ``[cur, d_0..d_{k-1}]``, and the acceptance: greedy
    keeps the batch-minimum prefix of proposals equal to the target's
    argmax, sampling accepts by rejection against the residual. Rollback
    is free: slots past the accepted offset are masked by position and
    overwritten later. The host reads the emitted count once a round to
    decide whether to loop. After a call, ``accepted`` holds each round's
    accepted proposals (the batch minimum) and ``accepted_rows[:rounds]``
    (on the device) each row's own."""

    def __init__(self, model, draft, b, s, max_new, k, eos, cache_dtype,
                 sample_cfg):
        super().__init__(model.device)
        dev = self.device
        self.model, self.draft_ref = model, weakref.ref(draft)
        self.b, self.s, self.max_new, self.k, self.eos = b, s, max_new, k, eos
        self.sample_cfg = sample_cfg
        total = s + max_new + k + 1
        self.tc = model._init_caches(b, total, cache_dtype)
        self.dc = draft._init_caches(b, total, cache_dtype)
        self.cur = torch.zeros(b, dtype=torch.int64, device=dev)
        self.n = torch.zeros((), dtype=torch.int64, device=dev)
        self.r = torch.zeros((), dtype=torch.int64, device=dev)
        self.seed = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf = torch.zeros(b, max_new + k + 1, dtype=torch.int64,
                               device=dev)
        self.accepted_rows = torch.zeros(max_new, b, dtype=torch.int64,
                                         device=dev)
        self.accepted = []

    def live(self):
        return self.draft_ref() is not None

    def _filt(self, lg):
        t, top_k, top_p = self.sample_cfg or (1.0, 0, 1.0)
        return _filter_logits(lg, t, top_k, top_p)

    def round(self):
        draft = self.draft_ref()
        b, k, dev = self.b, self.k, self.device
        do_sample = self.sample_cfg is not None
        pos = self.s + self.n - 1          # sequence position of `cur`
        tok, props, qs = self.cur, [], []
        for i in range(k + 1):
            lg, _ = draft._forward_cached(tok[:, None], self.dc, pos + i)
            f = self._filt(lg[:, -1])
            if do_sample:
                v = f.shape[-1]
                tok = torch.argmax(f + _gumbel(
                    self.seed, _DRAFT, self.r * (k + 1) + i, b, v), dim=-1)
                qs.append(torch.softmax(f, dim=-1))
            else:
                tok = torch.argmax(f, dim=-1)
            props.append(tok)
        d = torch.stack(props[:k], dim=1)                  # [B, k]
        x = torch.cat([self.cur[:, None], d], dim=1)       # [B, k+1]
        tlg, _ = self.model._forward_cached(x, self.tc, pos)
        pf = self._filt(tlg)                               # [B, k+1, V]
        if do_sample:
            qdist = torch.stack(qs[:k], dim=1)             # [B, k, V]
            pdist = torch.softmax(pf, dim=-1)
            psel = pdist[:, :k].gather(-1, d[..., None])[..., 0]
            qsel = qdist.gather(-1, d[..., None])[..., 0]
            u = lane_uniform(_stream_seeds(self.seed, _ACCEPT, b),
                             _counters(self.r, b, dev), k)
            acc = u * torch.clamp(qsel, min=1e-20) < psel
            ok = torch.cumprod(acc.to(torch.int64), dim=1)
            m = ok.sum(1).min()
            # at the cutoff m, rows that accepted proposal m keep it, the
            # others draw from the residual max(p - q, 0) (at m == k q is
            # padded with 0: the residual is p, a fresh target sample)
            ok_pad = torch.cat([ok, ok.new_zeros(b, 1)], dim=1)
            q_pad = torch.cat([qdist, qdist.new_zeros(b, 1, qdist.shape[2])],
                              dim=1)
            mi = m.view(1)
            p_c = pdist.index_select(1, mi)[:, 0]
            q_c = q_pad.index_select(1, mi)[:, 0]
            resid = torch.log(torch.clamp(p_c - q_c, min=0.0) + 1e-20)
            fresh = torch.argmax(resid + _gumbel(
                self.seed, _RESID, self.r, b, resid.shape[-1]), dim=-1)
            d_pad = torch.cat([d, d.new_zeros(b, 1)], dim=1)
            kept = d_pad.index_select(1, mi)[:, 0]
            bonus = torch.where(ok_pad.index_select(1, mi)[:, 0] > 0, kept,
                                fresh)
            e = torch.cat([d, fresh[:, None]], dim=1)
            e = torch.where(torch.arange(k + 1, device=dev)[None, :] == m,
                            bonus[:, None], e)
            cur = bonus
        else:
            g = torch.argmax(pf, dim=-1)                    # [B, k+1]
            ok = torch.cumprod((g[:, :k] == d).to(torch.int64), dim=1)
            m = ok.sum(1).min()
            e = g
            cur = g.index_select(1, m.view(1))[:, 0]
        # emit e[:, :m+1]; all k+1 are written, the next round overwrites
        # the tail
        self.accepted_rows.index_copy_(0, self.r.view(1), ok.sum(1)[None])
        self.buf.index_copy_(1, self.n + torch.arange(k + 1, device=dev), e)
        self.cur.copy_(cur)
        self.n += m + 1
        self.r += 1

    def __call__(self, ids, seed):
        draft = self.draft_ref()
        if draft is None:
            raise RuntimeError("speculative draft model was garbage-"
                               "collected")
        self.capture("round", self.round)
        self.seed.copy_(seed)
        tlogits, _ = self.model._forward_cached(ids, self.tc, 0)
        draft._forward_cached(ids, self.dc, 0)
        do_sample = self.sample_cfg is not None
        cur = _sample_token(tlogits[:, -1], do_sample,
                            *(self.sample_cfg or (1.0, 0, 1.0)),
                            seed=self.seed, step=0)
        self.buf.fill_(self.eos if self.eos >= 0 else 0)
        self.buf[:, 0] = cur
        self.cur.copy_(cur)
        self.n.fill_(1)
        self.r.zero_()
        self.accepted, n = [], 1
        while n < self.max_new:
            self.run("round", self.round)
            m = int(_fetch(self.n)) - n - 1   # the round's one host read
            self.accepted.append(m)
            n += m + 1
        out = self.buf[:, :self.max_new]
        if self.eos >= 0:
            seen = torch.cumsum((out == self.eos).to(torch.int64), dim=1)
            after = torch.cat([torch.zeros_like(seen[:, :1]),
                               seen[:, :-1]], dim=1) > 0
            out = torch.where(after, self.eos, out)
        return _fetch(out.to(torch.int32))
