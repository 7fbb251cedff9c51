"""Continuous-batching inference engine over the paged KV cache
(counterpart: ``paddle_tpu/serving/engine.py::ServingEngine``, its
default bucketed path).

- ``step()`` runs one scheduler iteration: a decode batch of every
  running request plus at most one prefill chunk; ``run()`` loops until
  every request finished.
- Decode runs at batch buckets (powers of two up to ``max_batch``, S=1);
  prefill runs at (B=1, S=``prefill_chunk``). Padded lanes are real
  lanes pointed at the cache's SCRATCH page with context 1, so their
  attention rows stay finite; the host discards them.
- Every forward goes through :func:`_paged_forward`: per layer, RMSNorm,
  q/k/v, RoPE from the absolute positions, the step's K/V written into
  the page pool in place, paged attention (the hand-written CUDA kernel
  on the card, its plain version on the CPU), o_proj and the SwiGLU MLP.
  It runs eagerly; the JAX package's ``jit`` has no counterpart here.
- Sampling runs on the device (:mod:`.sampling`); the host fetches
  ``[B]`` token ids and logprobs per step.
- Preemption by page pressure frees the newest live request and requeues
  it for a recompute prefill that keeps its generated tokens.

Arguments of the JAX engine outside this slice (speculative decoding,
the prefix cache, weight quantization, chaos, the host KV tier, draft
distillation, the ragged step, tensor parallelism) raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..nn.functional import fused_rotary_position_embedding
from .attention import paged_attention
from .kv_cache import SCRATCH_PAGE, OutOfPages, PagedKVCache
from .metrics import ServingMetrics
from .sampling import fused_sample
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingEngine"]

_CACHE_DTYPES = {"float32": "float32", "bfloat16": "bfloat16",
                 "int8": "int8", torch.float32: "float32",
                 torch.bfloat16: "bfloat16", torch.int8: "int8"}


def _refuse_unported(**flags):
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"ServingEngine({name}=...) is not ported to "
                "paddle_tpu_torch yet")


class ServingEngine:
    @staticmethod
    def _validate_causal_lm(model):
        cfg = getattr(model, "cfg", None)
        core = getattr(model, "llama", model)
        for attr in ("embed_tokens", "layers", "norm"):
            if not hasattr(core, attr):
                raise TypeError(
                    "ServingEngine needs a LLaMA-family causal LM "
                    "(model.llama or a core module with embed_tokens/"
                    f"layers/norm); {type(model).__name__} lacks {attr!r}")
        if not hasattr(model, "lm_head"):
            raise TypeError("model must expose lm_head")
        if cfg is None:
            raise TypeError("model must carry a .cfg")
        return cfg, core

    def __init__(self, model, *, page_size=16, num_pages=None,
                 hbm_budget_mb=None, max_batch=8, prefill_chunk=32,
                 max_seq_len=None, eos_token_id=None, watermark_frac=0.05,
                 cache_dtype=None, device=None, on_event=None,
                 prefix_cache=None, draft_model=None, speculative_k=None,
                 weight_quant=None, chaos=None, host_pool=None,
                 distill=None, ragged=None, mesh=None, tp_degree=None):
        _refuse_unported(
            prefix_cache=prefix_cache, draft_model=draft_model is not None,
            speculative_k=speculative_k, weight_quant=weight_quant,
            chaos=chaos is not None, host_pool=host_pool is not None,
            distill=distill is not None, ragged=ragged,
            mesh=mesh is not None, tp_degree=(tp_degree or 1) > 1)
        cfg, core = self._validate_causal_lm(model)
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev != self.device:
            raise ValueError(f"the model lies on {model_dev}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self._core = core
        nh = cfg.num_attention_heads
        nkv = getattr(cfg, "num_key_value_heads", None) or nh
        hd = cfg.hidden_size // nh
        self.max_seq_len = int(max_seq_len
                               or cfg.max_position_embeddings)
        if self.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len({self.max_seq_len}) exceeds "
                f"max_position_embeddings({cfg.max_position_embeddings})")
        if cache_dtype is None:
            cache_dtype = ("bfloat16" if cfg.dtype == "bfloat16"
                           else "float32")
        if cache_dtype not in _CACHE_DTYPES:
            raise ValueError(
                f"unsupported cache_dtype {cache_dtype!r}: use 'int8' "
                "(quantized codes+scales), 'bfloat16' or 'float32'")
        self.cache_dtype = _CACHE_DTYPES[cache_dtype]
        self.cache = PagedKVCache(
            cfg.num_hidden_layers, nkv, hd, page_size=page_size,
            num_pages=num_pages,
            hbm_budget_bytes=(int(hbm_budget_mb * 2 ** 20)
                              if hbm_budget_mb is not None else None),
            dtype=self.cache_dtype, device=self.device)
        self.max_pages_per_seq = math.ceil(
            self.max_seq_len / self.cache.page_size)
        self.scheduler = Scheduler(self.cache, max_batch=max_batch,
                                   prefill_chunk=prefill_chunk,
                                   watermark_frac=watermark_frac)
        self.metrics = ServingMetrics()
        self.metrics.kv_page_bytes.set(self.cache.bytes_total
                                       / self.cache.num_pages)
        self.eos = eos_token_id
        self.window = getattr(cfg, "sliding_window", None) or None
        self._logits_dev = None       # last step's on-device [B,V] logits
        self._decode_bufs = {}        # per-bucket persistent host buffers
        self._seed_rng = np.random.default_rng()  # seed=None fallback
        self._requests: dict[int, Request] = {}
        self._finished: dict[int, Request] = {}
        # streaming callback: called synchronously with every event dict
        # the moment it is emitted (token/finish), from the thread that
        # runs step(). Must be cheap and non-blocking.
        self.on_event = on_event

    # -- public API --------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, *, deadline_s=None,
                    do_sample=False, temperature=1.0, top_k=0,
                    top_p=1.0, seed=None, n=1, logprobs=False,
                    request_id=None):
        """Queue a request; returns its req_id (n>1 returns the PARENT id
        — forked children surface as their own req_ids in events)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new_tokens"
                f"({max_new_tokens}) exceeds max_seq_len"
                f"({self.max_seq_len})")
        if n > 1 and not do_sample:
            raise ValueError("n>1 needs do_sample=True (greedy forks "
                             "would be identical streams)")
        if not 0.0 <= float(top_p) <= 1.0:
            raise ValueError(f"top_p={top_p} outside [0, 1]")
        now = self._now()
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      arrival=now,
                      deadline=(now + deadline_s
                                if deadline_s is not None else None),
                      do_sample=bool(do_sample),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=seed, n=int(n),
                      logprobs=bool(logprobs),
                      request_id=(str(request_id)
                                  if request_id is not None else None))
        req.device_seed = (int(seed) & 0x7FFFFFFF if seed is not None
                           else int(self._seed_rng.integers(
                               1, 2 ** 31 - 1)))
        self._requests[req.req_id] = req
        self.scheduler.add(req)
        return req.req_id

    def step(self):
        """One scheduler iteration. Returns a list of event dicts
        ({"type": "token"|"finish", "req_id", ...})."""
        with torch.inference_mode():
            return self._step_inner()

    def _step_inner(self):
        now = self._now()
        out = self.scheduler.schedule(now)
        events = []
        for r in out.expired:  # graceful: pages freed, partial output kept
            if self.cache.has_seq(r.seq_id):
                self.cache.free_seq(r.seq_id)
            self.metrics.deadline_evictions.inc()
            self._record_finish(r, events)
        if out.decode:
            self._plain_decode(out.decode, events)
        if out.prefill is not None:
            req, start, end = out.prefill
            # the decode batch may have preempted the prefilling request
            if req.state == RequestState.PREFILLING:
                self._prefill_chunk(req, start, end, events)
        if not out.decode and out.prefill is None and not out.expired \
                and self.scheduler.waiting \
                and not self.scheduler.live_requests():
            # idle engine + blocked admission head: loud, not a silent
            # spin — the request can never fit
            req = self.scheduler.waiting[0]
            need = self.scheduler.worst_case_need(req)
            if need + self.scheduler.watermark_pages \
                    > self.cache.available_pages:
                raise RuntimeError(
                    f"request {req.req_id} can never be admitted: "
                    f"needs {need} pages + "
                    f"{self.scheduler.watermark_pages} watermark > "
                    f"{self.cache.available_pages} available; grow "
                    "the cache budget or shrink the prompt")
        m = self.metrics
        m.queue_depth.record(self.scheduler.queue_depth())
        m.page_occupancy.record(self.cache.occupancy())
        m.queue_depth_gauge.set(self.scheduler.queue_depth())
        m.page_occupancy_gauge.set(self.cache.occupancy())
        m.running_gauge.set(len(self.scheduler.running))
        m.step_duration_s.record(self._now() - now)
        return events

    def run(self, max_steps=100000):
        """Step until every queued request finished; returns
        {req_id: {"tokens", "finish_reason", "preemptions"}}.

        On ANY failure the live requests' pages are returned to the free
        list (requests are requeued for recompute, generated tokens
        kept), so the engine stays reusable."""
        steps = 0
        try:
            while not self.scheduler.all_done():
                self.step()
                steps += 1
                if steps > max_steps:
                    raise RuntimeError(
                        f"serving loop did not drain in {max_steps} "
                        "steps (starvation or a stuck request)")
        except Exception:
            self.release_live()
            raise
        return self.results()

    def cancel(self, req_id):
        """Cancel a live request: frees its KV pages, purges it from
        every scheduler queue, and emits a ``finish`` event with reason
        ``"cancelled"`` (partial output is kept in results()). Returns
        True if the request was live, False for unknown/finished ids.
        Not safe to call concurrently with step()."""
        req = self._requests.get(req_id)
        if req is None or req.state == RequestState.FINISHED:
            return False
        if self.cache.has_seq(req.seq_id):
            self.cache.free_seq(req.seq_id)
        self.scheduler.remove(req)
        req.state = RequestState.FINISHED
        req.finish_reason = "cancelled"
        self.metrics.cancellations.inc()
        self._record_finish(req, [])
        return True

    def release_live(self):
        """Error path: free every live request's pages and requeue the
        requests (front of queue, recompute-style — generated tokens
        kept)."""
        for r in self.scheduler.live_requests():
            if self.cache.has_seq(r.seq_id):
                self.cache.free_seq(r.seq_id)
            self.scheduler.preempt(r)

    def results(self):
        return {rid: {"tokens": list(r.out_tokens),
                      "finish_reason": r.finish_reason,
                      "preemptions": r.preemptions}
                for rid, r in self._finished.items()}

    @property
    def last_logits(self):
        """The last step's float32 logits ``[B, V]`` on the device (row
        0 of a prefill step is its last prompt token's), or None. Not
        fetched on the hot path; for parity checks."""
        return self._logits_dev

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _now():
        return time.perf_counter()

    def _bucket(self, n):
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.scheduler.max_batch)

    def _alloc_with_preemption(self, req, n_tokens):
        """Allocate slots for req, preempting by page pressure (newest
        victim first) until it fits or no victim remains."""
        while True:
            try:
                slots, copies = self.cache.append_slots(req.seq_id,
                                                        n_tokens)
            except OutOfPages:
                victim = self.scheduler.pick_victim(exclude=(req,))
                if victim is None:
                    raise RuntimeError(
                        f"KV cache too small: request {req.req_id} "
                        f"cannot fit even alone "
                        f"(allocatable={self.cache.allocatable_pages} "
                        f"pages of {self.cache.page_size} tokens)")
                self._preempt(victim)
                continue
            if copies:
                self.cache.apply_copies(copies)
                self.metrics.cow_copies.inc(len(copies))
            return slots

    def _preempt(self, victim):
        if self.cache.has_seq(victim.seq_id):
            self.cache.free_seq(victim.seq_id)
        self.scheduler.preempt(victim)
        self.metrics.preemptions.inc()

    def _plain_decode(self, reqs, events):
        alloc = []
        for r in reqs:
            if r.state != RequestState.RUNNING:
                continue  # preempted by an earlier member's allocation
            slots = self._alloc_with_preemption(r, 1)
            alloc.append((r, int(slots[0])))
        active = [(r, s) for r, s in alloc
                  if r.state == RequestState.RUNNING]
        if not active:
            return
        b = self._build_decode_batch(active)
        toks, lps = self._run_step(
            b["ids"], b["positions"], b["pt"], b["cl"], b["slot_map"],
            b["last_idx"],
            (b["do_sample"], b["temperature"], b["top_k"], b["top_p"],
             b["seeds"], b["steps"]),
            any(r.do_sample for r, _ in active))
        self.metrics.decode_steps.inc()
        self.metrics.batch_size.record(len(active))
        for i, (r, _) in enumerate(active):
            self._emit_token(r, int(toks[i]), events,
                             logprob=float(lps[i]))

    def _build_decode_batch(self, active):
        """Stage the decode batch into PERSISTENT per-bucket host
        buffers. Padded lanes are explicitly reset each step: context 1,
        slots at the scratch page, neutral sampling params."""
        bb = self._bucket(len(active))
        b = self._decode_bufs.get(bb)
        if b is None:
            mp = self.max_pages_per_seq
            b = self._decode_bufs[bb] = {
                "ids": np.zeros((bb, 1), np.int32),
                "positions": np.zeros((bb, 1), np.int32),
                "pt": np.full((bb, mp), SCRATCH_PAGE, np.int32),
                "cl": np.ones(bb, np.int32),     # 1, not 0: keeps
                "slot_map": np.zeros((bb, 1), np.int32),  # softmax
                "last_idx": np.zeros(bb, np.int32),       # finite
                "do_sample": np.zeros(bb, np.bool_),
                "temperature": np.ones(bb, np.float32),
                "top_k": np.zeros(bb, np.int32),
                "top_p": np.ones(bb, np.float32),
                "seeds": np.zeros(bb, np.int32),
                "steps": np.zeros(bb, np.int32),
            }
        n = len(active)
        b["ids"][n:] = 0
        b["positions"][n:] = 0
        b["pt"][n:] = SCRATCH_PAGE
        b["cl"][n:] = 1
        b["slot_map"][n:] = 0
        b["do_sample"][n:] = False
        b["temperature"][n:] = 1.0
        b["top_k"][n:] = 0
        b["top_p"][n:] = 1.0
        b["seeds"][n:] = 0
        b["steps"][n:] = 0
        for i, (r, slot) in enumerate(active):
            hist_len = r.prompt.size + len(r.out_tokens)
            b["ids"][i, 0] = r.out_tokens[-1]
            b["positions"][i, 0] = hist_len - 1
            b["pt"][i] = self.cache.page_table(r.seq_id,
                                              self.max_pages_per_seq)
            b["cl"][i] = hist_len
            b["slot_map"][i, 0] = slot
            b["do_sample"][i] = r.do_sample
            b["temperature"][i] = r.temperature
            b["top_k"][i] = r.top_k
            b["top_p"][i] = r.top_p
            b["seeds"][i] = r.device_seed
            b["steps"][i] = len(r.out_tokens)
        return b

    def _prefill_chunk(self, req, start, end, events):
        if not self.cache.has_seq(req.seq_id):
            self.cache.alloc_seq(req.seq_id)
        chunk = req.token_history()[start:end]
        n = int(chunk.size)
        slots = self._alloc_with_preemption(req, n)
        c = self.scheduler.prefill_chunk
        ids = np.zeros((1, c), np.int32)
        ids[0, :n] = chunk
        positions = (start + np.arange(c, dtype=np.int32))[None, :]
        pt = self.cache.page_table(req.seq_id,
                                   self.max_pages_per_seq)[None, :]
        cl = np.asarray([start + n], np.int32)
        slot_map = np.zeros((1, c), np.int32)  # padding -> scratch slots
        slot_map[0, :n] = slots
        last_idx = np.asarray([n - 1], np.int32)
        samp = (np.asarray([req.do_sample], np.bool_),
                np.asarray([req.temperature], np.float32),
                np.asarray([req.top_k], np.int32),
                np.asarray([req.top_p], np.float32),
                np.asarray([req.device_seed], np.int32),
                np.asarray([len(req.out_tokens)], np.int32))
        toks, lps = self._run_step(ids, positions, pt, cl, slot_map,
                                   last_idx, samp, req.do_sample)
        self.metrics.prefill_chunks.inc()
        self.scheduler.prefill_advanced(req, end)
        if req.state != RequestState.RUNNING:
            return  # more chunks to go
        self._prefill_finish(req, events, int(toks[0]), float(lps[0]))

    def _prefill_finish(self, req, events, tok, lp):
        """Prefill-completion tail. Fork BEFORE emitting (children share
        the prefix pages; the parent may finish — and free — at once). A
        RECOMPUTE prefill (out_tokens non-empty after preemption) must
        NOT fork again: the children already exist."""
        children = []
        if req.n > 1 and not req.out_tokens:
            for i in range(1, req.n):
                children.append(self._fork(req, i))
        self._emit_token(req, tok, events, logprob=lp)
        if children:
            # one logits row, several seeds: each child samples its
            # first token with its own (seed, step) noise
            row = self._logits_dev[0]
            for child in children:
                ctok, clp = _sample_row(row, child)
                self._emit_token(child, ctok, events, logprob=clp)

    def _fork(self, parent, i):
        child = Request(prompt=parent.prompt,
                        max_new_tokens=parent.max_new_tokens,
                        arrival=parent.arrival, deadline=parent.deadline,
                        do_sample=parent.do_sample,
                        temperature=parent.temperature,
                        top_k=parent.top_k, top_p=parent.top_p,
                        seed=(parent.seed or 0) + i, n=1,
                        logprobs=parent.logprobs,
                        request_id=parent.request_id)
        child.device_seed = (parent.device_seed + i) & 0x7FFFFFFF
        child.parent_id = parent.req_id
        self.cache.fork(parent.seq_id, child.seq_id)
        self._requests[child.req_id] = child
        self.scheduler.register_fork(child)
        return child

    def _emit_token(self, req, tok, events, logprob=None):
        req.out_tokens.append(tok)
        now = self._now()
        if req.first_token_at is None:
            req.first_token_at = now
            self.metrics.ttft_s.record(now - req.arrival)
        else:
            self.metrics.inter_token_s.record(now - req.last_token_at)
        req.last_token_at = now
        self.metrics.tokens_generated.inc()
        ev = {"type": "token", "req_id": req.req_id, "token": tok}
        if req.logprobs and logprob is not None:
            ev["logprob"] = logprob
        self._event(ev, events)
        if self.eos is not None and tok == self.eos:
            self._finish(req, "stop", events)
        elif len(req.out_tokens) >= req.max_new_tokens:
            self._finish(req, "length", events)

    def _finish(self, req, reason, events):
        if self.cache.has_seq(req.seq_id):
            self.cache.free_seq(req.seq_id)
        self.scheduler.finish(req, reason)
        self._record_finish(req, events)

    def _record_finish(self, req, events):
        self.metrics.requests_finished.inc()
        self._finished[req.req_id] = req
        self._event({"type": "finish", "req_id": req.req_id,
                     "reason": req.finish_reason,
                     "n_tokens": len(req.out_tokens)}, events)

    def _event(self, ev, events):
        events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    def _run_step(self, ids, positions, pt, cl, slot_map, last_idx,
                  samp, sample_capable):
        """One forward + sampling on the device from host numpy arrays;
        returns the ``[B]`` token ids and logprobs as numpy."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tok, lp, logits = _paged_step_body(
            self.model, self._core, self.cache, self.window, put(ids),
            put(positions), put(pt), put(cl), put(slot_map),
            put(last_idx), tuple(put(a) for a in samp),
            bool(sample_capable))
        self._logits_dev = logits
        self.metrics.step_dispatches.inc()
        toks = tok.cpu().numpy()
        lps = lp.cpu().numpy()
        self.metrics.fetch_bytes.inc(toks.nbytes + lps.nbytes)
        self.metrics.step_fetches.inc()
        return toks, lps


def _sample_row(logits_row, req):
    """Sample ONE token from a logits row with the step's sampler — fork
    children at prefill completion (one row, several seeds)."""
    dev = logits_row.device
    tok, lp = fused_sample(
        logits_row[None],
        torch.tensor([True], device=dev),
        torch.tensor([req.temperature], dtype=torch.float32, device=dev),
        torch.tensor([req.top_k], dtype=torch.int32, device=dev),
        torch.tensor([req.top_p], dtype=torch.float32, device=dev),
        torch.tensor([req.device_seed], dtype=torch.int32, device=dev),
        torch.tensor([len(req.out_tokens)], dtype=torch.int32,
                     device=dev))
    return int(tok[0]), float(lp[0])


def _paged_forward(core, cache, window, ids, positions, pt, cl,
                   slot_map):
    """The transformer trunk over the paged cache: embed, attend (the
    step's K/V written into the page pool first), final norm. ids,
    positions and slot_map are ``[B, S]``, pt ``[B, P]``, cl ``[B]``,
    all int32 on the cache's device. Returns the hidden states
    ``[B, S, H]``."""
    b, s = ids.shape
    slots = slot_map.reshape(-1).long()
    x = core.embed_tokens(ids)
    for i, layer in enumerate(core.layers):
        at = layer.self_attn
        nh, nkv, hd = at.num_heads, at.num_kv_heads, at.head_dim
        y = layer.input_layernorm(x)
        q = at.q_proj(y).reshape(b, s, nh, hd)
        k = at.k_proj(y).reshape(b, s, nkv, hd)
        v = at.v_proj(y).reshape(b, s, nkv, hd)
        q, k = fused_rotary_position_embedding(
            q, k, position_ids=positions,
            rotary_emb_base=at.cfg.rope_theta)
        # scatter, then attend: both on the current stream, in order
        cache.write(i, slots, k.reshape(b * s, nkv, hd),
                    v.reshape(b * s, nkv, hd))
        kp, vp = cache.operands(i)
        out = paged_attention(q, kp, vp, pt, cl, positions[:, 0],
                              scale=1.0 / (hd ** 0.5), window=window)
        h = x + at.o_proj(out.reshape(b, s, nh * hd))
        x = h + layer.mlp(layer.post_attention_layernorm(h))
    return core.norm(x)


def _paged_step_body(model, core, cache, window, ids, positions, pt, cl,
                     slot_map, last_idx, samp, sample_capable):
    """Forward, the last real token's logits per lane, fused sampling.
    Returns ``(tokens [B], logprobs [B], logits [B, V] float32)``."""
    x = _paged_forward(core, cache, window, ids, positions, pt, cl,
                       slot_map)
    b = ids.shape[0]
    h_last = x[torch.arange(b, device=x.device), last_idx.long()]
    logits = model.lm_head(h_last).float()
    tokens, logprobs = fused_sample(logits, *samp,
                                    sample_capable=sample_capable)
    return tokens, logprobs, logits
