"""Continuous-batching inference engine over the paged KV cache
(counterpart: ``paddle_tpu/serving/engine.py::ServingEngine``, its
bucketed path and its unified ragged step).

- ``step()`` runs one scheduler iteration: a decode batch of every
  running request plus at most one prefill chunk; ``run()`` loops until
  every request finished.
- The bucketed step (the default): decode runs at batch buckets (powers
  of two up to ``max_batch``, S=1), prefill at (B=1,
  S=``prefill_chunk``), each its own dispatch. Padded lanes are real
  lanes pointed at the cache's SCRATCH page with context 1, so their
  attention rows stay finite; the host discards them.
- The ragged step (``ragged=True``): the decode lanes and the prefill
  chunk ride ONE token-packed dispatch over ``L = max_batch + 1`` lanes
  (K5's token-packed entry), at one of two token capacities,
  ``max_batch`` (all-decode steps) or ``max_batch + prefill_chunk``,
  so it has at most two program classes. Every packed token is sampled
  with its own ``(seed, step)``.
- Every forward goes through :func:`_paged_forward`: K5's plan once,
  then per layer RMSNorm, q/k/v, RoPE from the absolute positions, the
  step's K/V written into the page pool in place, paged attention (the
  hand-written CUDA kernels on the card, the plain version on the CPU),
  o_proj and the SwiGLU MLP; then the head and fused sampling
  (:mod:`.sampling`). The host fetches ``[B]`` (or ``[T]``) token ids
  and logprobs once a dispatch.
- On the card each static shape class (a decode bucket or the prefill
  chunk, each greedy-only or sample-capable; a ragged token capacity)
  is one CUDA graph, captured at its first use from padding inputs and
  replayed every step after the step's host arrays are copied into its
  static inputs: the counterpart of the JAX package's ``jit`` programs.
  On the CPU the step runs eagerly. All of an engine's graphs share one
  memory pool, so a step's outputs are valid until the next step.
- Preemption by page pressure frees the newest live request and requeues
  it for a recompute prefill that keeps its generated tokens.

Speculative decoding (``draft_model=``, ``speculative_k=`` k, default 4;
a request opts out with ``add_request(speculative=False)``): a decode
round of the speculative lanes is

- the draft's k+1 single-token steps at the lane bucket, one dispatch
  (one CUDA graph on the card): each step feeds the token the previous
  one sampled, on the device, and samples with the counter key the
  target will use at that position; the proposals land in a persistent
  device buffer, with no host read;
- ONE target verify step over ``[B, k+1]`` (its own step class), whose
  input ids take the proposals from that buffer on the device and whose
  sampling draws position j of lane i at token index ``steps0[i] + j``
  (:func:`.sampling.fused_sample_multi`), the key the plain engine uses
  for that token;
- one host fetch of the ``[B, k+1]`` tokens, logprobs and proposals;
  a proposal is accepted iff it equals the target's sample, the first
  mismatch emits the target's token (the correction), a full accept
  emits the bonus token, and the rejected slots of both caches roll
  back by accounting (``PagedKVCache.free_tail``).

Every emitted token is the plain engine's, greedy and sampled alike,
whatever the draft. The draft keeps its own page pool (no prefix
cache), disposable: freed on finish, cancel and preemption, evicted
under pressure, and rebuilt by a catch-up prefill of the draft (its own
chunked step class) at a lane's next round. Lanes the draft cannot
serve drop to plain decode (``spec_fallbacks``). In the ragged step the
speculative lanes ride the token-packed dispatch with q = k+1 tokens a
lane (mixed capacity ``max_batch * (k+1) + prefill_chunk``); the
draft's proposal stays its own dispatch.

Arguments of the JAX engine outside this slice (the prefix cache,
weight quantization, chaos, the host KV tier, draft distillation,
tensor parallelism) raise ``NotImplementedError``. The ragged step is
chosen by ``ragged=`` alone: the JAX package's
``PADDLE_TPU_SERVING_RAGGED`` is not read.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..nn.functional import fused_rotary_position_embedding
from . import attention as _attention
from .attention import paged_plan, planned_attention, ragged_plan
from .kv_cache import SCRATCH_PAGE, OutOfPages, PagedKVCache
from .metrics import ServingMetrics
from .sampling import fused_sample, fused_sample_multi
from .scheduler import Request, RequestState, Scheduler

__all__ = ["ServingEngine"]

_CACHE_DTYPES = {"float32": "float32", "bfloat16": "bfloat16",
                 "int8": "int8", torch.float32: "float32",
                 torch.bfloat16: "bfloat16", torch.int8: "int8"}


# every input of a step program: its numpy dtype and the value a lane or
# token that carries no request holds (context 1, the scratch page,
# neutral sampling: its attention rows stay finite)
_INPUTS = {"ids": (np.int32, 0), "positions": (np.int32, 0),
           "slot_map": (np.int32, 0), "pt": (np.int32, SCRATCH_PAGE),
           "cl": (np.int32, 1), "last_idx": (np.int32, 0),
           "ql": (np.int32, 0), "qoff": (np.int32, 0),
           "src": (np.int32, -1),
           "do_sample": (np.bool_, False), "temperature": (np.float32, 1.0),
           "top_k": (np.int32, 0), "top_p": (np.float32, 1.0),
           "seeds": (np.int32, 0), "steps": (np.int32, 0)}
_SAMPLING = ("do_sample", "temperature", "top_k", "top_p", "seeds", "steps")


class _StepClass:
    """One static shape class of the step program (``key``, its static
    shape signature): its persistent host input buffers (``host``, numpy
    views; pinned memory on the card, so their copies to the device are
    asynchronous) and, on the card, its CUDA graph with static device
    inputs."""

    def __init__(self, key, shapes, pinned):
        self.key = key
        self._host = {}
        for name, shape in shapes.items():
            dt, pad = _INPUTS[name]
            t = torch.from_numpy(np.full(shape, pad, dt))
            self._host[name] = t.pin_memory() if pinned else t
        self.host = {name: t.numpy() for name, t in self._host.items()}
        self.graph = None
        self.dispatches = 0   # eager runs or graph replays
        self._copied = None   # the last replay's input copies, on the card

    def settle(self):
        """Wait until the last replay's asynchronous input copies have
        read the host buffers, so they may be staged again (a dispatch
        followed by no fetch, such as the draft's catch-up, leaves them
        in flight)."""
        if self._copied is not None:
            self._copied.synchronize()

    def pad(self, start=0):
        """Reset every lane (first axis) from ``start`` on to padding."""
        for name, a in self.host.items():
            a[start:] = _INPUTS[name][1]

    def run_eager(self, body):
        return body(self._host)

    def capture(self, body, device, pool):
        """Capture ``body`` (inputs dict -> outputs) as a CUDA graph.
        Warm-up (on a side stream, as CUDA graphs need) and capture run
        on padding inputs, which touch only the scratch page, and count
        no kernel launch: ``launches`` is the capture's change of K5's
        counters, added back at every replay."""
        saved = dict(_attention.stats)
        self._dev = {name: torch.full(t.shape, _INPUTS[name][1],
                                      dtype=t.dtype, device=device)
                     for name, t in self._host.items()}
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body(self._dev)
        cur.wait_stream(side)
        before = dict(_attention.stats)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self._out = body(self._dev)
        self.launches = {k: _attention.stats[k] - before[k] for k in before}
        _attention.stats.update(saved)
        self.graph = graph

    def replay(self):
        """Copy the host buffers into the static inputs and replay."""
        for name, dst in self._dev.items():
            dst.copy_(self._host[name], non_blocking=True)
        if self._copied is None:
            self._copied = torch.cuda.Event()
        self._copied.record()
        self.graph.replay()
        for k, n in self.launches.items():
            _attention.stats[k] += n
        return self._out


def _refuse_unported(**flags):
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"ServingEngine({name}=...) is not ported to "
                "paddle_tpu_torch yet")


class ServingEngine:
    @staticmethod
    def _validate_causal_lm(model, what="model"):
        cfg = getattr(model, "cfg", None)
        core = getattr(model, "llama", model)
        for attr in ("embed_tokens", "layers", "norm"):
            if not hasattr(core, attr):
                raise TypeError(
                    "ServingEngine needs a LLaMA-family causal LM "
                    "(model.llama or a core module with embed_tokens/"
                    f"layers/norm); {what} {type(model).__name__} "
                    f"lacks {attr!r}")
        if not hasattr(model, "lm_head"):
            raise TypeError(f"{what} must expose lm_head")
        if cfg is None:
            raise TypeError(f"{what} must carry a .cfg")
        return cfg, core

    def __init__(self, model, *, page_size=16, num_pages=None,
                 hbm_budget_mb=None, max_batch=8, prefill_chunk=32,
                 max_seq_len=None, eos_token_id=None, watermark_frac=0.05,
                 cache_dtype=None, device=None, on_event=None,
                 prefix_cache=None, draft_model=None, speculative_k=None,
                 weight_quant=None, chaos=None, host_pool=None,
                 distill=None, ragged=None, mesh=None, tp_degree=None):
        _refuse_unported(
            prefix_cache=prefix_cache, weight_quant=weight_quant,
            chaos=chaos is not None, host_pool=host_pool is not None,
            distill=distill is not None, mesh=mesh is not None,
            tp_degree=(tp_degree or 1) > 1)
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
        self._init_draft(draft_model, speculative_k, cfg, page_size,
                         max_batch)
        self.scheduler = Scheduler(self.cache, max_batch=max_batch,
                                   prefill_chunk=prefill_chunk,
                                   watermark_frac=watermark_frac,
                                   spec_reserve_tokens=self.spec_k)
        self.metrics = ServingMetrics()
        self.metrics.kv_page_bytes.set(self.cache.bytes_total
                                       / self.cache.num_pages)
        self.eos = eos_token_id
        self.window = getattr(cfg, "sliding_window", None) or None
        # the unified ragged step: L lanes always (max_batch decode or
        # verify + 1 prefill); all-decode steps pack into max_batch
        # tokens, a step with a prefill chunk or verify lanes pads to the
        # mixed capacity: <= 2 classes
        self.ragged = bool(ragged)
        self._ragged_lanes = max_batch + 1
        self._ragged_tok_small = max_batch
        self._ragged_tok_mixed = (max_batch * (self.spec_k + 1)
                                  + prefill_chunk)
        # static shape classes (host buffers, CUDA graphs) by program key
        self._classes: dict[tuple, _StepClass] = {}
        self._program_classes = set()  # keys dispatched
        self._graphs = self.device.type == "cuda"
        self._graph_pool = (torch.cuda.graph_pool_handle() if self._graphs
                            else None)
        self._logits_dev = None       # last dispatch's [N, V] logits
        self._rows = {}               # req_id -> its row of them
        self._seed_rng = np.random.default_rng()  # seed=None fallback
        self._requests: dict[int, Request] = {}
        self._finished: dict[int, Request] = {}
        # streaming callback: called synchronously with every event dict
        # the moment it is emitted (token/finish), from the thread that
        # runs step(). Must be cheap and non-blocking.
        self.on_event = on_event

    def _init_draft(self, draft, speculative_k, cfg, page_size, max_batch):
        """The draft model's checks, its page pool (the target's page
        geometry and count, the draft's own layers and heads, the same
        cache dtype; no prefix cache: draft K/V is disposable) and the
        device buffer its proposals land in."""
        self.draft = draft
        if draft is None:
            if speculative_k:
                raise ValueError("speculative_k needs a draft_model")
            self.spec_k = 0
            self._draft_cache = self._draft_core = self._draft_window = None
            self._props = None
            return
        dcfg, dcore = self._validate_causal_lm(draft, what="draft_model")
        if getattr(dcfg, "vocab_size", None) != cfg.vocab_size:
            raise ValueError(
                "draft and target models must share a vocab "
                f"({dcfg.vocab_size} vs {cfg.vocab_size})")
        dmax = getattr(dcfg, "max_position_embeddings", None)
        if dmax is not None and self.max_seq_len > dmax:
            raise ValueError(f"draft max_position_embeddings({dmax}) < "
                             f"max_seq_len({self.max_seq_len})")
        k = 4 if speculative_k is None else int(speculative_k)
        if not 1 <= k <= 16:
            raise ValueError(f"speculative_k must be in [1, 16], got {k}")
        draft_dev = next(draft.parameters()).device
        if draft_dev != self.device:
            raise ValueError(f"the draft lies on {draft_dev}, the engine "
                             f"runs on {self.device}")
        self.spec_k = k
        self._draft_core = dcore
        self._draft_window = getattr(dcfg, "sliding_window", None) or None
        dnh = dcfg.num_attention_heads
        self._draft_cache = PagedKVCache(
            dcfg.num_hidden_layers,
            getattr(dcfg, "num_key_value_heads", None) or dnh,
            dcfg.hidden_size // dnh, page_size=page_size,
            num_pages=self.cache.num_pages, dtype=self.cache_dtype,
            device=self.device)
        # row i: the proposals of the round's lane i (the draft's k+1
        # samples), written and read on the device only
        self._props = torch.zeros(max_batch, k + 1, dtype=torch.int32,
                                  device=self.device)

    # -- public API --------------------------------------------------------
    def add_request(self, prompt, max_new_tokens=32, *, deadline_s=None,
                    do_sample=False, temperature=1.0, top_k=0,
                    top_p=1.0, seed=None, n=1, logprobs=False,
                    request_id=None, speculative=None):
        """Queue a request; returns its req_id (n>1 returns the PARENT id
        — forked children surface as their own req_ids in events).
        ``speculative=False`` keeps the request out of the draft-verify
        rounds of a speculative engine."""
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
                                  if request_id is not None else None),
                      speculative=(None if speculative is None
                                   else bool(speculative)))
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
            self._free_draft_seq(r.seq_id)
            self.metrics.deadline_evictions.inc()
            self._record_finish(r, events)
        if self.ragged:
            self._ragged_step(out, events)
        else:
            if out.decode:
                self._decode_batch(out.decode, events)
            if out.prefill is not None:
                req, start, end = out.prefill
                # the decode batch may have preempted the prefilling
                # request
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
        if m.spec_draft_tokens.value:
            m.spec_acceptance_rate.set(m.spec_accepted_tokens.value
                                       / m.spec_draft_tokens.value)
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
        self._free_draft_seq(req.seq_id)
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
            self._free_draft_seq(r.seq_id)
            self.scheduler.preempt(r)

    def results(self):
        return {rid: {"tokens": list(r.out_tokens),
                      "finish_reason": r.finish_reason,
                      "preemptions": r.preemptions}
                for rid, r in self._finished.items()}

    @property
    def last_logits(self):
        """The last dispatch's float32 logits ``[N, V]`` on the device
        (N lanes of a bucketed step, row 0 of a prefill chunk its last
        token's; the T packed tokens of a ragged step), or None. Not
        fetched on the hot path; for parity checks. On the card this is
        a graph's static output buffer: it is valid until the next step
        and must be cloned to be kept."""
        return self._logits_dev

    def logits_row(self, req_id):
        """The row of :attr:`last_logits` that ``req_id``'s token of the
        last dispatch was drawn from (valid as :attr:`last_logits` is)."""
        return self._logits_dev[self._rows[req_id]]

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
        self._free_draft_seq(victim.seq_id)
        self.scheduler.preempt(victim)
        self.metrics.preemptions.inc()

    def _free_draft_seq(self, seq_id):
        """Drop a lane's draft-cache state (finish, cancel, preemption,
        expiry). Draft K/V is disposable: the lane's next speculative
        round rebuilds it by a catch-up prefill; no output token depends
        on it."""
        if self._draft_cache is not None \
                and self._draft_cache.has_seq(seq_id):
            self._draft_cache.free_seq(seq_id)

    def _spec_enabled(self, req):
        """Does this lane ride the draft-verify rounds? The engine's
        draft gates it; a request opts out with ``speculative=False``."""
        return self.spec_k > 0 and req.speculative is not False

    def _decode_batch(self, reqs, events):
        spec, plain = [], []
        for r in reqs:
            (spec if self._spec_enabled(r) else plain).append(r)
        if spec:
            # lanes the draft cannot serve this round join the plain
            # batch (the same tokens, one a step)
            self._spec_round(spec, plain, events)
        if plain:
            self._plain_decode(plain, events)

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
        sample_capable = any(r.do_sample for r, _ in active)
        bb = self._bucket(len(active))
        sc = self._step_class(bb, 1, sample_capable)
        b = sc.host
        sc.pad(len(active))
        for i, (r, slot) in enumerate(active):
            hist_len = r.prompt.size + len(r.out_tokens)
            b["ids"][i, 0] = r.out_tokens[-1]
            b["positions"][i, 0] = hist_len - 1
            b["pt"][i] = self.cache.page_table(r.seq_id,
                                              self.max_pages_per_seq)
            b["cl"][i] = hist_len
            b["slot_map"][i, 0] = slot
            self._stage_sampling(b, i, r)
        toks, lps = _tokens(self._run(sc, self._step_body(sample_capable),
                                      {r.req_id: i for i, (r, _) in
                                       enumerate(active)}))
        self.metrics.decode_steps.inc()
        self.metrics.batch_size.record(len(active))
        for i, (r, _) in enumerate(active):
            self._emit_token(r, int(toks[i]), events,
                             logprob=float(lps[i]))

    def _step_class(self, bsz, seq, sample_capable, kind="step"):
        """The bucketed step's :class:`_StepClass` of shape ``[bsz,
        seq]`` (``kind="verify"``: the speculative verify step, whose
        ids beyond the first of a lane come from the draft's proposals
        on the device)."""
        mp = self.max_pages_per_seq
        return self._class(
            (kind, (bsz, seq), bool(sample_capable)),
            {"ids": (bsz, 1 if kind == "verify" else seq),
             "positions": (bsz, seq), "slot_map": (bsz, seq),
             "pt": (bsz, mp), "cl": (bsz,), "last_idx": (bsz,),
             **{n: (bsz,) for n in _SAMPLING}})

    def _class(self, key, shapes):
        """The class of ``key``, its host buffers free to be staged."""
        sc = self._classes.get(key)
        if sc is None:
            sc = self._classes[key] = _StepClass(key, shapes, self._graphs)
        sc.settle()
        return sc

    @staticmethod
    def _stage_sampling(b, i, req, n=None):
        """Lane or token ``i``'s sampling parameters: the request's, with
        its token index as the noise counter; with ``n``, the ``n``
        tokens from ``i`` on, at token indices counting on from it (a
        verify lane's positions)."""
        steps = len(req.out_tokens)
        if n is not None:
            i = slice(i, i + n)
            steps = steps + np.arange(n, dtype=np.int32)
        b["do_sample"][i] = req.do_sample
        b["temperature"][i] = req.temperature
        b["top_k"][i] = req.top_k
        b["top_p"][i] = req.top_p
        b["seeds"][i] = req.device_seed
        b["steps"][i] = steps

    # -- speculative decoding ----------------------------------------------
    def _draft_alloc(self, seq_id, n, protect=()):
        """Allocate ``n`` draft-cache slots, evicting OTHER lanes' draft
        state under pressure (their next round pays a catch-up; no
        output token changes). Lanes in ``protect`` are mid-round and
        never evicted. None when the draft pool cannot serve."""
        dc = self._draft_cache
        while True:
            try:
                slots, copies = dc.append_slots(seq_id, n)
            except OutOfPages:
                victims = [s for s in dc.live_seqs()
                           if s != seq_id and s not in protect]
                if not victims:
                    return None
                dc.free_seq(victims[0])
                continue
            if copies:  # pragma: no cover - draft sequences never fork
                raise AssertionError("draft cache saw a copy-on-write")
            return slots

    def _draft_ready(self, req, protect=()):
        """Bring the draft cache up to date for ``req``: every history
        token but the last must have its draft K/V written. The catch-up
        runs the draft's trunk over chunks of ``prefill_chunk`` tokens
        (a lane's first round after prefill, preemption or a fork pays
        it once). False: the lane falls back to plain decode this
        round."""
        dc = self._draft_cache
        sid = req.seq_id
        target = req.prompt.size + len(req.out_tokens) - 1
        if not dc.has_seq(sid):
            dc.alloc_seq(sid)
        have = dc.seq_len(sid)
        if have > target:  # pragma: no cover - defensive resync
            dc.free_tail(sid, target)
            have = target
        hist = req.token_history()
        c = self.scheduler.prefill_chunk
        mp = self.max_pages_per_seq
        while have < target:
            n = min(c, target - have)
            slots = self._draft_alloc(sid, n, protect)
            if slots is None:
                return False
            sc = self._class(("draft_step", (1, c)),
                             {"ids": (1, c), "positions": (1, c),
                              "slot_map": (1, c), "pt": (1, mp),
                              "cl": (1,)})
            b = sc.host
            sc.pad()
            b["ids"][0, :n] = hist[have:have + n]
            b["positions"][0] = have + np.arange(c, dtype=np.int32)
            b["pt"][0] = dc.page_table(sid, mp)
            b["cl"][0] = have + n
            b["slot_map"][0, :n] = slots
            self._dispatch(sc, self._draft_trunk)
            have += n
        return True

    def _spec_alloc(self, lanes, plain):
        """Ready the draft for each speculative lane and allocate the
        round's slots in both caches: ``min(k+1, tokens left)`` a lane
        (slots past the request's last token are never fed, so the round
        stays inside the pages admission reserved). Lanes the draft
        cannot serve are appended to ``plain``. Returns ``[(req, hist0,
        n_slots, target slots, draft slots)]``; a later allocation may
        still preempt a listed lane."""
        k1 = self.spec_k + 1
        protect = {r.seq_id for r in lanes}
        staged = []
        for r in lanes:
            if r.state != RequestState.RUNNING:
                continue  # preempted by an earlier member's catch-up
            if not self._draft_ready(r, protect):
                self.metrics.spec_fallbacks.inc()
                plain.append(r)
                continue
            staged.append(r)
        alloc = []
        for r in staged:
            if r.state != RequestState.RUNNING:
                continue  # preempted by an earlier member's allocation
            hist0 = r.prompt.size + len(r.out_tokens)
            n_slots = min(k1, r.max_new_tokens - len(r.out_tokens))
            tslots = self._alloc_with_preemption(r, n_slots)
            dslots = self._draft_alloc(r.seq_id, n_slots, protect)
            if dslots is None:
                self.cache.free_tail(r.seq_id, hist0 - 1)
                self.metrics.spec_fallbacks.inc()
                plain.append(r)
                continue
            alloc.append((r, hist0, n_slots, tslots, dslots))
        return alloc

    def _stage_draft_propose(self, active):
        """Stage the draft's inputs for the round's lanes (``active``
        rows as :meth:`_spec_alloc` gives them) and dispatch its k+1
        steps at the lane bucket. The proposals land in ``self._props``
        on the device; the host reads them with the verify's tokens."""
        k1 = self.spec_k + 1
        bb = self._bucket(len(active))
        mp = self.max_pages_per_seq
        sample_capable = any(r.do_sample for r, *_ in active)
        sc = self._class(("draft_propose", (bb, k1), sample_capable),
                         {"ids": (bb, 1), "positions": (bb, 1),
                          "slot_map": (bb, k1), "pt": (bb, mp),
                          "cl": (bb,), **{n: (bb,) for n in _SAMPLING}})
        b = sc.host
        sc.pad(len(active))
        for i, (r, hist0, n_slots, _, dslots) in enumerate(active):
            b["ids"][i, 0] = r.out_tokens[-1]
            b["positions"][i, 0] = hist0 - 1
            b["pt"][i] = self._draft_cache.page_table(r.seq_id, mp)
            b["cl"][i] = hist0
            b["slot_map"][i] = 0
            b["slot_map"][i, :n_slots] = dslots
            self._stage_sampling(b, i, r)
        self._dispatch(sc, self._propose_body(sample_capable))
        return bb, sample_capable

    def _spec_round(self, lanes, plain, events):
        """One draft-propose / target-verify round over the speculative
        lanes: the draft's k+1 steps (one dispatch), ONE ``[B, k+1]``
        verify step, one host fetch, acceptance by equality with the
        target's own samples, rollback of the rejected slots in both
        caches. Lanes the draft cannot serve are appended to ``plain``
        (the same tokens, one a step)."""
        k = self.spec_k
        k1 = k + 1
        alloc = self._spec_alloc(lanes, plain)
        active = [a for a in alloc if a[0].state == RequestState.RUNNING]
        if not active:
            return
        bb, sample_capable = self._stage_draft_propose(active)
        mp = self.max_pages_per_seq
        sc = self._step_class(bb, k1, sample_capable, kind="verify")
        b = sc.host
        sc.pad(len(active))
        for i, (r, hist0, n_slots, tslots, _) in enumerate(active):
            b["ids"][i, 0] = r.out_tokens[-1]
            b["positions"][i] = hist0 - 1 + np.arange(k1, dtype=np.int32)
            b["pt"][i] = self.cache.page_table(r.seq_id, mp)
            b["cl"][i] = hist0 - 1 + n_slots
            b["slot_map"][i] = 0      # past the request's end: scratch
            b["slot_map"][i, :n_slots] = tslots
            self._stage_sampling(b, i, r)
        host = self._run(sc, self._verify_body(sample_capable), {})
        toks, lps = _tokens(host)
        m = self.metrics
        m.spec_rounds.inc()
        m.decode_steps.inc()
        m.batch_size.record(len(active))
        # only proposals that could be accepted count (a lane near its
        # max_new_tokens uses at most its remaining budget): the rate
        # measures the draft, not the budget clip
        m.spec_draft_tokens.inc(sum(min(k, a[2]) for a in active))
        accepted = 0
        for i, (r, hist0, *_) in enumerate(active):
            accepted += self._accept(r, hist0, toks[i], lps[i], host[2][i],
                                     events, [(i, j) for j in range(k1)])
        m.spec_accepted_tokens.inc(accepted)

    def _accept(self, r, hist0, toks, lps, props, events, rows):
        """Emit a verify lane's tokens up to and including the first that
        is not its draft's proposal (the correction; after k accepted
        proposals, the bonus token), then roll both caches back to the
        emitted history. ``rows[j]``: position j's row of the verify's
        logits. Returns the proposals accepted."""
        k = self.spec_k
        emitted = accepted = 0
        for j in range(len(rows)):
            v = int(toks[j])
            is_draft = j < k and v == int(props[j])
            self._rows[r.req_id] = rows[j]
            self._emit_token(r, v, events, logprob=float(lps[j]))
            emitted += 1
            accepted += is_draft
            if r.state == RequestState.FINISHED or not is_draft:
                break
        if r.state != RequestState.FINISHED:
            # accounting only: the rejected slots' K/V stays masked by
            # the context length until the lane grows over it
            new_len = hist0 + emitted - 1
            self.cache.free_tail(r.seq_id, new_len)
            self._draft_cache.free_tail(r.seq_id, new_len)
        return accepted

    def _prefill_chunk(self, req, start, end, events):
        if not self.cache.has_seq(req.seq_id):
            self.cache.alloc_seq(req.seq_id)
        chunk = req.token_history()[start:end]
        n = int(chunk.size)
        slots = self._alloc_with_preemption(req, n)
        c = self.scheduler.prefill_chunk
        sc = self._step_class(1, c, req.do_sample)
        b = sc.host
        sc.pad()  # padding tokens write the scratch slot
        b["ids"][0, :n] = chunk
        b["positions"][0] = start + np.arange(c, dtype=np.int32)
        b["pt"][0] = self.cache.page_table(req.seq_id,
                                           self.max_pages_per_seq)
        b["cl"][0] = start + n
        b["slot_map"][0, :n] = slots
        b["last_idx"][0] = n - 1
        self._stage_sampling(b, 0, req)
        toks, lps = _tokens(self._run(sc, self._step_body(req.do_sample),
                                      {req.req_id: 0}))
        self.metrics.prefill_chunks.inc()
        self.scheduler.prefill_advanced(req, end)
        if req.state != RequestState.RUNNING:
            return  # more chunks to go
        self._prefill_finish(req, events, int(toks[0]), float(lps[0]), 0)

    def _prefill_finish(self, req, events, tok, lp, row):
        """Prefill-completion tail (``row`` is the request's last-token
        row of the dispatch's logits). Fork BEFORE emitting (children
        share the prefix pages; the parent may finish — and free — at
        once). A RECOMPUTE prefill (out_tokens non-empty after
        preemption) must NOT fork again: the children already exist."""
        children = []
        if req.n > 1 and not req.out_tokens:
            for i in range(1, req.n):
                children.append(self._fork(req, i))
        self._emit_token(req, tok, events, logprob=lp)
        if children:
            # one logits row, several seeds: each child samples its
            # first token with its own (seed, step) noise, before any
            # other dispatch reuses the row's buffer
            logits = self._logits_dev[row]
            for child in children:
                self._rows[child.req_id] = row
                ctok, clp = _sample_row(logits, child)
                self._emit_token(child, ctok, events, logprob=clp)

    # -- the unified ragged step -------------------------------------------
    def _ragged_step(self, out, events):
        """ONE token-packed dispatch for the whole step: the speculative
        verify lanes (q = k+1), the plain decode lanes (q = 1) and the
        prefill chunk ride a single program over K5's token-packed lane
        layout — one dispatch and one host fetch a step (with verify
        lanes, the draft's proposal is one more dispatch before it, and
        catch-up prefills of the draft ride ahead of that, as in the
        bucketed round). Each token's noise is keyed on its request's
        ``(seed, token index)``, as in the bucketed step, so the streams
        are the bucketed step's token for token even where preemption
        order differs."""
        k = self.spec_k
        mp = self.max_pages_per_seq
        spec, plain = [], []
        for r in out.decode:
            (spec if self._spec_enabled(r) else plain).append(r)
        # 1. draft catch-up and the verify lanes' slots (lanes the draft
        # cannot serve join the plain ones)
        spec_alloc = self._spec_alloc(spec, plain) if spec else []
        # 2. plain decode allocation
        plain_alloc = []
        for r in plain:
            if r.state != RequestState.RUNNING:
                continue  # preempted by an earlier member's allocation
            slots = self._alloc_with_preemption(r, 1)
            plain_alloc.append((r, int(slots[0])))
        # 3. prefill-chunk allocation (it may preempt a staged decode
        # lane; the re-filter below drops that lane — its pages are
        # gone, and the recompute replays an identical stream)
        pf = None
        if out.prefill is not None:
            req, start, end = out.prefill
            if req.state == RequestState.PREFILLING:
                if not self.cache.has_seq(req.seq_id):
                    self.cache.alloc_seq(req.seq_id)
                chunk = req.token_history()[start:end]
                n = int(chunk.size)
                pslots = self._alloc_with_preemption(req, n)
                if req.state == RequestState.PREFILLING:
                    pf = (req, start, end, chunk, n, pslots)
        # 4. re-filter: every lane must still be live AFTER all
        # allocations — a preempted lane's page-table row is dead
        spec_active = [a for a in spec_alloc
                       if a[0].state == RequestState.RUNNING]
        plain_active = [(r, s) for r, s in plain_alloc
                        if r.state == RequestState.RUNNING]
        if not spec_active and not plain_active and pf is None:
            return
        # 5. the draft's proposals for the verify lanes (on the device)
        if spec_active:
            self._stage_draft_propose(spec_active)
        # 6. pack the token batch at one of the two capacities, into
        # that capacity's persistent buffers, reset in full: the lanes'
        # composition changes every step
        n_tok = (sum(a[2] for a in spec_active) + len(plain_active)
                 + (pf[4] if pf is not None else 0))
        tcap = (self._ragged_tok_small if n_tok <= self._ragged_tok_small
                else self._ragged_tok_mixed)
        nl = self._ragged_lanes
        shapes = {"ids": (1, tcap), "positions": (1, tcap),
                  "slot_map": (1, tcap), "pt": (nl, mp), "cl": (nl,),
                  "ql": (nl,), "qoff": (nl,),
                  **{n: (tcap,) for n in _SAMPLING}}
        if k:
            shapes["src"] = (1, tcap)   # a token's proposal, or -1
        sc = self._class(("ragged", tcap), shapes)
        b = sc.host
        sc.pad()
        rows = {}
        lane = off = 0
        emit_spec = []                   # (req, hist0, token offset)
        for i, (r, hist0, n_slots, tslots, _) in enumerate(spec_active):
            b["pt"][lane] = self.cache.page_table(r.seq_id, mp)
            b["cl"][lane] = hist0 - 1 + n_slots
            b["ql"][lane] = n_slots
            b["qoff"][lane] = hist0 - 1
            b["ids"][0, off] = r.out_tokens[-1]
            # the lane's later tokens are the draft's proposals
            b["src"][0, off + 1:off + n_slots] = i * (k + 1) + np.arange(
                n_slots - 1, dtype=np.int32)
            b["positions"][0, off:off + n_slots] = hist0 - 1 + np.arange(
                n_slots, dtype=np.int32)
            b["slot_map"][0, off:off + n_slots] = tslots
            self._stage_sampling(b, off, r, n_slots)
            emit_spec.append((r, hist0, off))
            lane += 1
            off += n_slots
        for r, slot in plain_active:
            hist_len = r.prompt.size + len(r.out_tokens)
            b["pt"][lane] = self.cache.page_table(r.seq_id, mp)
            b["cl"][lane] = hist_len
            b["ql"][lane] = 1
            b["qoff"][lane] = hist_len - 1
            b["ids"][0, off] = r.out_tokens[-1]
            b["positions"][0, off] = hist_len - 1
            b["slot_map"][0, off] = slot
            self._stage_sampling(b, off, r)
            rows[r.req_id] = off
            lane += 1
            off += 1
        if pf is not None:
            req, start, end, chunk, n, pslots = pf
            b["pt"][lane] = self.cache.page_table(req.seq_id, mp)
            b["cl"][lane] = start + n
            b["ql"][lane] = n
            b["qoff"][lane] = start
            b["ids"][0, off:off + n] = chunk
            b["positions"][0, off:off + n] = start + np.arange(
                n, dtype=np.int32)
            b["slot_map"][0, off:off + n] = pslots
            # only the chunk's LAST token's sample is ever consumed (at
            # prefill completion); earlier tokens keep the neutral
            # parameters and their greedy output is discarded
            rows[req.req_id] = off + n - 1
            self._stage_sampling(b, off + n - 1, req)
        # 7. ONE dispatch, ONE host fetch: [T] tokens, [T] logprobs and,
        # with a draft, the round's proposals
        host = self._run(sc, self._ragged_body, rows).reshape(-1)
        toks, lps = host[:tcap], host[tcap:2 * tcap].view(np.float32)
        m = self.metrics
        if spec_active:
            m.spec_rounds.inc()
            m.spec_draft_tokens.inc(sum(min(k, a[2]) for a in spec_active))
        if spec_active or plain_active:
            m.decode_steps.inc()
            m.batch_size.record(len(spec_active) + len(plain_active))
        if pf is not None:
            m.prefill_chunks.inc()
        # 8. events in the bucketed order: verify lanes, decode lanes,
        # then the prefill completion
        if spec_active:
            props = host[2 * tcap:].reshape(-1, k + 1)
            accepted = 0
            for i, ((r, hist0, toff), a) in enumerate(zip(emit_spec,
                                                          spec_active)):
                span = slice(toff, toff + a[2])
                accepted += self._accept(
                    r, hist0, toks[span], lps[span], props[i], events,
                    list(range(toff, toff + a[2])))
            m.spec_accepted_tokens.inc(accepted)
        for r, _ in plain_active:
            row = rows[r.req_id]
            self._emit_token(r, int(toks[row]), events,
                             logprob=float(lps[row]))
        if pf is not None:
            req, start, end = pf[:3]
            self.scheduler.prefill_advanced(req, end)
            if req.state == RequestState.RUNNING:
                row = rows[req.req_id]
                self._prefill_finish(req, events, int(toks[row]),
                                     float(lps[row]), row)

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
        self._free_draft_seq(req.seq_id)
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

    def _step_body(self, sample_capable):
        def body(x):
            return _paged_step_body(self.model, self._core, self.cache,
                                    self.window, x, sample_capable)
        return body

    def _ragged_body(self, x):
        return _ragged_step_body(self.model, self._core, self.cache,
                                 self.window, x, self._props)

    def _verify_body(self, sample_capable):
        def body(x):
            return _verify_step_body(self.model, self._core, self.cache,
                                     self.window, x, self._props,
                                     sample_capable)
        return body

    def _propose_body(self, sample_capable):
        def body(x):
            return _propose_body(self.draft, self._draft_core,
                                 self._draft_cache, self._draft_window, x,
                                 self._props, sample_capable)
        return body

    def _draft_trunk(self, x):
        """The draft's catch-up: its trunk alone writes the chunk's K/V
        (no head, no sampling: nothing of it is read)."""
        return _paged_forward(self._draft_core, self._draft_cache,
                              self._draft_window, x["ids"], x["positions"],
                              x["pt"], x["cl"], x["slot_map"])

    def _dispatch(self, sc, body):
        """One dispatch of program class ``sc`` on the inputs staged in
        ``sc.host``: on the card a replay of the class's CUDA graph
        (captured here at its first use), on the CPU the eager body.
        Returns the body's outputs (on the card, the graph's static
        output buffers)."""
        if not self._graphs:
            out = sc.run_eager(body)
        else:
            if sc.graph is None:
                sc.capture(body, self.device, self._graph_pool)
                self.metrics.graphs_captured.inc()
            out = sc.replay()
            self.metrics.graph_replays.inc()
        sc.dispatches += 1
        self._count_dispatch(sc.key)
        return out

    def _run(self, sc, body, rows):
        """:meth:`_dispatch` of a step whose body returns ``(fetched,
        logits)``, and the one host fetch of ``fetched`` (int32: its
        tokens, logprob bits and any proposals). ``rows`` maps each
        request of the dispatch to its row of the logits."""
        out, logits = self._dispatch(sc, body)
        self._logits_dev = logits
        self._rows = rows
        host = out.cpu().numpy()             # ONE fetch
        self.metrics.fetch_bytes.inc(host.nbytes)
        self.metrics.step_fetches.inc()
        return host

    def _count_dispatch(self, key):
        """Account one device dispatch and its program class (``key``,
        the static shape signature that keys the step's CUDA graphs).
        ``step_program_classes`` is the gauge the ragged path bounds at
        <= 2; the bucketed path grows one class per decode bucket (and
        sampler variant) plus the prefill and verify shapes. The draft's
        dispatches (its proposal and catch-up) count as dispatches, not
        as step classes."""
        self.metrics.step_dispatches.inc()
        if key[0].startswith("draft"):
            return
        if key not in self._program_classes:
            self._program_classes.add(key)
            self.metrics.step_program_classes.set(
                len(self._program_classes))


def _tokens(host):
    """A fetch's tokens and logprobs (the float32 bits of its second
    row)."""
    return host[0], host[1].view(np.float32)


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
                   slot_map, ragged=None):
    """The transformer trunk over the paged cache: embed, attend (the
    step's K/V written into the page pool first), final norm. ids,
    positions and slot_map are ``[B, S]``, pt ``[B, P]``, cl ``[B]``,
    all int32 on the cache's device. With ``ragged=(ql, qoff)`` the
    tokens are ``[1, T]`` packed lane-major and pt, cl, ql, qoff are the
    ``[L, P]`` / ``[L]`` per-lane arrays. K5's plan (each token's lane
    and position, and the tile form's plan) is built once, before the
    layer loop. Returns the hidden states ``[B, S, H]``."""
    b, s = ids.shape
    slots = slot_map.reshape(-1).long()
    if ragged is None:
        plan = paged_plan(positions[:, 0], s)
    else:
        at = core.layers[0].self_attn
        plan = ragged_plan(*ragged, s, at.num_heads // at.num_kv_heads)
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
        out = planned_attention(q.reshape(b * s, nh, hd), kp, vp, pt, cl,
                                plan, scale=1.0 / (hd ** 0.5),
                                window=window)
        h = x + at.o_proj(out.reshape(b, s, nh * hd))
        x = h + layer.mlp(layer.post_attention_layernorm(h))
    return core.norm(x)


def _fetched(tokens, logprobs):
    """Tokens and logprobs as one ``[2, N]`` int32 tensor (the logprobs'
    float32 bits), so the host fetches them in one copy."""
    return torch.stack([tokens, logprobs.view(torch.int32)])


def _paged_step_body(model, core, cache, window, x, sample_capable):
    """The bucketed step on its inputs ``x`` (name -> tensor): forward,
    the last real token's logits per lane, fused sampling. Returns
    ``([2, B] tokens and logprob bits, logits [B, V] float32)``."""
    h = _paged_forward(core, cache, window, x["ids"], x["positions"],
                       x["pt"], x["cl"], x["slot_map"])
    b = h.shape[0]
    h_last = h[torch.arange(b, device=h.device), x["last_idx"].long()]
    logits = model.lm_head(h_last).float()
    tokens, logprobs = fused_sample(logits, *(x[n] for n in _SAMPLING),
                                    sample_capable=sample_capable)
    return _fetched(tokens, logprobs), logits


def _ragged_step_body(model, core, cache, window, x, props=None):
    """The token-packed unified step: the trunk runs at ``[1, T]`` with
    ``ragged=(ql, qoff)``, the head and fused sampling cover EVERY
    packed token, each with its own ``(seed, step)`` (a verify token j
    of a lane carries its lane's ``steps0 + j``; a prefill chunk's
    non-final tokens carry neutral parameters; their samples are
    discarded). Always sample-capable: greedy tokens take
    ``fused_sample``'s argmax / raw-logprob branch, so greedy and sampled
    steps share one class. With a draft (``props``, the round's
    proposals ``[max_batch, k+1]`` on the device) a token whose ``src``
    is not -1 takes its id from the proposals. Returns ``(tokens and
    logprob bits [2, T], or with a draft the same flattened and then the
    proposals, logits [T, V] float32)``."""
    ids = x["ids"]
    if props is not None:
        src = x["src"]
        ids = torch.where(src >= 0,
                          props.reshape(-1)[src.clamp(min=0).long()], ids)
    h = _paged_forward(core, cache, window, ids, x["positions"],
                       x["pt"], x["cl"], x["slot_map"],
                       ragged=(x["ql"], x["qoff"]))
    logits = model.lm_head(h[0]).float()
    tokens, logprobs = fused_sample(logits, *(x[n] for n in _SAMPLING),
                                    sample_capable=True)
    out = _fetched(tokens, logprobs)
    if props is not None:
        out = torch.cat([out.reshape(-1), props.reshape(-1)])
    return out, logits


def _verify_step_body(model, core, cache, window, x, props,
                      sample_capable):
    """The speculative verify step over ``[B, k+1]``: lane i's ids are
    its last token (staged) and then its proposals ``props[i, :k]`` (on
    the device); every position's logits and the target's own sample
    there, drawn at token index ``steps0 + j``. Returns ``([3, B, k+1]
    tokens, logprob bits and the proposals, logits [B, k+1, V]
    float32)``."""
    b, k1 = x["positions"].shape
    pr = props[:b]
    ids = torch.cat([x["ids"], pr[:, :k1 - 1]], dim=1)
    h = _paged_forward(core, cache, window, ids, x["positions"], x["pt"],
                       x["cl"], x["slot_map"])
    logits = model.lm_head(h).float()
    tokens, logprobs = fused_sample_multi(
        logits, *(x[n] for n in _SAMPLING), sample_capable=sample_capable)
    return torch.stack([tokens, logprobs.view(torch.int32), pr]), logits


def _propose_body(draft, core, cache, window, x, props, sample_capable):
    """The draft's k+1 chained single-token steps (the counterpart of
    the JAX package's one ``lax.scan`` program): step j feeds the token
    step j-1 sampled (step 0 the lane's last token) at position ``pos0 +
    j``, slot ``slot_map[:, j]`` and context ``cl0 + j``, and samples
    with the key the verify step uses at that position (``steps0 + j``):
    correlated noise is what lets a good draft match sampled lanes too.
    The (k+1)-th step only writes the k-th proposal's K/V (a full accept
    leaves no hole); its token is not used. Writes the proposals into
    ``props[:B]`` and returns it."""
    ids = x["ids"]
    b, k1 = x["slot_map"].shape
    samp = [x[n] for n in _SAMPLING[:-1]]
    toks = []
    for j in range(k1):
        h = _paged_forward(core, cache, window, ids, x["positions"] + j,
                           x["pt"], x["cl"] + j, x["slot_map"][:, j:j + 1])
        logits = draft.lm_head(h[:, 0]).float()
        tok, _ = fused_sample(logits, *samp, x["steps"] + j,
                              sample_capable=sample_capable)
        toks.append(tok)
        ids = tok[:, None]
    props[:b].copy_(torch.stack(toks, dim=1))
    return props
