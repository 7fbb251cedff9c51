"""Continuous-batching scheduler (counterpart:
``paddle_tpu/serving/scheduler.py``; host numpy, the same policy).

Policy, per iteration (``schedule(now)``):

1. **Deadline sweep** — requests past their absolute deadline are
   evicted gracefully: pages are the ENGINE's to free; the scheduler
   marks them finished with reason ``"deadline"`` and surfaces partial
   output.
2. **Decode priority** — every fully-prefilled running request decodes
   one token this iteration (they form one batched step).
3. **Prefill chunking** — at most ONE prefill chunk per iteration (the
   head of the admitted-but-unprefilled queue) rides along, so admission
   never starves decode latency.
4. **Admission by free-page watermark** — a waiting request is admitted
   only when the free pages cover its FULL token history plus a reserved
   watermark (head-room that keeps running decodes from thrashing the
   preemption path on every page boundary).

Preemption by page pressure is engine-initiated (the allocator raises
OutOfPages mid-step): ``pick_victim`` chooses the NEWEST live request
(LIFO — the vLLM recompute policy; the oldest request is never chosen,
which is what makes the no-starvation property hold), and ``preempt``
requeues it at the FRONT of the waiting queue with its generated tokens
kept, so recompute-prefill reproduces its logits.

Speculative decoding (``spec_reserve_tokens`` = k): a verify round
appends up to k+1 slots a lane, so admission charges every request's
worst-case round growth, and running lanes keep their next round's
growth reserved: a verify burst never preempts an admitted decode.

The JAX package's prefix-cache and migration branches are left out with
the features they serve.
"""
from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Request", "RequestState", "Scheduler", "SchedulerOutput"]

_req_ids = itertools.count()


class RequestState:
    WAITING = "waiting"        # queued, no pages held
    PREFILLING = "prefilling"  # admitted, chunked prefill in flight
    RUNNING = "running"        # decoding
    FINISHED = "finished"


@dataclass(eq=False)  # identity semantics: the prompt array would make
class Request:        # field-wise __eq__ broadcast inside `in` checks
    prompt: np.ndarray                 # int32 [S0]
    max_new_tokens: int
    arrival: float = 0.0               # engine clock (seconds)
    deadline: float | None = None      # ABSOLUTE engine-clock deadline
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    n: int = 1                         # parallel samples (copy-on-fork)
    logprobs: bool = False             # emit per-token logprob in events
    request_id: str | None = None      # client/router trace id
    speculative: bool | None = None    # False: opt out of spec rounds
    device_seed: int = 0               # per-request sampling seed
    req_id: int = field(default_factory=lambda: next(_req_ids))
    state: str = RequestState.WAITING
    out_tokens: list = field(default_factory=list)
    prefill_pos: int = 0               # history tokens already prefilled
    finish_reason: str | None = None
    preemptions: int = 0
    # engine bookkeeping
    first_token_at: float | None = None
    last_token_at: float | None = None
    parent_id: int | None = None       # set on forked children

    @property
    def seq_id(self):
        return self.req_id

    def token_history(self):
        """prompt + sampled tokens = the sequence whose K/V the cache
        must hold. The LAST element (once out_tokens is non-empty) has
        not been fed through the model yet."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int32)])

    def reset_for_recompute(self):
        """Preemption: drop cache state, keep generated tokens — the
        recompute prefill replays prompt+out_tokens so the next sampled
        token is exactly what the uninterrupted run would produce."""
        self.prefill_pos = 0
        self.state = RequestState.WAITING
        self.preemptions += 1


@dataclass
class SchedulerOutput:
    decode: list                       # Requests decoding this iteration
    prefill: tuple | None              # (Request, start, end) or None
    expired: list                      # deadline-evicted this iteration


class Scheduler:
    def __init__(self, cache, *, max_batch=8, prefill_chunk=32,
                 watermark_frac=0.05, spec_reserve_tokens=0):
        self.cache = cache
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self.spec_reserve_tokens = int(spec_reserve_tokens)
        self.watermark_pages = max(
            1, math.ceil(watermark_frac * cache.allocatable_pages))
        self.waiting: deque[Request] = deque()
        self.prefill_queue: deque[Request] = deque()
        self.running: list[Request] = []
        # admission order among LIVE (page-holding) requests — the LIFO
        # preemption victim list
        self._admit_order: list[Request] = []

    # -- queue ops ---------------------------------------------------------
    def add(self, req: Request):
        self.waiting.append(req)

    def requeue_front(self, req: Request):
        """Preempted request: front of the queue, so it re-admits before
        anything younger."""
        self.waiting.appendleft(req)

    def register_fork(self, child: Request):
        """A fork created at prefill completion enters RUNNING directly
        (its pages are shared with the parent until copy-on-write)."""
        child.state = RequestState.RUNNING
        self.running.append(child)
        self._admit_order.append(child)

    def live_requests(self):
        return list(self.prefill_queue) + list(self.running)

    def queue_depth(self):
        return len(self.waiting)

    # -- main policy -------------------------------------------------------
    def schedule(self, now) -> SchedulerOutput:
        expired = self._sweep_deadlines(now)
        self._admit(now)
        decode = [r for r in self.running
                  if r.state == RequestState.RUNNING][:self.max_batch]
        prefill = None
        if self.prefill_queue:
            req = self.prefill_queue[0]
            hist = req.token_history()
            end = min(req.prefill_pos + self.prefill_chunk, len(hist))
            prefill = (req, req.prefill_pos, end)
        return SchedulerOutput(decode=decode, prefill=prefill,
                               expired=expired)

    def _sweep_deadlines(self, now):
        expired = []
        for q in (self.waiting, self.prefill_queue):
            for r in list(q):
                if r.deadline is not None and now > r.deadline:
                    q.remove(r)
                    expired.append(r)
        for r in list(self.running):
            if r.deadline is not None and now > r.deadline:
                self.running.remove(r)
                expired.append(r)
        for r in expired:
            if r in self._admit_order:
                self._admit_order.remove(r)
            r.state = RequestState.FINISHED
            r.finish_reason = "deadline"
        return expired

    def worst_case_need(self, req):
        """Pages ``req`` still needs to cover its history plus one full
        decode round (1 token, or 1 + ``spec_reserve_tokens`` with
        speculative decoding on) — the admission unit."""
        need = self.cache.pages_for(len(req.token_history()) + 1
                                    + self.spec_reserve_tokens)
        return max(0, need - self.cache.pages_held(req.seq_id))

    def _committed_pages(self):
        """Pages PROMISED to admitted requests but not yet pulled from
        the free list (their prefill chunks haven't run) — without this,
        back-to-back admissions in one iteration would all see the same
        free count and oversubscribe the pool. With speculative decoding
        on, running lanes also reserve their next verify round's
        worst-case growth."""
        total = sum(self.worst_case_need(r) for r in self.prefill_queue)
        if self.spec_reserve_tokens:
            total += sum(self.worst_case_need(r) for r in self.running)
        return total

    def _admit(self, now):
        committed = self._committed_pages()
        while self.waiting:
            req = self.waiting[0]
            slots = len(self.prefill_queue) + len(self.running)
            if slots + req.n > self.max_batch:
                break
            need = self.worst_case_need(req)
            if self.cache.available_pages - committed \
                    < need + self.watermark_pages:
                break  # FIFO head-of-line: younger requests must wait too
            self.waiting.popleft()
            req.state = RequestState.PREFILLING
            self.prefill_queue.append(req)
            self._admit_order.append(req)
            committed += need

    def remove(self, req: Request):
        """Purge a request from EVERY queue (cancellation path) without
        touching its state — the engine owns the state transition and
        the page release."""
        if req in self.waiting:
            self.waiting.remove(req)
        if req in self.prefill_queue:
            self.prefill_queue.remove(req)
        if req in self.running:
            self.running.remove(req)
        if req in self._admit_order:
            self._admit_order.remove(req)

    # -- state transitions driven by the engine ----------------------------
    def prefill_advanced(self, req: Request, new_pos: int):
        req.prefill_pos = new_pos
        if new_pos >= len(req.token_history()):
            self.prefill_queue.remove(req)
            req.state = RequestState.RUNNING
            self.running.append(req)

    def finish(self, req: Request, reason: str):
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        if req in self.running:
            self.running.remove(req)
        if req in self.prefill_queue:
            self.prefill_queue.remove(req)
        if req in self._admit_order:
            self._admit_order.remove(req)

    # -- preemption --------------------------------------------------------
    def pick_victim(self, exclude=()):
        """Newest live request not excluded (LIFO recompute policy)."""
        for r in reversed(self._admit_order):
            if r not in exclude:
                return r
        return None

    def preempt(self, victim: Request):
        """Drop the victim's pages-holding state and requeue it (front)
        for recompute. The ENGINE frees the cache sequence."""
        if victim in self.running:
            self.running.remove(victim)
        if victim in self.prefill_queue:
            self.prefill_queue.remove(victim)
        if victim in self._admit_order:
            self._admit_order.remove(victim)
        victim.reset_for_recompute()
        self.requeue_front(victim)

    def all_done(self):
        return not (self.waiting or self.prefill_queue or self.running)
