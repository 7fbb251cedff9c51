"""Serving observability (counterpart: ``paddle_tpu/serving/metrics.py``):
the counters, gauges and reservoir histograms that the ported engine path
records, exported as a dict. Host-side; the engine records values it has
already fetched, so a metric never adds a device sync.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "ServingMetrics"]


class Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def export(self):
        return self.value


class Gauge:
    """A point-in-time value; ``set()`` overwrites."""

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def export(self):
        return self.value


class Histogram:
    """Bounded reservoir of samples (the LAST ``cap``); percentiles
    computed at export, ``count`` over all samples."""

    def __init__(self, cap=65536):
        self.cap = int(cap)
        self._samples: list[float] = []
        self.count = 0

    def record(self, v):
        self.count += 1
        self._samples.append(float(v))
        if len(self._samples) > self.cap:
            del self._samples[: len(self._samples) - self.cap]

    def export(self):
        if not self._samples:
            return {"count": self.count, "mean": None, "p50": None,
                    "p99": None, "max": None}
        a = np.asarray(self._samples)
        return {"count": self.count,
                "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max())}


class ServingMetrics:
    """The engine's metric set (attribute names are the export keys)."""

    def __init__(self):
        self.ttft_s = Histogram()
        self.inter_token_s = Histogram()
        self.step_duration_s = Histogram()
        self.queue_depth = Histogram()
        self.batch_size = Histogram()         # decode lanes, per step
        self.page_occupancy = Histogram()     # used/allocatable, per step
        self.prefill_chunks = Counter()
        self.decode_steps = Counter()
        self.tokens_generated = Counter()
        self.requests_finished = Counter()
        self.preemptions = Counter()
        self.deadline_evictions = Counter()
        self.cow_copies = Counter()
        self.cancellations = Counter()        # cancel() calls that landed
        self.fetch_bytes = Counter()          # host<-device bytes
        self.step_dispatches = Counter()      # model forwards issued
        self.step_fetches = Counter()         # host<-device fetches
        self.step_program_classes = Gauge()   # distinct step shape classes
        self.graphs_captured = Counter()      # CUDA graphs captured
        self.graph_replays = Counter()        # CUDA graph replays
        # speculative decoding
        self.spec_rounds = Counter()          # draft-propose/verify rounds
        self.spec_draft_tokens = Counter()    # proposals that could count
        self.spec_accepted_tokens = Counter()  # proposals verified+emitted
        self.spec_fallbacks = Counter()       # lanes demoted to plain
        self.queue_depth_gauge = Gauge()
        self.page_occupancy_gauge = Gauge()
        self.running_gauge = Gauge()          # running decode batch size
        self.spec_acceptance_rate = Gauge()   # accepted/proposed, cumul.
        # per-page byte cost incl. int8 scale rows — what the
        # hbm_budget sizing divides by
        self.kv_page_bytes = Gauge()

    def export(self):
        return {name: m.export() for name, m in vars(self).items()}
