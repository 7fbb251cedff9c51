"""Serving: paged KV cache, paged attention (a hand-written CUDA kernel
on the card), continuous batching (counterpart: ``paddle_tpu.serving``).
"""
from .attention import (paged_attention, paged_attention_ref,
                        quantize_q8, ragged_paged_attention)
from .engine import ServingEngine
from .kv_cache import SCRATCH_PAGE, OutOfPages, PagedKVCache
from .metrics import ServingMetrics
from .sampling import fused_sample
from .scheduler import Request, RequestState, Scheduler

__all__ = ["OutOfPages", "PagedKVCache", "Request", "RequestState",
           "SCRATCH_PAGE", "Scheduler", "ServingEngine", "ServingMetrics",
           "fused_sample", "paged_attention", "paged_attention_ref",
           "quantize_q8", "ragged_paged_attention"]
