"""Serving: paged KV cache, paged attention (a hand-written CUDA kernel
on the card), continuous batching (counterpart: ``paddle_tpu.serving``).
"""
from .attention import (paged_attention, paged_attention_ref,
                        quantize_q8, ragged_paged_attention)
from .engine import ServingEngine
from .kv_cache import (SCRATCH_PAGE, GeometryMismatch, OutOfPages,
                       PagedKVCache, PrefixDrift)
from .kvtier import DiskPagePool, HostPagePool, KVTier
from .metrics import ServingMetrics
from .pagewire import WireFormatError, deserialize_pages, serialize_pages
from .sampling import fused_sample
from .scheduler import Request, RequestState, Scheduler

__all__ = ["DiskPagePool", "GeometryMismatch", "HostPagePool", "KVTier",
           "OutOfPages", "PagedKVCache", "PrefixDrift", "Request",
           "RequestState", "SCRATCH_PAGE", "Scheduler", "ServingEngine",
           "ServingMetrics", "WireFormatError", "deserialize_pages",
           "fused_sample", "paged_attention", "paged_attention_ref",
           "quantize_q8", "ragged_paged_attention", "serialize_pages"]
