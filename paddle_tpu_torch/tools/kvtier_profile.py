"""Where a host-tier spill and restore spend their time, on the card: a
LLaMA-2-7B page geometry (32 layers, 32 kv heads, head_dim 128, page 16,
bf16: 8 MiB a page) with one cached chain of ``--pages`` pages, spilled
whole to a ``HostPagePool`` (LRU eviction through ``KVTier.spill``, then
``flush``) and restored (``KVTier.restore``), ``--reps`` times. Prints
each pass's wall time by the host clock (the restore ends in a
``torch.cuda.synchronize``), the bytes moved and the rate, the functions
that took the most time in the last pass (``cProfile``), the card's name
and power limit, and last a JSON object of every reading.

    python -m paddle_tpu_torch.tools.kvtier_profile [--pages N] [--reps N]
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time


def _smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def _top(prof, n=8):
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(n)
    return out.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, default=66)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kvtier_profile: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.serving import HostPagePool, KVTier, PagedKVCache

    n = args.pages
    cache = PagedKVCache(32, 32, 128, page_size=16, num_pages=n + 2,
                         dtype="bfloat16", prefix_cache=True)
    cache._kv.normal_()
    tier = KVTier(HostPagePool(4 << 30))
    cache.attach_tier(tier)
    prompt = np.arange(n * 16, dtype=np.int32)
    cache.acquire_prefix("chain", prompt, prompt.size + 1)
    cache.append_slots("chain", prompt.size)
    cache.commit_prefix("chain", prompt, prompt.size)
    cache.free_seq("chain")
    torch.cuda.synchronize()
    nbytes = n * cache.bytes_total / cache.num_pages
    readings = []
    for rep in range(args.reps):
        spill_prof, restore_prof = cProfile.Profile(), cProfile.Profile()
        t0 = time.perf_counter()
        spill_prof.enable()
        spilled = 0
        while cache._evict_lru_leaf():
            spilled += 1
        tier.flush()
        spill_prof.disable()
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_prof.enable()
        restored = tier.restore(cache, prompt)
        torch.cuda.synchronize()
        restore_prof.disable()
        restore_s = time.perf_counter() - t0
        if spilled != n or restored != n:
            raise AssertionError(f"spilled {spilled}, restored {restored} "
                                 f"of {n} pages")
        r = dict(pass_=rep, pages=n, bytes=nbytes, spill_s=spill_s,
                 restore_s=restore_s, spill_gb_s=nbytes / spill_s / 1e9,
                 restore_gb_s=nbytes / restore_s / 1e9)
        readings.append(r)
        print(f"pass {rep}: {n} pages ({nbytes / 2 ** 20:.0f} MiB): spill "
              f"{spill_s:.3f} s ({r['spill_gb_s']:.3f} GB/s), restore "
              f"{restore_s:.3f} s ({r['restore_gb_s']:.3f} GB/s)",
              flush=True)
        tier.pool.clear()
    print("spill, last pass:\n" + _top(spill_prof))
    print("restore, last pass:\n" + _top(restore_prof))
    smi = _smi()
    print(smi)
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
