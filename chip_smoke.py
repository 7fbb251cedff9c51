#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card: the quickest proof that the
port builds, is right and serves on the GPU.

    python3 chip_smoke.py [--out PATH] [--profile STEPS]

Phases, each of which passes or ends the script with a non-zero code:

1. The card's name and power limit, the torch/CUDA versions, and the
   build of every kernel from the sources in this checkout (one ``nvcc``
   per source, all started together).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving path gives it, with the stated
   tolerance; its time beside the plain version's, one PyTorch library
   call's (a yardstick the port never calls) and the card's bound.
3. Engine: ``ServingEngine`` over ``LlamaForCausalLM(LlamaConfig.
   llama2_7b(dtype="bfloat16"))`` at full width and depth, random
   weights from a seed, answers 8 requests. Every request
   must finish with its token count; the kernel must have launched
   layers x forwards times and the plain version never; the greedy
   requests' last-prompt-token logits must agree with a dense causal
   forward of the same model.

The last lines are the ``kernels`` JSON, the card's name and power limit
as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16_TOL = 2e-2   # atol = rtol for bf16 outputs (one bf16 ulp is 2**-8)
F32_TOL = 1e-4    # f32 outputs: summation order only
PAGE_SIZE = 16
HEAD_DIM = 128
KV_POOL_PAGES = 1024


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, timed with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- ragged paged attention (K5) ---------------------------------------------

def make_case(lanes, *, nh, nkv, dtype, int8=False, window=None,
              pad_tokens=0, pad_lanes=0, seed=0, dev="cuda"):
    """A token-packed batch over a page pool of KV_POOL_PAGES pages.
    ``lanes`` = [(context_len, query_len), ...]: each lane's queries are
    its last ``query_len`` positions, its keys sit in randomly ordered
    pages. Padded lanes have context 1 on the scratch page, padding
    tokens follow the real ones, as the engine lays them out."""
    import torch
    from paddle_tpu_torch.serving.attention import _token_lanes, quantize_q8
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    max_pages = 4096 // PAGE_SIZE  # LLaMA-2's max_position_embeddings
    n_lanes = len(lanes) + pad_lanes
    pt = torch.zeros(n_lanes, max_pages, dtype=torch.int32)
    cl = torch.ones(n_lanes, dtype=torch.int32)
    ql = torch.zeros(n_lanes, dtype=torch.int32)
    qoff = torch.zeros(n_lanes, dtype=torch.int32)
    perm = torch.randperm(KV_POOL_PAGES - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    used = 0
    for i, (c, q) in enumerate(lanes):
        n = math.ceil(c / PAGE_SIZE)
        pt[i, :n] = perm[used:used + n]
        used += n
        cl[i], ql[i], qoff[i] = c, q, c - q
    if used > KV_POOL_PAGES - 1:
        raise ValueError("case needs more pages than the pool holds")
    t = int(ql.sum()) + pad_tokens
    shape = (KV_POOL_PAGES, PAGE_SIZE, nkv, HEAD_DIM)
    kf = torch.randn(shape, generator=g, device=dev)
    vf = torch.randn(shape, generator=g, device=dev)
    if int8:
        kp, vp = quantize_q8(kf), quantize_q8(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    pt, cl, ql, qoff = (x.to(dev) for x in (pt, cl, ql, qoff))
    lane, pos = _token_lanes(ql, qoff, t)
    return dict(q=torch.randn(t, nh, HEAD_DIM, generator=g,
                              device=dev).to(dtype),
                k=kp, v=vp, pt=pt, cl=cl, ql=ql, qoff=qoff, lane=lane,
                pos=pos, window=window, scale=HEAD_DIM ** -0.5,
                n_real=t - pad_tokens)


def case_work(c):
    """(bytes, flops) the function needs on this data (bf16 pages, no
    window — the timed cases): q read and the output written once, the
    page-table rows and per-token metadata, each lane's live K/V (keys
    below its last token's visible end) read once; 4*D flops per visible
    (token, query head, key)."""
    q, kp = c["q"], c["k"]
    t, nh, d = q.shape
    per_key = 2 * kp.shape[2] * d * kp.element_size()
    pos, lane, cl = (c[k].tolist() for k in ("pos", "lane", "cl"))
    live = {}
    flops = 0
    for tok in range(t):
        hi = min(pos[tok] + 1, cl[lane[tok]])
        flops += 4 * hi * nh * d
        live[lane[tok]] = max(live.get(lane[tok], 0), hi)
    meta = 4 * (c["pt"].numel() + 3 * len(cl) + 2 * t)
    nbytes = (2 * q.numel() * q.element_size() + sum(live.values())
              * per_key + meta)
    return nbytes, flops


def bound(nbytes, flops):
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / BF16_FLOPS * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def sdpa_inputs(c):
    """The case (bf16 pages, no window) gathered to a contiguous per-lane
    cache for one ``scaled_dot_product_attention`` call: q [L, H, Smax,
    D], K/V [L, KV, Kmax, D], a boolean mask [L, 1, Smax, Kmax]."""
    import torch
    q, pt, cl, ql, qoff = (c[k] for k in ("q", "pt", "cl", "ql", "qoff"))
    nl, smax, kmax = len(ql), int(ql.max()), int(cl.max())
    t, nh, d = q.shape
    nkv = c["k"].shape[2]
    dev = q.device
    qs = torch.zeros(nl, nh, smax, d, dtype=q.dtype, device=dev)
    ks = torch.zeros(nl, nkv, kmax, d, dtype=q.dtype, device=dev)
    vs = torch.zeros_like(ks)
    mask = torch.zeros(nl, 1, smax, kmax, dtype=torch.bool, device=dev)
    kpos = torch.arange(kmax, device=dev)
    start = 0
    for i in range(nl):
        n, ctx, off = int(ql[i]), int(cl[i]), int(qoff[i])
        qs[i, :, :n] = q[start:start + n].transpose(0, 1)
        start += n
        rows = pt[i].long()
        for dst, pool in ((ks, c["k"]), (vs, c["v"])):
            dst[i, :, :ctx] = pool[rows].reshape(-1, nkv, d)[:ctx] \
                .transpose(0, 1)
        qpos = off + torch.arange(n, device=dev)[:, None]
        mask[i, 0, :n] = (kpos[None] <= qpos) & (kpos[None] < ctx)
    return qs, ks, vs, mask


def kernel_phase(dev="cuda"):
    """K5 against its plain version at the serving path's shapes; times
    at the engine's decode and prefill shapes. Returns the largest bf16
    error and the timings."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.serving import attention as A

    decode = [(37, 1), (130, 1), (511, 1), (777, 1), (1024, 1),
              (1500, 1), (1800, 1), (2047, 1)]
    prefill = [(1024, 256)]
    mixed = decode[:5] + [(1024, 256), (300, 5)]
    bf16 = torch.bfloat16
    checks = [
        ("llama2_7b decode bf16", decode, dict(nh=32, nkv=32, dtype=bf16)),
        ("llama2_7b prefill bf16", prefill,
         dict(nh=32, nkv=32, dtype=bf16)),
        ("llama2_7b mixed+padding bf16", mixed,
         dict(nh=32, nkv=32, dtype=bf16, pad_tokens=7, pad_lanes=2)),
        ("mistral GQA 32:8 mixed bf16", mixed,
         dict(nh=32, nkv=8, dtype=bf16)),
        ("mistral GQA 32:8 mixed bf16 window 512", mixed,
         dict(nh=32, nkv=8, dtype=bf16, window=512)),
        ("llama2_7b mixed int8 pages", mixed,
         dict(nh=32, nkv=32, dtype=bf16, int8=True)),
        ("mistral GQA int8 pages window 300", mixed,
         dict(nh=32, nkv=8, dtype=bf16, int8=True, window=300)),
        ("GQA 32:8 f32", [(37, 1), (300, 5), (200, 64)],
         dict(nh=32, nkv=8, dtype=torch.float32, pad_tokens=3)),
    ]
    worst = 0.0
    for i, (name, lanes, kw) in enumerate(checks):
        c = make_case(lanes, seed=i, dev=dev, **kw)
        args = (c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"],
                c["lane"])
        kw_a = dict(scale=c["scale"], window=c["window"])
        got = A.ragged_paged_attention_cuda(*args, **kw_a)
        want = A.ragged_paged_attention_plain(*args, **kw_a)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        n = c["n_real"]
        err = (got[:n].float() - want[:n].float()).abs().max().item()
        tol = F32_TOL if c["q"].dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got[:n].float(), want[:n].float(),
                                   atol=tol, rtol=tol, msg=name)
        if tol == BF16_TOL:
            worst = max(worst, err)
        print(f"kernel check ok: {name}: T={c['q'].shape[0]} "
              f"max_abs_err={err:.3e} (tol {tol})", flush=True)

    timings = {}
    for name, lanes in (("decode", decode), ("prefill", prefill)):
        c = make_case(lanes, nh=32, nkv=32, dtype=bf16, seed=100, dev=dev)
        args = (c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"],
                c["lane"])
        kw_a = dict(scale=c["scale"], window=None)
        ms = cuda_ms(lambda: A.ragged_paged_attention_cuda(*args, **kw_a),
                     iters=20)
        plain_ms = cuda_ms(
            lambda: A.ragged_paged_attention_plain(*args, **kw_a),
            iters=3, warmup=1)
        qs, ks, vs, mask = sdpa_inputs(c)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=c["scale"]), iters=20)
        nbytes, flops = case_work(c)
        bound_ms, bound_by = bound(nbytes, flops)
        timings[name] = dict(ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=nbytes, flops=flops,
                             tokens=c["q"].shape[0])
        print(f"kernel time {name}: T={c['q'].shape[0]} kernel {ms:.4f} ms"
              f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, "
              f"{flops} flop)", flush=True)
    return worst, timings


# -- the serving engine ------------------------------------------------------

PROMPT_LENS = (32, 1024, 200, 512, 77, 900, 333, 640)
SAMPLED = (2, 5)          # request indices that sample; the rest greedy
NEW_TOKENS = 32
COSINE_MIN = 0.999        # engine vs dense last-prompt-token logits
# argmax must agree where the dense top-2 gap exceeds this: about twice
# the bf16 noise between the chunked paged path and the dense forward
# (max abs logit difference 0.19-0.23 at full depth on an H100)
MARGIN = 0.5


def engine_phase(cfg, smi, dev=None, profile_steps=0):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import attention as A

    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    print(f"model: llama2_7b width h={cfg.hidden_size} "
          f"L={cfg.num_hidden_layers} heads={cfg.num_attention_heads} "
          f"ffn={cfg.intermediate_size} vocab={cfg.vocab_size}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params bf16, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first_logits = {}
    eng = None

    def on_event(ev):
        if ev["type"] == "token" and ev["req_id"] not in first_logits:
            first_logits[ev["req_id"]] = eng.last_logits[0].clone()

    eng = ServingEngine(model, page_size=PAGE_SIZE,
                        num_pages=KV_POOL_PAGES, max_batch=8,
                        prefill_chunk=256, on_event=on_event, device=dev)
    print(f"kv pool: {eng.cache.num_pages} pages x {PAGE_SIZE} tokens, "
          f"{eng.cache.bytes_total / 2 ** 30:.2f} GiB "
          f"{eng.cache_dtype}", flush=True)
    # warm-up request: library initialisation stays out of the numbers
    eng.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    eng.run()

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    A.reset_stats()
    dispatches0 = eng.metrics.step_dispatches.value
    t_start = time.perf_counter()
    rids = []
    for i, p in enumerate(prompts):
        sampled = i in SAMPLED
        rids.append(eng.add_request(
            p, max_new_tokens=NEW_TOKENS, do_sample=sampled,
            temperature=0.8 if sampled else 1.0,
            top_k=50 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=1000 + i))
    decode_tokens = decode_s = 0.0
    steps = 0
    while not eng.scheduler.all_done():
        chunks = eng.metrics.prefill_chunks.value
        t = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - t
        steps += 1
        if eng.metrics.prefill_chunks.value == chunks:
            decode_s += dt
            decode_tokens += sum(e["type"] == "token" for e in events)
    wall = time.perf_counter() - t_start
    counts = dict(A.stats)
    forwards = eng.metrics.step_dispatches.value - dispatches0

    res = eng.results()
    for rid, p in zip(rids, prompts):
        r = res[rid]
        if r["finish_reason"] != "length" or \
                len(r["tokens"]) != NEW_TOKENS:
            raise AssertionError(f"request {rid} (prompt {p.size}) "
                                 f"finished {r['finish_reason']} with "
                                 f"{len(r['tokens'])} tokens")
    want = layers * forwards
    if counts["kernel_launches"] != want or counts["plain_calls"] != 0:
        raise AssertionError(
            f"attention counts {counts}: want {want} kernel launches "
            f"({layers} layers x {forwards} forwards) and 0 plain calls")
    print(f"engine ok: {len(rids)} requests x {NEW_TOKENS} tokens in "
          f"{steps} steps, {forwards} forwards, kernel launches "
          f"{counts['kernel_launches']} = {layers} x {forwards}, plain "
          f"calls 0", flush=True)

    worst_cos = 1.0
    for i, (rid, p) in enumerate(zip(rids, prompts)):
        if i in SAMPLED:
            continue
        with torch.inference_mode():
            dense = model(torch.as_tensor(p, device=model.device)
                          .long()[None])[0, -1].float()
        got = first_logits[rid]
        if not torch.isfinite(got).all():
            raise AssertionError(f"request {rid}: non-finite logits")
        cos = torch.nn.functional.cosine_similarity(got, dense, dim=0)
        cos = cos.item()
        top2 = dense.topk(2).values
        margin = (top2[0] - top2[1]).item()
        diff = (got - dense).abs().max().item()
        worst_cos = min(worst_cos, cos)
        agree = int(got.argmax()) == int(dense.argmax())
        print(f"dense check: prompt {p.size}: cosine {cos:.6f}, max abs "
              f"diff {diff:.4f}, top-2 margin {margin:.4f}, argmax "
              f"{'equal' if agree else 'differs'}", flush=True)
        if cos < COSINE_MIN:
            raise AssertionError(f"prompt {p.size}: cosine {cos} < "
                                 f"{COSINE_MIN}")
        if margin > MARGIN and not agree:
            raise AssertionError(f"prompt {p.size}: argmax differs at "
                                 f"margin {margin} > {MARGIN}")
        if res[rid]["tokens"][0] != int(got.argmax()):
            raise AssertionError(f"prompt {p.size}: first greedy token "
                                 "is not the argmax of its logits")

    m = eng.metrics.export()
    tokens = len(rids) * NEW_TOKENS
    summary = dict(
        card=smi, layers=layers, requests=len(rids), steps=steps,
        forwards=forwards, wall_s=wall, output_tok_s=tokens / wall,
        decode_tok_s=(decode_tokens / decode_s if decode_s else None),
        ttft_p50_s=m["ttft_s"]["p50"], ttft_max_s=m["ttft_s"]["max"],
        step_p50_s=m["step_duration_s"]["p50"],
        step_max_s=m["step_duration_s"]["max"],
        preemptions=m["preemptions"], worst_cosine=worst_cos,
        launches=counts["kernel_launches"],
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if model.device.type == "cuda" else None))
    print(f"serving [{smi}]: TTFT p50 {summary['ttft_p50_s']:.4f} s "
          f"max {summary['ttft_max_s']:.4f} s (8 requests queued at once)"
          , flush=True)
    print(f"serving [{smi}]: decode {summary['decode_tok_s']:.1f} tok/s "
          f"(decode-only steps), output {summary['output_tok_s']:.1f} "
          f"tok/s over {wall:.3f} s", flush=True)
    print(f"serving [{smi}]: step p50 {summary['step_p50_s']:.4f} s max "
          f"{summary['step_max_s']:.4f} s", flush=True)
    if profile_steps:
        summary["profile"] = profile_decode(eng, cfg, profile_steps, smi)
    return summary


def profile_decode(eng, cfg, n_steps, smi):
    """``torch.profiler`` over ``n_steps`` decode-only steps of a full
    batch of 8 (context ~512): wall vs device busy time per step and the
    kernels that take the device time."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.add_request(rng.integers(1, cfg.vocab_size, 512)
                        .astype(np.int32), max_new_tokens=n_steps + 4)
    while eng.scheduler.waiting or eng.scheduler.prefill_queue:
        eng.step()
    eng.step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    eng.run()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True,
                  key=lambda e: e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    launches = sum(e.count for e in rows) / n_steps
    top = [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count
            // n_steps) for e in rows[:10]]
    print(f"profile [{smi}]: decode step (8 lanes, ctx ~512): wall "
          f"{wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f} %), idle "
          f"{100 * (1 - device_ms / wall_ms):.1f} %, {launches:.0f} "
          "kernels", flush=True)
    for name, ms, count in top:
        print(f"profile: {ms:8.3f} ms/step  x{count:<5d} {name[:90]}",
              flush=True)
    return dict(wall_ms=wall_ms, device_ms=device_ms, kernels=launches,
                top=[dict(name=n, ms_per_step=m, calls_per_step=c)
                     for n, m, c in top])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", metavar="PATH",
                    help="also write every number of the run to PATH as "
                         "JSON")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS decode steps with "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.serving import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    build_s = build([A.KERNEL_LIBRARY])
    print(f"kernels built from source in {build_s:.1f} s", flush=True)

    from paddle_tpu_torch.models import LlamaConfig
    worst_err, timings = kernel_phase()
    summary = engine_phase(LlamaConfig.llama2_7b(dtype="bfloat16"), smi,
                           profile_steps=args.profile)

    main_t = timings["decode"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/serving/attention.py:289",
        "launches": summary["launches"],
        "max_abs_err": worst_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shapes": timings,
    }]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           kernels=kernels, engine=summary), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
