#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card: the quickest proof that the
port builds, is right, trains and serves on the GPU.

    python3 chip_smoke.py [--out PATH] [--profile STEPS] [--phases LIST]

Phases, each of which passes or ends the script with a non-zero code:

1. The card's name and power limit, the torch/CUDA versions, and the
   build of every kernel from the sources in this checkout (one ``nvcc``
   per source, all started together); the HGMMA (wgmma) instructions in
   the SASS of K1's and K6's forward and of K2's and K3's backward,
   counted with ``cuobjdump`` (none in any of the four fails).
2. ``kernels``: each hand-written kernel (K5 ragged paged attention in
   its split and tile forms, K1-K3 flash attention forward / dq / dk-dv,
   K4 multi-tensor AdamW) against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it and at the other
   arms it takes (K5 also at the split form's boundaries, through both
   its entries, rows with no live key exactly 0), with the stated
   tolerance (flash attention element by element; K5 2e-2 of the element
   plus 2e-2; planted faults must fail the same comparison; K4's params,
   masters and moments equal to the plain version's, bare and in its
   arms: the global-norm clip factor read from device memory, L1,
   float32 grads under bf16 params, each of which a K4 without it must
   fail, as must one with the factor 10 % high or the clipped bf16 grad
   not rounded); its time beside the plain
   version's, one PyTorch library call's (a yardstick the port never
   calls) and the card's bound (K5 at LLaMA-2-7B's and Mistral's GQA
   32:8 decode and prefill shapes, at the speculative verify step's [8,
   5] and at the ragged phase's mixed step, both forms in one
   token-packed call, from CUDA-graph replays).
3. ``masked``: K6 (the streamed masked forward) and the masked arms of
   K2/K3 the same way, at B 1, S 4096, H 32 over 8 kv heads with the
   window cut to 1024: the window, C=1 documents with the window, a C=2
   band with dead rows, C=4, the additive mask in two broadcast forms,
   causal Sq 1024 against Sk 3072, float32, D 64 and D 256; dead rows
   exact; five planted faults rejected; timed at Mistral's training
   shape (B 2, S 8192, window 4096), K6 also on the packed phase's
   documents folded into the window.
4. ``dropseg``: the segment-id and counter-hash dropout arms of K1-K3
   and K6's segment arm the same way: the keep pattern read straight
   off K1's out, K2's dq and K3's dv (per query head of a GQA group) and
   compared with ``keep_scale`` bit for bit, bf16 and float32, segments
   aligned to the tiles and straddling them; (a) GPT's shape (B 8, S
   2048, H 16, D 128, causal, p 0.1, right-padded rows) in bf16 and
   float32, (b) GQA 32/8 with packed segments whose ids run out of
   order, (c) rows with no live key (exactly 0), (d) the cross-length
   segments of ``flash_attn_unpadded`` on K6 (D 128), and K1's padding
   arm with dropout at D 256; five planted faults
   rejected; ``flash_attn_unpadded`` driven with exact counts; timed at
   GPT's shape beside SDPA's flash backend with dropout and its
   memory-efficient backend with the padding mask.
5. ``train``: ``Model.train_batch_loop`` over ``LlamaForCausalLM(
   LlamaConfig.llama2_7b(num_hidden_layers=8, dtype="bfloat16",
   fuse_linear_cross_entropy=True))`` at full width, batch 4 x 2048
   tokens, ``AdamW(1e-4, multi_precision=True)``, random weights and
   batch from a seed. Before the first step the fused CE's float32
   logits, loss and gradients are held against a float32 head. K1, K2
   and K3 must have launched once per layer
   and step, K4 once per step, no plain version at all; the losses must
   be finite, start where random logits of the init's scale put them and
   fall. Then the same 2-layer run through the kernels and through the
   plain versions (patched in here) must agree loss for loss.
6. ``mistral``: the same over ``LlamaConfig.mistral_7b(
   num_hidden_layers=8, ...)`` (GQA 32:8, FFN 14336, the 4096-token
   sliding window), batch 2 x 8192: K6, K2 and K3 once per layer and
   step, K1 never.
7. ``packed``: that model three steps by hand on packed documents
   (lengths 128-4096 from a seed filling each 8192-token row, C=1
   ``attn_mask_startend_row_indices``, position ids restarting at each
   document); then at 2 layers one packed row of three documents against
   each document run alone, summed token NLL.
8. ``mistral_path``: 2 Mistral layers at B 1 x S 4096, the window cut to
   1024, through the kernels and through the plain versions: the losses
   must agree.
9. ``gpt``: ``Model.train_batch_loop`` over ``GPTForCausalLM(GPTConfig.
   gpt3_1_3b(dtype="bfloat16"))`` at full width and depth (24 layers,
   1.419 B parameters), 10 steps of batch 8 x 2048 with rows
   right-padded to 1024-2048 tokens (the bool key mask, labels -100 on
   the padding), hidden and attention dropout 0.1, ``AdamW(1e-4,
   multi_precision=True)``: K1 = K2 = K3 = 24 x steps, every launch in
   the segment and dropout arms, K6 never, K4 once per step, no plain
   call; the first loss within 0.5 of ln V + s2/2 and falling.
10. ``gpt_path``: 2 GPT layers at batch 8 x 2048 through the kernels and
   through the plain versions, dropout on and the same seeds: the
   losses must agree.
11. ``fit``: ``Model.fit`` over ``LlamaForCausalLM(LlamaConfig.
   llama2_7b(num_hidden_layers=20, recompute=True,
   fuse_linear_cross_entropy=True))`` built in float32 and passed through
   ``amp.decorate(level="O2")``, with ``prepare(amp_configs=O2)``,
   LLaMA-2's AdamW (beta 0.9/0.95, eps 1e-5, weight decay 0.1,
   ``ClipGradByGlobalNorm(1.0)``, ``LinearWarmup(CosineAnnealingDecay)``
   warming up over 3 steps to 3e-4 and decaying towards 3e-5) and a
   ``DataLoader(TensorDataset)`` of random rows, batch 4 x 2048, 10
   steps: K1 = 2 x 20 x steps (forward and recompute), K2 = K3 = 20 x
   steps, K4 = steps, no plain call; the learning rates the schedule's,
   the clip factor below 1 on the first 3 steps, the losses finite,
   starting near ln V + s2/2 and falling; tokens/s, step p50, MFU (the
   model's FLOPs only) and peak memory. Then 2 layers at hidden 1024
   (``master_grad``, ``L1Decay``): 3 steps, ``Model.save``, a fresh
   ``Model.load``, 3 more equal 6 uninterrupted steps bit for bit; and
   2 layers at full width, LLaMA (recompute full, core_attn, full_attn
   and offload) and GPT (dropout 0.1): losses and every gradient
   bit-equal to recompute off.
12. ``full_attn``: the ``fit`` run with ``recompute_granularity=
   "full_attn"``: each layer's attention output tagged
   (``mark_saveable``), its ``out`` and ``lse`` kept for backward, so K1
   = 20 x steps (``fit``: 2 x), K2 = K3 = 20 x steps, no plain call; the
   losses equal ``fit``'s step for step; tokens/s, step p50, MFU and the
   peak against ``fit``'s and the stash (out bf16 + lse a layer).
13. ``offload``: ``fit`` at 8 layers with full recompute and with
   ``recompute(offload=True)`` (the matrix products' outputs kept): the
   losses equal, K1 = 2 x 8 x steps in both; peak and tokens/s of each.
14. ``optimizers``: LLaMA-2-7B's width at 8 layers, batch 4 x 2048, O2
   (masters where the optimizer takes ``multi_precision``), clip 1.0:
   SGD, Momentum (Nesterov), Adagrad, RMSProp (centered, momentum),
   Adamax, Adadelta, Lamb, NAdam, RAdam, Rprop and ASGD each 3
   ``train_batch`` steps from the same weights, one ``torch._foreach_*``
   pass a step and no leaf-rule step, finite losses; on a fourth
   batch's grads the foreach pass against the leaf rule on copies of
   the first layer's leaves at lr 1e-2 (bit-equal; Lamb within 1e-3 of
   the step), and a skipped update that the check must reject; the
   step's time (CUDA events)
   beside K4's AdamW at the same depth, the peak. Then LBFGS on the
   extended Rosenbrock function in 1000 dimensions on the card.
15. ``workers``: ``fit`` at 8 layers for 3 steps after CUDA is
   initialised, from ``DataLoader(num_workers=2)`` (forked processes
   over shared memory) and from an ``IterableDataset`` through the
   prefetch thread: losses bit-equal to ``num_workers=0``.
16. ``serve``: ``ServingEngine`` over ``LlamaForCausalLM(LlamaConfig.
   llama2_7b(dtype="bfloat16", use_flash_attention=False))`` at full
   width and depth, random weights from a seed, the bucketed step, every
   step class a CUDA graph (captured in a warm-up of 16 requests that
   ramps every bucket, greedy and sampling), answers 8 requests. Every
   request must finish with its token count; every forward must be a
   graph replay; K5 must have launched layers x forwards times (counted
   per replay) and its plain version never, every prefill chunk through
   the tile form and every decode step through the split form and its
   combine. Each greedy request is held against one dense forward of
   the same model in plain float32 attention over its prompt and its
   tokens: its first token's logits within cosine 0.999, and, teacher-
   forced, each of its tokens the dense argmax wherever the dense top-2
   margin exceeds 0.5. A profile of 3 decode steps gives the step's
   wall, device busy time and kernels.
17. ``ragged``: the same over ``LlamaConfig.mistral_7b`` at full width
   and depth (32 layers, GQA 32:8, FFN 14336, the 4096 window) with the
   unified ragged step (``ragged=True``, 9 lanes, token capacities 8 and
   264, one CUDA graph each) over a 2048-page pool, 8 requests of 48 to
   6300 prompt tokens: at most 2 program classes, one dispatch and one
   fetch a step, K5's split, combine and tile kernels each layers x
   forwards times, the same dense checks (three greedy prompts past the
   window).
18. ``spec``: ``ServingEngine(draft_model=, speculative_k=4)`` over the
   serve phase's LLaMA-2-7B (full width and depth, bf16) and requests:
   with no draft, a self-draft and a 2-layer draft of the same width
   (the bucketed step), then that draft in the ragged step; then float32
   at 2 layers of full width with a self-draft and, ragged, a 1-layer
   draft. Each run warmed up (every class's CUDA graph captured) and
   every request finishing with its count; K5's launches equal what each
   class's dispatches make (the draft's proposal k+1 split-form steps a
   draft layer, the verify step the tile form a layer), each graph
   having captured exactly that; one host fetch a round; both page
   pools back to their allocatable pages. bf16 speculative streams
   equal the plain engine's or depart only within 0.5 of a dense tie
   (counted and printed); float32 streams equal, the self-draft's
   acceptance 1.0. Tokens/s, round p50, rounds, acceptance, fallbacks,
   graphs, K5 per round and peak memory of each run; with ``--profile``
   3 rounds of the 2-layer draft by kernel kind.

19. ``prefix``: ``ServingEngine(prefix_cache=True, host_pool=
   HostPagePool(...))`` over the serve phase's LLaMA-2-7B (full width
   and depth, bf16), two prompt families of one 1024-token shared prompt
   and 8 suffixes of 32-256 tokens, 32 greedy tokens a request, a family
   a wave: without the cache (A, B); with it (A, B: every request but a
   family's first hits the 64 shared pages, the prefill chunks and K5's
   tile launches drop by exactly the chunks the cached pages save, the
   streams equal the cache-off ones or depart at a near-tie, the hit
   requests pass the serve phase's dense checks; then one hit and one
   cold request alone for their TTFTs); with a 2 GiB host pool under a
   139-page pool (A, B, A: B's wave evicts all of A's cached pages,
   which spill, and A's second wave restores them: restored pages > 0,
   every A request hitting its whole chain, no spill dropped, no corrupt
   payload); every pool's address unchanged. Then float32 at 2 layers of
   full width, token for token equal to the cache-off engine: the cache,
   the tier, the ragged step, a 1-layer draft (k 4) and a migration
   (``prefill_only``, ``export_request``, the wire format both ways,
   ``adopt_request`` on an engine holding the shared prompt). Spill and
   restore times and rates beside the host link's, TTFTs, prefill tokens
   and the peak.
20. ``generate``: ``cached_attention``'s K5 call (the static cache as a
   page pool) against its plain version (the JAX package's einsum form)
   at the decode, prefill and speculative-verify shapes of the three
   models below, its int8 and window arms and a float32 prompt, two
   planted faults (a slot written at offset + 1, the window one key too
   wide) rejected, its time at the LLaMA decode shape; then
   ``model.generate`` at full width and depth, bf16, random weights:
   LLaMA-2-7B, batch 8 x 512-token prompts, 128 new tokens, greedy,
   sampled (temperature 0.8, top-k 50, top-p 0.9; one seed twice equal,
   another different), repetition penalty 1.2 + min_new_tokens 16 + eos,
   the int8 cache, beam search (batch 2 x 4 beams, 64 new, length
   penalty 0.6 with eos, and 0 without), speculative decoding (k 4) with
   a self-draft and with a 2-layer draft, and in float32 with a
   self-draft (26 rounds, vanilla greedy's tokens, both unless at a
   float32 tie); Mistral-7B, batch 2 x 4600
   tokens (past the window), 64 new; GPT-3 1.3B, batch 8 x 1024, 128
   new. K5 launches exactly layers x forwards (counted per replay), the
   plain version never, every decode step a CUDA graph replay, one host
   fetch a call (a speculative call one more a round); greedy rows pass
   the serve phase's dense checks (int8 at a margin of 1.0), the best
   beam's dense re-score matches its score and is at least greedy's,
   speculative greedy departs from vanilla greedy only at a near-tie;
   prefill time, decode tokens/s, step p50, graphs and peak memory, and a
   3-step profile of the LLaMA decode step.
21. ``attn_cases``: at GPT-3 1.3B's attention shape (B 2, S 2048, H 16,
   D 128, bf16), the cases outside the kernels' arms: the returned
   probabilities (flash attention's dense route) beside K1's ``out``;
   dropout under a mask that keeps every link (the dense route) against
   K1's dropout arm at the same seed, a seed one off rejected, the kept
   share within 3 sigma of 1 - p; causal ``flash_attn_unpadded`` with
   different q and k boundaries through K6's two FlashMask bands and the
   banded K2/K3, launches exact and no dense call, against their plain
   versions; the rotary embedding of ``incubate.nn.functional`` in bf16
   against its float32 form. The dense route's count must read 0 after
   each training, serving and generate phase.
22. ``quant`` (run before ``attn_cases``): K7, the weight-only GEMM, against
   its plain version on the card at the path's (k, n) (LLaMA-2-7B's
   4096->4096, 4096->11008, 11008->4096, Mistral's 4096->1024, GPT-3
   1.3B's 2048->6144 with its bias, and k 4128, which takes the CUDA-core
   bf16 decode form) and rows 1, 3, 8, 17, 40, 256, 264 and 4096: int8
   and int4, per-channel and grouped scales (64 and 128; 24 and 96 at k
   4128, 24 looking each element's scale up), bf16 (within one bf16
   rounding of the sum, and of the bias add) and float32 (1e-5 of the
   element plus 1e-4 of the RMS); planted faults (int4 nibbles swapped,
   a group's scale from the next column, the last k column dropped)
   must fail; the A8 arm bit for bit. Timed beside its plain version,
   cuBLAS bf16 on the unquantized weight (a yardstick the port never
   calls there) and its bound. A PTQ drive through the A8 arm. Then
   ``ServingEngine(weight_quant="int8")`` and ``"int4"`` over LLaMA-2-7B
   at full width and depth on the serve phase's requests: K7 launched 7
   x layers x forwards (per replay; decode steps the decode form,
   prefill chunks the tile form), its plain version never; the trunk's
   bytes with scales <= 0.51x (int8) and 0.26x (int4) of bf16's; the
   serve phase's dense checks against a float32 model of the quantized
   weights (the codes dequantized as K7 rounds them, then widened). At
   8 layers, the ragged
   step with the int8 cache, the prefix cache and a 2-layer draft
   against the bucketed int8 engine: streams equal but at a dense tie,
   K7's launches per class. Greedy ``generate()`` over int8 LLaMA-2-7B
   (8 x 512, 128 new) and GPT-3 1.3B (8 x 128, 32 new; K7's bias arm):
   exact K5 and K7 counts, the dense checks on that float32 model.

Serving phases report TTFT p50 and max, decode tokens/s (steps with no
prefill chunk), output tokens/s, step time p50 and max and peak memory.

The last lines are the ``kernels`` JSON, the card's name and power limit
as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA device. ``--phases`` runs a subset (a
comma-separated list of the phase names above) and then prints no ``ok``
line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 and
# plain float32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
BF16_TOL = 2e-2   # atol = rtol for bf16 outputs (one bf16 ulp is 2**-8)
F32_TOL = 1e-4    # f32 outputs: summation order only
# flash attention's bf16 out and gradients, element by element:
# |got - want| <= BF16_TOL |want| + FA_ROUNDOFFS * 2**-8 * sigma +
# F32_TOL * RMS(want), sigma the root sum of squares of the products
# summed into that element (the kernels round p, ds and their operands
# to bf16: each product moves by up to 2**-8 of itself)
FA_ROUNDOFFS = 8
LSE_TOL = 1e-4    # lse (float32 in every case): absolute
PAGE_SIZE = 16
HEAD_DIM = 128
KV_POOL_PAGES = 1024


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# the flash-attention kernels on TMA + wgmma, by the name in their SASS
WGMMA_KERNELS = {"K1": "fa_fwd_wgmma_kernel", "K2": "fa_bwd_dq_wgmma_kernel",
                 "K3": "fa_bwd_dkv_wgmma_kernel",
                 "K6": "fa_fwd_stream_wgmma_kernel"}


def hgmma_counts(lib_path):
    """{"K1", "K2", "K3", "K6": HGMMA instructions in that kernel (every
    instantiation, :data:`WGMMA_KERNELS`), "other": HGMMA in the library's
    other kernels} from ``cuobjdump -sass``, or None where the toolkit has
    no cuobjdump."""
    import shutil
    tool = next((str(p) for p in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "cuobjdump"), "/usr/local/cuda/bin/cuobjdump")
        if os.path.exists(p)), None) or shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts = dict.fromkeys((*WGMMA_KERNELS, "other"), 0)
    for fn in sass.split("Function : ")[1:]:
        name = fn.splitlines()[0]
        key = next((k for k, v in WGMMA_KERNELS.items() if v in name),
                   "other")
        counts[key] += fn.count("HGMMA")
    return counts


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


def graph_ms(fn, iters, reps=10):
    """Mean device milliseconds of one ``fn`` call, from a CUDA graph of
    ``reps`` calls replayed ``iters`` times: the launches' device time
    without the host's Python between them (a call whose device time is
    shorter than its host time would otherwise time the host)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters, warmup=1) / reps


# -- ragged paged attention (K5) ---------------------------------------------

def make_case(lanes, *, nh, nkv, dtype, int8=False, window=None,
              pad_tokens=0, pad_lanes=0, seed=0, dev="cuda", d=HEAD_DIM,
              max_pages=4096 // PAGE_SIZE, pool_pages=KV_POOL_PAGES):
    """A token-packed batch over a page pool of ``pool_pages`` pages.
    ``lanes`` = [(context_len, query_len), ...]: each lane's queries are
    its last ``query_len`` positions, its keys sit in randomly ordered
    pages. Padded lanes have context 1 on the scratch page, padding
    tokens follow the real ones, as the engine lays them out; head_dim
    ``d``; page tables ``max_pages`` wide (by default LLaMA-2's 4096
    positions)."""
    import torch
    from paddle_tpu_torch.serving.attention import _token_lanes, quantize_q8
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_lanes = len(lanes) + pad_lanes
    pt = torch.zeros(n_lanes, max_pages, dtype=torch.int32)
    cl = torch.ones(n_lanes, dtype=torch.int32)
    ql = torch.zeros(n_lanes, dtype=torch.int32)
    qoff = torch.zeros(n_lanes, dtype=torch.int32)
    perm = torch.randperm(pool_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    used = 0
    for i, (c, q) in enumerate(lanes):
        n = math.ceil(c / PAGE_SIZE)
        pt[i, :n] = perm[used:used + n]
        used += n
        cl[i], ql[i], qoff[i] = c, q, c - q
    if used > pool_pages - 1:
        raise ValueError("case needs more pages than the pool holds")
    t = int(ql.sum()) + pad_tokens
    shape = (pool_pages, PAGE_SIZE, nkv, d)
    kf = torch.randn(shape, generator=g, device=dev)
    vf = torch.randn(shape, generator=g, device=dev)
    if int8:
        kp, vp = quantize_q8(kf), quantize_q8(vf)
    else:
        kp, vp = kf.to(dtype), vf.to(dtype)
    pt, cl, ql, qoff = (x.to(dev) for x in (pt, cl, ql, qoff))
    lane, pos = _token_lanes(ql, qoff, t)
    return dict(q=torch.randn(t, nh, d, generator=g, device=dev).to(dtype),
                k=kp, v=vp, pt=pt, cl=cl, ql=ql, qoff=qoff, lane=lane,
                pos=pos, window=window, scale=d ** -0.5,
                n_real=t - pad_tokens)


def case_work(c):
    """(bytes, flops) the function needs on this data (bf16 pages, the
    timed cases): q read and the output written once, the page-table
    rows and per-token metadata, each lane's live K/V (the keys some
    token of the lane sees: below its visible end, inside its window)
    read once; 4*D flops per visible (token, query head, key)."""
    q, kp = c["q"], c["k"]
    t, nh, d = q.shape
    per_key = 2 * kp.shape[2] * d * kp.element_size()
    pos, lane, cl = (c[k].tolist() for k in ("pos", "lane", "cl"))
    win = c["window"] or 0
    span = {}
    flops = 0
    for tok in range(t):
        hi = min(pos[tok] + 1, cl[lane[tok]])
        lo = max(0, pos[tok] - win + 1) if win else 0
        flops += 4 * max(0, hi - lo) * nh * d
        a, b = span.get(lane[tok], (hi, 0))
        span[lane[tok]] = (min(a, lo), max(b, hi))
    meta = 4 * (c["pt"].numel() + 3 * len(cl) + 2 * t)
    nbytes = (2 * q.numel() * q.element_size()
              + sum(max(0, b - a) for a, b in span.values()) * per_key
              + meta)
    return nbytes, flops


def bound(nbytes, flops, peak=BF16_FLOPS):
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / peak * 1e3
    return (mem_ms, "bytes") if mem_ms >= op_ms else (op_ms, "operations")


def sdpa_inputs(c):
    """The case (bf16 pages) gathered to a contiguous per-lane cache for
    one ``scaled_dot_product_attention`` call: q [L, H, Smax, D], K/V [L,
    KV, Kmax, D], a boolean mask [L, 1, Smax, Kmax] (causal, the context
    and the window)."""
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
        if c["window"]:
            mask[i, 0, :n] &= kpos[None] > qpos - c["window"]
    return qs, ks, vs, mask


def k5_ratio(got, want, tol):
    """The largest |got - want| / (tol + tol |want|) over the elements:
    an output passes at ratio <= 1."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (tol + tol * w.abs())).max().item()


def k5_faults(dev="cuda"):
    """The plain outputs as a kernel with one fault would give them, and
    what the check holds them against: a split dropped from the combine
    (decode lanes at split boundaries), every key read one page later (the
    same lanes), and the causal limit one key late (a prefill chunk from
    position 0, whose first rows see few keys). Returns (name, got, want,
    rows) triples."""
    import torch
    from paddle_tpu_torch.serving import attention as A

    bf16 = torch.bfloat16
    c = make_case([(511, 1), (257, 1), (777, 1), (40, 1)], nh=32, nkv=32,
                  dtype=bf16, seed=31, dev=dev)
    args = [c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"], c["lane"]]
    kw = dict(scale=c["scale"], window=None)
    want = A.ragged_paged_attention_plain(*args, **kw)
    m, l, acc = A.split_partials_plain(*args, **kw)
    m[0, :, 0] = float("-inf")           # token 0's first split dropped
    dropped = A.combine_splits_plain(m, l, acc, bf16)
    shifted = list(args)
    shifted[3] = torch.roll(c["pt"], -1, dims=1).contiguous()
    paged = A.ragged_paged_attention_plain(*shifted, **kw)
    p = make_case([(256, 256)], nh=32, nkv=32, dtype=bf16, seed=32,
                  dev=dev)
    pargs = [p["q"], p["k"], p["v"], p["pt"], p["cl"], p["pos"], p["lane"]]
    pwant = A.ragged_paged_attention_plain(*pargs, **kw)
    late = list(pargs)
    late[5] = p["pos"] + 1
    causal = A.ragged_paged_attention_plain(*late, **kw)
    return [("a split dropped from the combine", dropped, want),
            ("keys read one page later", paged, want),
            ("the causal limit one key late", causal, pwant)]


def k5_rect(c, rows):
    """The case's lanes as the engine's rectangular [B, S] call: q [B, S,
    H, D] and each row's first position (every lane of the case has
    ``rows`` queries)."""
    t, nh, d = c["q"].shape
    return c["q"].reshape(t // rows, rows, nh, d), c["qoff"]


# a prefix hit's first prefill chunk: the 128-token suffix over the 1024
# cached tokens (context 1152) that other requests wrote
PREFIX_HIT_LANES = [(1152, 128)]

# a mixed step of the ragged phase's Mistral engine: 7 decode lanes (their
# contexts across and past the 4096 window) and a 256-token prefill chunk
# at context 6300, 9 lanes and 264 tokens as the engine packs them
RAGGED_LANES = [(81, 1), (333, 1), (733, 1), (1533, 1), (2133, 1),
                (4533, 1), (5233, 1), (6300, 256)]
RAGGED_CASE_NAME = ("mistral ragged step GQA 32:8 window 4096, 7 decode "
                    "lanes + a 256-token chunk at 6300, T 264, L 9")


def _ragged_case():
    import torch
    return dict(nh=32, nkv=8, dtype=torch.bfloat16, window=4096,
                pad_tokens=1, pad_lanes=1, max_pages=8192 // PAGE_SIZE,
                pool_pages=2048)


def kernel_phase(dev="cuda"):
    """K5 against its plain version at the serving path's shapes and at the
    split form's boundaries, through the token-packed entry (both forms
    and the device-built tile plan) and the engine's rectangular one (one
    form each); planted faults the same comparison must reject; times at
    the engine's decode and prefill shapes for LLaMA-2-7B (MHA) and
    Mistral's GQA 32:8, through the rectangular entry the bucketed step
    calls, and at the ragged step's mixed shape through the token-packed
    entry over a prebuilt plan. Returns the largest bf16 error and the
    timings."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.serving import attention as A

    decode = [(37, 1), (130, 1), (511, 1), (777, 1), (1024, 1),
              (1500, 1), (1800, 1), (2047, 1)]
    prefill = [(1024, 256)]
    mixed = decode[:5] + [(1024, 256), (300, 5)]
    # contexts at and around the 256-key splits, a lane of context 1, a
    # lane using the page table's whole width (4096 keys)
    bounds = [(256, 1), (257, 1), (511, 1), (512, 1), (513, 1), (1, 1),
              (4096, 1)]
    bf16 = torch.bfloat16
    checks = [
        (RAGGED_CASE_NAME, RAGGED_LANES, _ragged_case()),
        ("llama2_7b decode bf16", decode, dict(nh=32, nkv=32, dtype=bf16)),
        ("llama2_7b prefill bf16", prefill,
         dict(nh=32, nkv=32, dtype=bf16)),
        ("llama2_7b prefix-hit chunk: 128 tokens over 1024 cached",
         PREFIX_HIT_LANES, dict(nh=32, nkv=32, dtype=bf16)),
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
        ("split boundaries bf16, padded lanes and tokens", bounds,
         dict(nh=32, nkv=32, dtype=bf16, pad_tokens=5, pad_lanes=2)),
        ("split boundaries GQA window 300 (a split inside a page)", bounds,
         dict(nh=32, nkv=8, dtype=bf16, window=300)),
        ("split boundaries int8 pages window 700", bounds,
         dict(nh=32, nkv=8, dtype=bf16, int8=True, window=700)),
        ("tiles from position 0, runs cut at 64, window 100",
         [(256, 256), (70, 65), (300, 2), (37, 1)],
         dict(nh=32, nkv=8, dtype=bf16, window=100, pad_tokens=3)),
        ("rows with no live key (window 50, positions past the context)",
         [(300, 1), (200, 40)], dict(nh=32, nkv=32, dtype=bf16, window=50)),
        ("head_dim 64 GQA 32:8 mixed bf16 window 100", mixed,
         dict(nh=32, nkv=8, dtype=bf16, window=100, d=64)),
        ("head_dim 64 int8 pages", mixed,
         dict(nh=16, nkv=16, dtype=bf16, int8=True, d=64)),
        ("head_dim 256 (split form alone) GQA 2:1", mixed,
         dict(nh=8, nkv=4, dtype=bf16, d=256, pad_tokens=2)),
    ]
    worst = 0.0
    for i, (name, lanes, kw) in enumerate(checks):
        c = make_case(lanes, seed=i, dev=dev, **kw)
        if name.startswith("rows with no live key"):
            # tokens far past their lane's context: no key in the window
            c["pos"][:c["n_real"]:3] += 1000
        args = (c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"],
                c["lane"])
        kw_a = dict(scale=c["scale"], window=c["window"])
        got = A.ragged_paged_attention_cuda(*args, **kw_a)
        want = A.ragged_paged_attention_plain(*args, **kw_a)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        n = c["n_real"]
        tol = F32_TOL if c["q"].dtype == torch.float32 else BF16_TOL
        ratio = k5_ratio(got[:n], want[:n], tol)
        err = (got[:n].float() - want[:n].float()).abs().max().item()
        if not ratio <= 1.0:
            raise AssertionError(f"{name}: past the tolerance: ratio "
                                 f"{ratio}, max abs err {err}")
        if name.startswith("rows with no live key"):
            dead = (c["pos"][:n] - c["window"] + 1
                    >= c["cl"][c["lane"][:n].long()])
            if not dead.any() or got[:n][dead].abs().max().item() != 0:
                raise AssertionError(f"{name}: rows with no key are not 0")
        if tol == BF16_TOL:
            worst = max(worst, err)
        print(f"kernel check ok: {name}: T={c['q'].shape[0]} "
              f"max_abs_err={err:.3e} ratio {ratio:.3f} (tol {tol})",
              flush=True)
    # the engine's rectangular calls: S = 1 (split form alone) and S = 256
    # (tile form alone)
    for name, lanes, kw, rows in (
            ("rectangular decode B 8 x S 1", decode,
             dict(nh=32, nkv=32, dtype=bf16), 1),
            ("rectangular prefill B 1 x S 256 GQA 32:8", prefill,
             dict(nh=32, nkv=8, dtype=bf16), 256),
            ("rectangular prefill B 2 x S 100 int8 window 64",
             [(700, 100), (150, 100)],
             dict(nh=32, nkv=8, dtype=bf16, int8=True, window=64), 100)):
        c = make_case(lanes, seed=50 + rows, dev=dev, **kw)
        q4, qoff = k5_rect(c, rows)
        rargs = (q4, c["k"], c["v"], c["pt"], c["cl"], qoff)
        kw_a = dict(scale=c["scale"], window=c["window"])
        before = dict(A.stats)
        got = A.paged_attention(*rargs, **kw_a)
        forms = {k_: A.stats[k_] - before[k_] for k_ in
                 ("decode_launches", "tile_launches", "combine_launches")}
        want = A.paged_attention_ref(*rargs, **kw_a)
        ratio = k5_ratio(got, want, BF16_TOL)
        err = (got.float() - want.float()).abs().max().item()
        want_forms = ({"decode_launches": 1, "tile_launches": 0,
                       "combine_launches": 1} if rows == 1 else
                      {"decode_launches": 0, "tile_launches": 1,
                       "combine_launches": 0})
        if not ratio <= 1.0 or forms != want_forms:
            raise AssertionError(f"{name}: ratio {ratio}, launches {forms} "
                                 f"(want {want_forms})")
        worst = max(worst, err)
        print(f"kernel check ok: {name}: max_abs_err={err:.3e} ratio "
              f"{ratio:.3f}, launches {forms}", flush=True)
    for fault, got, want in k5_faults(dev):
        ratio = k5_ratio(got, want, BF16_TOL)
        if not ratio > 1.0:
            raise AssertionError(f"the K5 check passes a planted fault: "
                                 f"{fault}: ratio {ratio}")
        print(f"planted fault rejected: K5 {fault}: ratio {ratio:.2f}",
              flush=True)

    timings = {}
    # the speculative verify step: every decode lane with k + 1 = 5 queries
    verify = [(c, SPEC_K + 1) for c, _ in decode]
    for name, lanes, nkv, rows in (("decode", decode, 32, 1),
                                   ("prefill", prefill, 32, 256),
                                   ("decode_gqa", decode, 8, 1),
                                   ("prefill_gqa", prefill, 8, 256),
                                   ("verify", verify, 32, SPEC_K + 1),
                                   ("prefix_hit", PREFIX_HIT_LANES, 32,
                                    PREFIX_HIT_SUFFIX)):
        c = make_case(lanes, nh=32, nkv=nkv, dtype=bf16, seed=100, dev=dev)
        q4, qoff = k5_rect(c, rows)
        rargs = (q4, c["k"], c["v"], c["pt"], c["cl"], qoff)
        args = (c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"],
                c["lane"])
        kw_a = dict(scale=c["scale"], window=None)
        ms = graph_ms(lambda: A.ragged_paged_attention_cuda(
            *args, rows=rows, **kw_a), iters=20)
        call_ms = cuda_ms(lambda: A.paged_attention(*rargs, **kw_a),
                          iters=20)
        plain_ms = cuda_ms(
            lambda: A.ragged_paged_attention_plain(*args, **kw_a),
            iters=3, warmup=1)
        qs, ks, vs, mask = sdpa_inputs(c)
        g = 32 // nkv
        if g > 1:
            ks, vs = (x.repeat_interleave(g, dim=1) for x in (ks, vs))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, scale=c["scale"]), iters=20)
        nbytes, flops = case_work(c)
        bound_ms, bound_by = bound(nbytes, flops)
        timings[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, bytes=nbytes, flops=flops,
                             tokens=c["q"].shape[0], kv_heads=nkv)
        print(f"kernel time {name}: T={c['q'].shape[0]} H 32 KV {nkv}: "
              f"kernel {ms:.4f} ms (the engine's call with its Python "
              f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes} B, {flops} flop)", flush=True)
    # the ragged step's token-packed call: both forms over the plan the
    # engine builds once a step, Mistral's GQA and window
    c = make_case(RAGGED_LANES, seed=100, dev=dev, **_ragged_case())
    args = (c["q"], c["k"], c["v"], c["pt"], c["cl"], c["pos"], c["lane"])
    kw_a = dict(scale=c["scale"], window=c["window"])
    plan = A.tile_plan(c["lane"], A.tile_tokens(4), c["pt"].shape[0])
    ms = graph_ms(lambda: A.ragged_paged_attention_cuda(
        *args, tiles=plan, **kw_a), iters=20)
    plain_ms = cuda_ms(lambda: A.ragged_paged_attention_plain(*args, **kw_a),
                       iters=3, warmup=1)
    qs, ks, vs, mask = sdpa_inputs(c)
    ks, vs = (x.repeat_interleave(4, dim=1) for x in (ks, vs))
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=c["scale"]), iters=20)
    del qs, ks, vs, mask
    nbytes, flops = case_work(c)
    bound_ms, bound_by = bound(nbytes, flops)
    timings["ragged_gqa"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, bytes=nbytes, flops=flops,
        tokens=c["q"].shape[0], kv_heads=8)
    print(f"kernel time ragged_gqa ({RAGGED_CASE_NAME}): kernels "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} "
          "flop)", flush=True)
    print("kernel time K5: the kernels of the engine's [B, S] call "
          "(decode: the split form and its combine; prefill: the tile "
          "form) and of the ragged step's token-packed call (both forms), "
          "and sdpa (on K/V gathered per lane; GQA: repeated to 32 heads) "
          "replayed from CUDA graphs; the [B, S] call with its Python "
          "timed back to back", flush=True)
    return worst, timings


# -- flash attention (K1 forward, K2 dq, K3 dk/dv) ---------------------------

# the training step's attention: batch 4 x 2048 tokens, LLaMA-2-7B heads
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS, TRAIN_STEPS = 4, 2048, 8, 10
FA_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 32, 32, HEAD_DIM)
# (name, (B, S, H, HKV, D), causal, dtype, with dlse)
FA_CHECKS = [
    ("llama2_7b training shape", FA_TRAIN_SHAPE, True, "bfloat16", False),
    ("mistral GQA 32:8", (1, 2048, 32, 8, 128), True, "bfloat16", False),
    ("non-causal", (2, 512, 8, 8, 128), False, "bfloat16", False),
    ("ragged S=200 GQA 4:1", (2, 200, 8, 2, 128), True, "bfloat16", False),
    ("D=64 ragged S=1000 GQA 2:1", (1, 1000, 8, 4, 64), True, "bfloat16",
     False),
    ("D=256", (1, 256, 4, 4, 256), True, "bfloat16", False),
    ("dlse fold", (1, 512, 8, 2, 128), True, "bfloat16", True),
    ("f32 GQA 4:2 D=64 S=300", (1, 300, 4, 2, 64), True, "float32", False),
    ("f32 non-causal dlse", (2, 130, 4, 2, 128), False, "float32", True),
]


def fa_inputs(b, s, h, hkv, d, dtype, seed, dev="cuda"):
    """q, k, v, dO [B,S,*,D] in ``dtype`` and a dlse [B,H,S] float32, all
    N(0, 1) from a seeded generator on ``dev``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=dev).to(dt)
    return (rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d),
            rnd(b, s, h, d), rnd(b, h, s, dt=torch.float32))


def fa_work(b, s, h, hkv, d, causal, itemsize):
    """(bytes, flops) of K1, K2 and K3 on these shapes: each input read
    once and each output written once (lse and delta [B,H,S] float32);
    4*D flops a live (query, key) pair forward (two products), 6*D for
    dq (s, dp, dq), 8*D for dk/dv (s, dp, dv, dk)."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    qo = b * s * h * d * itemsize      # q, o, dO or dq
    kv = b * s * hkv * d * itemsize    # k or v or dk or dv
    rows = 4 * b * h * s               # lse or delta
    return {"fwd": (2 * qo + 2 * kv + rows, 4 * d * pairs),
            "dq": (3 * qo + 2 * kv + 2 * rows, 6 * d * pairs),
            "dkv": (2 * qo + 4 * kv + 2 * rows, 8 * d * pairs)}


FA_NAMES = ("out", "lse", "dq", "dk", "dv")


def fa_term_scales(q, k, v, do, lse, delta, causal, mask=None, fm=(),
                   q_seg=None, kv_seg=None, keep=None):
    """sigma of each element of out, dq, dk and dv: the root sum of
    squares of the products the kernels sum into it (p v, ds k, ds q,
    p dO; under dropout p keep v, ds = p (dp keep - delta), p keep dO), in
    float32 from the plain version's lse and delta, under the same
    masking."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    b, _, h, d = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    sc = d ** -0.5
    kf, vf = (FK._repeat_kv(x, g).float() for x in (k, v))
    qf, dof = q.float(), do.float()
    sco = FK._scores(qf, kf, sc, causal, mask, fm, q_seg, kv_seg)
    p = torch.where(torch.isfinite(sco), torch.exp(sco - lse[..., None]),
                    torch.zeros_like(sco))
    del sco
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if keep is not None:
        dp.mul_(keep)
    ds = p * (dp.sub_(delta[..., None]))
    del dp
    if keep is not None:
        p.mul_(keep)
    p2, ds2 = p.square_(), ds.square_()

    def kv_sum(x):
        return x.reshape(b, s, h // g, g, d).sum(3)
    return {"out": torch.einsum("bhqk,bkhd->bqhd", p2, vf.square()).sqrt(),
            "dq": torch.einsum("bhqk,bkhd->bqhd", ds2, kf.square()).sqrt()
            * sc,
            "dk": kv_sum(torch.einsum("bhqk,bqhd->bkhd", ds2,
                                      qf.square())).sqrt() * sc,
            "dv": kv_sum(torch.einsum("bhqk,bqhd->bkhd", p2,
                                      dof.square())).sqrt()}


def fa_limits(name, want, sigma):
    """(rtol, atol) of one flash-attention output: lse LSE_TOL absolute;
    float32 tensors F32_TOL; bf16 tensors BF16_TOL of each element plus
    FA_ROUNDOFFS bf16 roundoffs of its sigma (:func:`fa_term_scales`)
    and F32_TOL of the tensor's RMS, so that every element, not only the
    largest, is held to what bf16 operands can move it by."""
    import torch
    if name == "lse":
        return 0.0, LSE_TOL
    if want.dtype == torch.float32:
        return F32_TOL, F32_TOL
    # the floor: float32 roundoff where sigma vanishes (dq's first row:
    # its one product's ds is dp - delta, two float32 sums that cancel)
    rms = want.float().square().mean().sqrt()
    return BF16_TOL, FA_ROUNDOFFS * 2.0 ** -8 * sigma[name] + F32_TOL * rms


def fa_compare(got, want, sigma):
    """{name: (ratio, max abs error)} over matching dicts of tensors;
    ratio = max over elements of |got - want| / (atol + rtol |want|),
    so a tensor passes at ratio <= 1. Where want is -inf (a dead row's
    lse) got must be -inf too."""
    import torch
    out = {}
    for name, w in want.items():
        rtol, atol = fa_limits(name, w, sigma)
        g = got[name].float()
        # equal values (a dead row's -inf lse on both sides) differ by 0
        d = torch.where(g == w.float(), 0.0, (g - w.float()).abs())
        wf = w.float()
        lim = (atol + rtol * torch.where(torch.isfinite(wf), wf.abs(), 0.0)
               ).clamp_min(1e-30)
        out[name] = ((d / lim).max().item(), d.max().item())
    return out


def planted_faults(q, k, v, do, out, lse, grads, tile=64):
    """What the training-shape check must reject: the plain outputs as a
    kernel with one fault would give them. K1 and K2 skipping the last
    k tile; K3 skipping a middle q tile; K3 leaving the last quarter of
    the keys' dk/dv at zero. Causal, float32 math."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    b, s, h, d = q.shape
    g = h // k.shape[2]
    sc = d ** -0.5
    dq, dk, dv = grads
    qf, dof = q.float(), do.float()
    lse = lse.float()
    delta = FK._delta(out, do, None)
    pos = torch.arange(s, device=q.device)

    def probs(rows, keys):
        kr = FK._repeat_kv(k[:, keys], g).float()
        sc_ = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kr) * sc
        live = pos[keys][None] <= pos[rows][:, None]
        p = torch.exp(sc_ - lse[:, :, rows, None]) * live
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, rows],
                          FK._repeat_kv(v[:, keys], g).float())
        return p, p * (dp - delta[:, :, rows, None])

    def kv_sum(x):   # [B, T, H, D] over each kv head's query heads
        return x.reshape(b, x.shape[1], h // g, g, d).sum(3)

    every = slice(0, s)
    last = slice(s - tile, s)
    p, ds = probs(every, last)
    frac = p.sum(-1)                                     # [B, H, S]
    part = torch.einsum("bhqk,bkhd->bqhd", p, FK._repeat_kv(
        v[:, last], g).float())
    skip_k = {
        "out": ((out.float() - part) / (1 - frac).transpose(1, 2)[..., None]
                ).to(out.dtype),
        "lse": lse + torch.log1p(-frac),
        "dq": (dq.float() - torch.einsum(
            "bhqk,bkhd->bqhd", ds, FK._repeat_kv(k[:, last], g).float())
            * sc).to(dq.dtype)}
    mid = slice(s // 2, s // 2 + tile)
    p, ds = probs(mid, every)
    skip_q = {
        "dk": (dk.float() - kv_sum(torch.einsum(
            "bhqk,bqhd->bkhd", ds, qf[:, mid]) * sc)).to(dk.dtype),
        "dv": (dv.float() - kv_sum(torch.einsum(
            "bhqk,bqhd->bkhd", p, dof[:, mid]))).to(dv.dtype)}
    zero = {n: t.clone() for n, t in (("dk", dk), ("dv", dv))}
    for t in zero.values():
        t[:, 3 * s // 4:] = 0
    return [("K1 skips the last k tile", {n: skip_k[n]
                                          for n in ("out", "lse")}),
            ("K2 skips the last k tile", {"dq": skip_k["dq"]}),
            ("K3 skips a middle q tile", skip_q),
            ("K3 leaves the last quarter of keys at zero", zero)]


def fa_phase(dev="cuda"):
    """K1-K3 against their plain versions on the card, element by element
    (:func:`fa_limits`), then timed at the training step's shape. The
    backward kernels get the plain forward's out and lse so that each
    kernel is held against its own plain version alone. At the training
    shape the same comparison must also reject the planted faults of
    :func:`planted_faults`."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fa_kernel as FK

    bf16 = torch.bfloat16
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    readings = {}
    for i, (name, shape, causal, dtype, with_dlse) in enumerate(FA_CHECKS):
        dtype = getattr(torch, dtype)
        q, k, v, do, dlse = fa_inputs(*shape, dtype, seed=i, dev=dev)
        dlse = dlse if with_dlse else None
        out, lse = FK.fa_forward_cuda(q, k, v, causal=causal,
                                      return_lse=True)
        w_out, w_lse = FK.fa_forward_plain(q, k, v, causal=causal,
                                           return_lse=True)
        grads = FK.fa_backward_cuda(q, k, v, w_out, w_lse, do,
                                    causal=causal, dlse=dlse)
        w_grads = FK.fa_backward_plain(q, k, v, w_out, w_lse, do,
                                       causal=causal, dlse=dlse)
        torch.cuda.synchronize()
        got = dict(zip(FA_NAMES, (out, lse) + grads))
        want = dict(zip(FA_NAMES, (w_out, w_lse) + w_grads))
        for n, t in got.items():
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"{name}: kernel {n} not finite")
        sigma = (fa_term_scales(q, k, v, do, w_lse,
                                FK._delta(w_out, do, dlse), causal)
                 if dtype == bf16 else None)
        cmp = fa_compare(got, want, sigma)
        readings[name] = {n: dict(ratio=r, max_abs_err=e)
                          for n, (r, e) in cmp.items()}
        bad = {n: r for n, (r, _) in cmp.items() if not r <= 1.0}
        if bad:
            raise AssertionError(f"{name}: past the tolerance (ratio > 1): "
                                 f"{bad}; readings {readings[name]}")
        if dtype == bf16:
            worst["fwd"] = max(worst["fwd"], cmp["out"][1], cmp["lse"][1])
            worst["dq"] = max(worst["dq"], cmp["dq"][1])
            worst["dkv"] = max(worst["dkv"], cmp["dk"][1], cmp["dv"][1])
        print(f"kernel check ok: flash {name}: B,S,H,HKV,D={shape} "
              f"causal={causal} {str(dtype)[6:]}: "
              + " ".join(f"{n} err {e:.3e} ratio {r:.3f}"
                         for n, (r, e) in cmp.items()), flush=True)
        if shape == FA_TRAIN_SHAPE:
            for fault, tensors in planted_faults(q, k, v, do, w_out, w_lse,
                                                 w_grads):
                r = {n: fa_compare({n: t}, {n: want[n]}, sigma)[n][0]
                     for n, t in tensors.items()}
                readings[name]["planted: " + fault] = r
                if not max(r.values()) > 1.0:
                    raise AssertionError(f"the check passes a planted "
                                         f"fault: {fault}: ratios {r}")
                print(f"planted fault rejected: {fault}: " + " ".join(
                    f"{n} ratio {x:.2f}" for n, x in r.items()), flush=True)
        del q, k, v, do, out, lse, w_out, w_lse, grads, w_grads, got, want
        del sigma
    print(f"flash check limits: bf16 |got - want| <= {BF16_TOL} |want| + "
          f"{FA_ROUNDOFFS} * 2**-8 * sigma (the root sum of squares of the "
          f"element's products) + {F32_TOL} RMS(want); float32 "
          f"{F32_TOL} |want| + {F32_TOL}; lse {LSE_TOL} absolute; ratio = "
          "the largest share of its limit", flush=True)

    # times at the training step's shape (causal bf16, lse on, as the
    # training forward calls K1)
    b, s, h, hkv, d = FA_TRAIN_SHAPE
    q, k, v, do, _ = fa_inputs(*FA_TRAIN_SHAPE, bf16, seed=100, dev=dev)
    out, lse = FK.fa_forward_cuda(q, k, v, causal=True, return_lse=True)
    delta = FK._delta(out, do, None)
    t = {}
    t["fwd"] = cuda_ms(lambda: FK.fa_forward_cuda(
        q, k, v, causal=True, return_lse=True), iters=5)
    t["dq"] = cuda_ms(lambda: FK.fa_dq_cuda(q, k, v, do, lse, delta,
                                            causal=True), iters=5)
    t["dkv"] = cuda_ms(lambda: FK.fa_dkv_cuda(q, k, v, do, lse, delta,
                                              causal=True), iters=5)
    # K2 and K3 write each gradient row once, with no atomics: two calls
    # on the same inputs give the same bits
    once = (FK.fa_dq_cuda(q, k, v, do, lse, delta, causal=True),
            *FK.fa_dkv_cuda(q, k, v, do, lse, delta, causal=True))
    twice = (FK.fa_dq_cuda(q, k, v, do, lse, delta, causal=True),
             *FK.fa_dkv_cuda(q, k, v, do, lse, delta, causal=True))
    torch.cuda.synchronize()
    unequal = [n for n, a, b_ in zip(("dq", "dk", "dv"), once, twice)
               if not torch.equal(a, b_)]
    if unequal:
        raise AssertionError(f"K2/K3 give other bits on a second call: "
                             f"{unequal}")
    print("kernel check ok: K2 and K3 twice at the training shape, the "
          "same bits", flush=True)
    del once, twice
    plain_fwd = cuda_ms(lambda: FK.fa_forward_plain(
        q, k, v, causal=True, return_lse=True), iters=1, warmup=1)
    plain_bwd = cuda_ms(lambda: FK.fa_backward_plain(
        q, k, v, out, lse, do, causal=True), iters=1, warmup=1)
    # the library yardstick: SDPA on the same tensors seen as [B,H,S,D]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=10)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters=5)
    work = fa_work(b, s, h, hkv, d, True, q.element_size())
    rows = {}
    for key, plain_ms, lib_ms in (("fwd", plain_fwd, lib_fwd),
                                  ("dq", plain_bwd, lib_bwd),
                                  ("dkv", plain_bwd, lib_bwd)):
        nbytes, flops = work[key]
        bound_ms, bound_by = bound(nbytes, flops)
        rows[key] = dict(ms=t[key], plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, max_abs_err=worst[key])
        print(f"kernel time flash {key}: B,S,H,HKV,D={FA_TRAIN_SHAPE} causal "
              f"bf16: kernel {t[key]:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes} B, {flops} flop)", flush=True)
    print("kernel time flash: the plain and sdpa backward times compute "
          "dq, dk and dv together", flush=True)
    rows["checks"] = readings
    return rows


# -- the streamed masked forward (K6) and the masked arms of K2/K3 -----------

# Mistral-7B's attention at the training step: batch 2 x 8192 tokens, 32
# query heads over 8 kv heads, its 4096-token window (window_size 4095)
MISTRAL_BATCH, MISTRAL_SEQ, MISTRAL_WINDOW = 2, 8192, 4096
MASKED_TRAIN_SHAPE = (MISTRAL_BATCH, MISTRAL_SEQ, 32, 8, HEAD_DIM)
# cases (a)-(h): B 1, S 4096, the window cut to 1024 so that it bites at
# that length; the training shape itself is checked after them, one batch
# row of the plain versions at a time
MASKED_S, MASKED_WINDOW = 4096, 1024
INT32_MAX = 2 ** 31 - 1
# (name, (B, Sq, Sk, H, HKV, D), dtype, causal, masking)
MASKED_CHECKS = [
    ("(a) window", (1, MASKED_S, MASKED_S, 32, 8, 128), "bfloat16", True,
     "window"),
    ("(b) C=1 documents + window", (1, MASKED_S, MASKED_S, 32, 8, 128),
     "bfloat16", True, "documents"),
    ("(c) C=2 per-head band, dead rows", (1, MASKED_S, MASKED_S, 32, 8, 128),
     "bfloat16", True, "band"),
    ("(d) C=4 two bands", (1, MASKED_S, MASKED_S, 32, 8, 128), "bfloat16",
     False, "two bands"),
    ("(e) mask [B,1,Sq,Sk]", (2, MASKED_S, MASKED_S, 32, 8, 128), "bfloat16",
     True, "mask B1"),
    ("(e) mask [1,H,Sq,Sk]", (1, MASKED_S, MASKED_S, 32, 8, 128), "bfloat16",
     True, "mask 1H"),
    ("(f) causal Sq 1024 Sk 3072", (1, 1024, 3072, 32, 8, 128), "bfloat16",
     True, "none"),
    ("(g) window float32", (1, MASKED_S, MASKED_S, 32, 8, 128), "float32",
     True, "window"),
    ("(h) window D 64", (1, MASKED_S, MASKED_S, 32, 8, 64), "bfloat16", True,
     "window"),
    ("(h) window D 256", (1, MASKED_S, MASKED_S, 32, 8, 256), "bfloat16",
     True, "window"),
]


def window_bands(sk, window, dev, sq=None):
    """The sliding window as FlashMask bands ``[1, 1, Sk]`` int32: each
    query sees itself and the ``window - 1`` keys before it, so key j
    masks the rows from ``j + window - (Sk - Sq)`` on
    (``flashmask_attention``'s fold of ``window_size = window - 1``)."""
    import torch
    sq = sk if sq is None else sq
    start = torch.clamp(torch.arange(sk, dtype=torch.int32, device=dev)
                        + window - (sk - sq), min=0)[None, None]
    return start, torch.full_like(start, INT32_MAX)


def doc_ends(lengths_rows, s, dev):
    """C=1 FlashMask starts ``[B, 1, S]``: the end of key j's document,
    for rows of packed document lengths."""
    import torch
    ends = torch.zeros(len(lengths_rows), 1, s, dtype=torch.int32)
    for b, lengths in enumerate(lengths_rows):
        lo = 0
        for n in lengths:
            ends[b, 0, lo:lo + n] = lo + n
            lo += n
    return ends.to(dev)


def masked_case(kind, b, sq, sk, h, seed, dev):
    """(mask, fm) of one masked check, from a seed."""
    import torch
    g = torch.Generator().manual_seed(seed)
    if kind == "window":
        return None, window_bands(sk, MASKED_WINDOW, dev, sq)
    if kind == "documents":
        lens = [n * sk // 4096 for n in (700, 1500, 1200)]
        ends = doc_ends([lens + [sk - sum(lens)]], sk, dev)
        start, end = window_bands(sk, MASKED_WINDOW, dev)
        return None, (torch.minimum(ends, start), end)
    if kind == "band":
        start = torch.randint(0, sk, (b, h, sk), generator=g,
                              dtype=torch.int32)
        end = start + torch.randint(0, sk // 2, (b, h, sk), generator=g,
                                    dtype=torch.int32)
        start[:, :, :64], end[:, :, :64] = 0, 64   # rows 0..63 see nothing
        return None, (start.to(dev), end.to(dev))
    if kind == "two bands":
        w = sk // 8
        lts = torch.randint(0, sk - w, (b, h, sk), generator=g,
                            dtype=torch.int32)
        lte = lts + torch.randint(1, w, (b, h, sk), generator=g,
                                  dtype=torch.int32)
        uts = torch.randint(sk - w, sk, (b, h, sk), generator=g,
                            dtype=torch.int32)
        return None, tuple(x.to(dev) for x in (lts, lte, uts, uts + w // 8))
    if kind.startswith("mask"):
        shape = (b, 1, sq, sk) if kind == "mask B1" else (1, h, sq, sk)
        m = torch.randn(shape, generator=g)
        m[..., 100:140, :] = float("-inf")     # dead rows
        m[..., :, 300:400] = float("-inf")
        return m.to(dev), ()
    return None, ()


def masked_faults(q, k, v, do, causal, fm, want, tile=64):
    """What the masked checks must reject: the plain outputs as a kernel
    with one fault would give them (case (a) and, for the K3 row fault,
    case (c) with bands that vary by head)."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    def fwd(**kw):
        out, lse = FK.fa_forward_plain(q, k, v, causal=causal,
                                       return_lse=True, **kw)
        return {"out": out, "lse": lse}

    def bwd(names, **kw):
        grads = FK.fa_backward_plain(q, k, v, want["out"], want["lse"], do,
                                     causal=causal, **kw)
        return {n: t for n, t in zip(("dq", "dk", "dv"), grads)
                if n in names}
    faults = []
    if fm[0].shape[1] == 1:          # the window: case (a)
        s = q.shape[1]
        skip = torch.zeros(1, 1, s, s, device=q.device)
        q0 = s // 2
        k0 = q0 - MASKED_WINDOW // 2          # inside the window
        skip[..., q0:q0 + tile, k0:k0 + tile] = float("-inf")
        faults += [
            ("K6 ignores the bands", fwd()),
            ("K6 one column off at the window edge",
             fwd(fm=(fm[0] + 1, fm[1]))),
            ("K6 skips a live tile", fwd(fm=fm, mask=skip)),
            ("K2 and K3 ignore the bands", bwd(("dq", "dk", "dv")))]
    else:                            # per-head bands: case (c)
        h, g = q.shape[2], q.shape[2] // k.shape[2]
        kv_row = torch.arange(h, device=q.device) // g
        faults.append(("K3 takes the kv head's band row",
                       bwd(("dk", "dv"), fm=tuple(x[:, kv_row] for x in fm))))
    return faults


def masked_work(b, sq, sk, h, hkv, d, pairs, itemsize, n_fm=2,
                band_rows=1):
    """(bytes, flops) of K6, K2 and K3 on ``pairs`` live (row, key) pairs:
    each input read once and each output written once, the bands
    (``n_fm`` of ``band_rows`` x Sk int32) with them."""
    qo = b * sq * h * d * itemsize
    kv = b * sk * hkv * d * itemsize
    rows = 4 * b * h * sq
    bands = 4 * n_fm * band_rows * sk
    return {"stream": (2 * qo + 2 * kv + rows + bands, 4 * d * pairs),
            "dq": (3 * qo + 2 * kv + 2 * rows + bands, 6 * d * pairs),
            "dkv": (2 * qo + 4 * kv + 2 * rows + bands, 8 * d * pairs)}


def band_keep(fm, s):
    """The pairs causal attention under the bands ``fm = (start, end)``
    ``[B|1, 1, S]`` keeps: bool ``[B|1, 1, S, S]`` (row r sees key c <= r
    unless start_c <= r < end_c)."""
    import torch
    start, end = fm
    r = torch.arange(s, device=start.device)[:, None]
    c = torch.arange(s, device=start.device)[None, :]
    return (c <= r) & ~((r >= start[..., None, :]) & (r < end[..., None, :]))


def masked_check(name, q, k, v, do, kw, got, want):
    """Holds one masked case's kernel outputs ``got`` against the plain
    versions' ``want`` (dicts over :data:`FA_NAMES`): finite, dead rows
    exactly 0 in out and dq and -inf in the lse, every element within
    :func:`fa_limits`. Returns (readings, {name: (ratio, max abs err)},
    sigma)."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    for n, t in got.items():
        if n != "lse" and not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name}: kernel {n} not finite")
    dead = torch.isneginf(want["lse"])                     # [B, H, Sq]
    n_dead = int(dead.sum())
    if n_dead and not (torch.isneginf(got["lse"][dead]).all()
                       and (got["out"].transpose(1, 2)[dead] == 0).all()
                       and (got["dq"].transpose(1, 2)[dead] == 0).all()):
        raise AssertionError(f"{name}: a dead row is not exactly 0 "
                             "(out, dq) and -inf (lse)")
    sigma = (fa_term_scales(
        q, k, v, do, want["lse"], FK._delta(want["out"], do, None),
        kw["causal"], kw.get("mask"), kw.get("fm", ()), kw.get("q_seg"),
        kw.get("kv_seg"), FK._keep(q, k, kw.get("dropout_p", 0.0),
                                   kw.get("seed")))
             if q.dtype == torch.bfloat16 else None)
    cmp = fa_compare(got, want, sigma)
    readings = {n: dict(ratio=r, max_abs_err=e) for n, (r, e) in cmp.items()}
    readings["dead_rows"] = n_dead
    bad = {n: r for n, (r, _) in cmp.items() if not r <= 1.0}
    if bad:
        raise AssertionError(f"{name}: past the tolerance (ratio > 1): "
                             f"{bad}; readings {readings}")
    return readings, cmp, sigma


def masked_train_cases(dev):
    """(name, fm) of the two band forms the Mistral paths give K6, K2 and
    K3 at MASKED_TRAIN_SHAPE: the window, and the packed phase's
    documents (its rows, numpy seed 3) folded into the window."""
    import numpy as np
    import torch
    s = MASKED_TRAIN_SHAPE[1]
    start, end = window_bands(s, MISTRAL_WINDOW, dev)
    rng = np.random.default_rng(3)
    ends = doc_ends([doc_lengths(rng, s) for _ in range(MISTRAL_BATCH)], s,
                    dev)
    return [(f"Mistral window {MISTRAL_WINDOW}", (start, end)),
            ("packed documents + window", (torch.minimum(ends, start), end))]


def masked_fa_phase(dev="cuda"):
    """K6 and the masked arms of K2/K3 against their plain versions on the
    card, element by element (:func:`fa_limits`), dead rows exact; planted
    faults rejected; then at the Mistral training shape (the window and
    the packed documents) held against the plain versions one batch row
    at a time, and timed beside the bound, the plain version and SDPA's
    memory-efficient backend with the boolean band mask."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    readings = {}
    for i, (name, (b, sq, sk, h, hkv, d), dtype, causal,
            kind) in enumerate(MASKED_CHECKS):
        dtype = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(50 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        q, k, v, do = (rnd(b, sq, h, d), rnd(b, sk, hkv, d),
                       rnd(b, sk, hkv, d), rnd(b, sq, h, d))
        mask, fm = masked_case(kind, b, sq, sk, h, 50 + i, dev)
        kw = dict(causal=causal, mask=mask, fm=fm)
        out, lse = FK.fa_forward_masked_cuda(q, k, v, return_lse=True, **kw)
        w_out, w_lse = FK.fa_forward_plain(q, k, v, return_lse=True, **kw)
        grads = FK.fa_backward_cuda(q, k, v, w_out, w_lse, do, **kw)
        w_grads = FK.fa_backward_plain(q, k, v, w_out, w_lse, do, **kw)
        torch.cuda.synchronize()
        got = dict(zip(FA_NAMES, (out, lse) + grads))
        want = dict(zip(FA_NAMES, (w_out, w_lse) + w_grads))
        readings[name], cmp, sigma = masked_check(name, q, k, v, do, kw,
                                                  got, want)
        print(f"kernel check ok: masked {name}: B,Sq,Sk,H,HKV,D="
              f"{(b, sq, sk, h, hkv, d)} causal={causal} {str(dtype)[6:]}, "
              f"{readings[name]['dead_rows']} dead rows exact: " + " ".join(
                  f"{n} err {e:.3e} ratio {r:.3f}"
                  for n, (r, e) in cmp.items()), flush=True)
        if kind in ("window", "band") and dtype == torch.bfloat16 \
                and d == 128:
            for fault, tensors in masked_faults(q, k, v, do, causal, fm,
                                                want):
                r = {n: fa_compare({n: t}, {n: want[n]}, sigma)[n][0]
                     for n, t in tensors.items()}
                readings[name]["planted: " + fault] = r
                if not max(r.values()) > 1.0:
                    raise AssertionError(f"the check passes a planted "
                                         f"fault: {fault}: ratios {r}")
                print(f"planted fault rejected: {fault}: " + " ".join(
                    f"{n} ratio {x:.2f}" for n, x in r.items()), flush=True)
        del q, k, v, do, out, lse, w_out, w_lse, grads, w_grads, got, want
        del mask, fm, sigma
        torch.cuda.empty_cache()

    # the Mistral training shape (lse on, as training calls K6): the
    # kernels over the whole batch, the plain versions one batch row a
    # call (their [1, 32, 8192, 8192] float32 score tensors are 8.6 GB
    # each; two rows do not fit beside them), compared row by row
    b, s, h, hkv, d = MASKED_TRAIN_SHAPE
    bf16 = torch.bfloat16
    q, k, v, do, _ = fa_inputs(*MASKED_TRAIN_SHAPE, bf16, seed=101, dev=dev)
    worst = {"stream": 0.0, "dq": 0.0, "dkv": 0.0}

    def row(x, i):
        return x[i:i + 1] if x.shape[0] > 1 else x
    for name, fm in masked_train_cases(dev):
        kw = dict(causal=True, mask=None, fm=fm)
        out, lse = FK.fa_forward_masked_cuda(q, k, v, return_lse=True, **kw)
        w_fwd = [FK.fa_forward_plain(
            row(q, i), row(k, i), row(v, i), return_lse=True, causal=True,
            fm=tuple(row(x, i) for x in fm)) for i in range(b)]
        w_out = torch.cat([o for o, _ in w_fwd])
        w_lse = torch.cat([x for _, x in w_fwd])
        del w_fwd
        grads = FK.fa_backward_cuda(q, k, v, w_out, w_lse, do, **kw)
        got_all = dict(zip(FA_NAMES, (out, lse) + grads))
        for i in range(b):
            xs = tuple(row(x, i) for x in (q, k, v, do))
            kw_i = dict(kw, fm=tuple(row(x, i) for x in fm))
            w_grads = FK.fa_backward_plain(*xs[:3], row(w_out, i),
                                           row(w_lse, i), xs[3], **kw_i)
            got = {n: row(t, i) for n, t in got_all.items()}
            want = dict(zip(FA_NAMES, (row(w_out, i), row(w_lse, i))
                            + w_grads))
            label = f"{name}, B,S,H,HKV,D={MASKED_TRAIN_SHAPE} row {i}"
            readings[label], cmp, _ = masked_check(label, *xs, kw_i, got,
                                                   want)
            worst["stream"] = max(worst["stream"], cmp["out"][1],
                                  cmp["lse"][1])
            worst["dq"] = max(worst["dq"], cmp["dq"][1])
            worst["dkv"] = max(worst["dkv"], cmp["dk"][1], cmp["dv"][1])
            print(f"kernel check ok: masked {label} bf16, "
                  f"{readings[label]['dead_rows']} dead rows exact: "
                  + " ".join(f"{n} err {e:.3e} ratio {r:.3f}"
                             for n, (r, e) in cmp.items()), flush=True)
            del w_grads, got, want
            torch.cuda.empty_cache()
        del out, lse, grads, got_all, w_out, w_lse

    # times at the same shape, the window's bands (and K6 alone on the
    # packed documents folded into the window, below)
    (_, fm), (_, packed_fm) = masked_train_cases(dev)
    out, lse = FK.fa_forward_masked_cuda(q, k, v, causal=True,
                                         return_lse=True, fm=fm)
    delta = FK._delta(out, do, None)
    t = {"stream": cuda_ms(lambda: FK.fa_forward_masked_cuda(
             q, k, v, causal=True, return_lse=True, fm=fm), iters=5),
         "dq": cuda_ms(lambda: FK.fa_dq_cuda(q, k, v, do, lse, delta,
                                             causal=True, fm=fm), iters=3),
         "dkv": cuda_ms(lambda: FK.fa_dkv_cuda(q, k, v, do, lse, delta,
                                               causal=True, fm=fm), iters=3)}
    # the plain version one batch row a call, the rows in one timed run
    rows_ = [tuple(x[i:i + 1] for x in (q, k, v, do, out)) + (lse[i:i + 1],)
             for i in range(b)]
    plain_fwd = cuda_ms(lambda: [FK.fa_forward_plain(
        q1, k1, v1, causal=True, return_lse=True, fm=fm)
        for q1, k1, v1, *_ in rows_], iters=1, warmup=1)
    plain_bwd = cuda_ms(lambda: [FK.fa_backward_plain(
        q1, k1, v1, o1, l1, do1, causal=True, fm=fm)
        for q1, k1, v1, do1, o1, l1 in rows_], iters=1, warmup=1)
    t["stream_packed"] = cuda_ms(lambda: FK.fa_forward_masked_cuda(
        q, k, v, causal=True, return_lse=True, fm=packed_fm), iters=5)
    plain_packed = cuda_ms(lambda: [FK.fa_forward_plain(
        q1, k1, v1, causal=True, return_lse=True,
        fm=tuple(row(x, i) for x in packed_fm))
        for i, (q1, k1, v1, *_) in enumerate(rows_)], iters=1, warmup=1)
    del rows_
    torch.cuda.empty_cache()
    # the live pairs of each band form and SDPA's bool mask for it (the
    # window's bands, [1, 1, S], hold for every batch row)
    keep = band_keep(fm, s)
    pairs = b * h * int(keep.sum())
    lib = library_band_ms(q, k, v, do, keep)
    keep = band_keep(packed_fm, s)
    packed_pairs = h * int(keep.sum())
    lib_packed = library_band_ms(q, k, v, do, keep, bwd=False)
    del keep
    work = masked_work(b, s, s, h, hkv, d, pairs, q.element_size())
    work["stream_packed"] = masked_work(b, s, s, h, hkv, d, packed_pairs,
                                        q.element_size(),
                                        band_rows=b)["stream"]
    rows = {}
    for key, plain_ms, lib_ms, what, n in (
            ("stream", plain_fwd, lib["fwd"], f"window {MISTRAL_WINDOW}",
             pairs),
            ("dq", plain_bwd, lib["bwd"], f"window {MISTRAL_WINDOW}", pairs),
            ("dkv", plain_bwd, lib["bwd"], f"window {MISTRAL_WINDOW}",
             pairs),
            ("stream_packed", plain_packed, lib_packed["fwd"],
             "packed documents + window", packed_pairs)):
        nbytes, flops = work[key]
        bound_ms, bound_by = bound(nbytes, flops)
        rows[key] = dict(ms=t[key], plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                         flops=flops, pairs=n,
                         max_abs_err=worst[key.split("_")[0]])
        print(f"kernel time masked {key}: B,S,H,HKV,D={MASKED_TRAIN_SHAPE} "
              f"causal {what} bf16: kernel {t[key]:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} flop, "
              f"{n} live pairs)", flush=True)
    print("kernel time masked: max_abs_err is the largest at the training "
          "shape; the plain version runs one batch row a call; the plain "
          "and sdpa backward times compute dq, dk and dv together; "
          + lib["note"], flush=True)
    rows["checks"] = readings
    return rows


def library_band_ms(q, k, v, do, keep, bwd=True):
    """SDPA's memory-efficient backend with the boolean mask ``keep``
    (``[S, S]`` or ``[B, 1, S, S]``, True where a pair is kept) on the
    same tensors seen as [B,H,S,D] (K/V repeated to the query heads):
    forward and (``bwd``) backward ms, the yardstick the port never
    calls. None where the backend refuses the shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep), iters=3)
            bwd_ms = None
            if bwd:
                out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     attn_mask=keep)
                dot = do.transpose(1, 2)
                bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), iters=2)
        return {"fwd": fwd, "bwd": bwd_ms,
                "note": "sdpa = the memory-efficient backend with the "
                        "bool band mask, K/V repeated to 32 heads"}
    except RuntimeError as e:   # the yardstick only: the port never calls it
        return {"fwd": None, "bwd": None,
                "note": f"sdpa's memory-efficient backend refused: {e}"}


# -- the segment-id and counter-hash dropout arms of K1-K3 and K6 ------------

# GPT-3 1.3B's attention at its training step: batch 8 x 2048 tokens, 16
# heads of 128, right-padded rows of 1024-2048 tokens, attention dropout 0.1
GPT_BATCH, GPT_SEQ, GPT_STEPS, GPT_DROPOUT = 8, 2048, 10, 0.1
GPT_HEADS = 16
DROPSEG_TRAIN_SHAPE = (GPT_BATCH, GPT_SEQ, GPT_HEADS, GPT_HEADS, HEAD_DIM)
DROP_SEED = 2 ** 31 - 2
# (name, (B, Sq, Sk, H, HKV, D), dtype, causal, segments, dropout p)
DROPSEG_CHECKS = [
    ("(a) GPT shape, right padding, p 0.1",
     (GPT_BATCH, GPT_SEQ, GPT_SEQ, GPT_HEADS, GPT_HEADS, 128), "bfloat16",
     True, "padding", GPT_DROPOUT),
    ("(a) GPT shape float32",
     (GPT_BATCH, GPT_SEQ, GPT_SEQ, GPT_HEADS, GPT_HEADS, 128), "float32",
     True, "padding", GPT_DROPOUT),
    ("(b) GQA 32/8, packed ids out of order, p 0.1",
     (1, 2048, 2048, 32, 8, 128), "bfloat16", True, "packed", GPT_DROPOUT),
    ("(c) rows with no live key, p 0.1", (1, 1024, 1024, 8, 2, 128),
     "bfloat16", True, "dead rows", GPT_DROPOUT),
    ("(c) rows with no live key, float32 D 64", (1, 1024, 1024, 4, 2, 64),
     "float32", True, "dead rows", GPT_DROPOUT),
    ("(d) cross-length unpadded (K6)", (1, 1920, 3072, 16, 16, 128),
     "bfloat16", False, "unpadded", 0.0),
    ("D 256 padding, p 0.1", (2, 512, 512, 4, 4, 256), "bfloat16", True,
     "padding", GPT_DROPOUT),
]
UNPADDED_Q_LENS, UNPADDED_K_LENS = (300, 700, 900), (1000, 1100, 900)


def padded_lengths(batch, seq, seed):
    """Row lengths of a right-padded batch: from seq/2 to seq, numpy
    seed."""
    import numpy as np
    return np.random.default_rng(seed).integers(seq // 2, seq + 1,
                                                batch).tolist()


def dropseg_segments(kind, b, sq, sk, seed, dev):
    """(q_seg, kv_seg) int32 of one check: right padding as the bool key
    mask encodes it (queries 0, keys 0 / -2); packed documents whose ids
    run in a shuffled order (the kernels assume no order); packed with
    rows 300-339 in no document (-1); flash_attn_unpadded's padded
    layout."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.functional import _segments_of
    rng = np.random.default_rng(seed)
    if kind == "padding":
        lens = torch.tensor(padded_lengths(b, sk, seed), device=dev)
        ks = torch.where(torch.arange(sk, device=dev)[None] < lens[:, None],
                         0, -2).to(torch.int32)
        return torch.zeros(b, sq, dtype=torch.int32, device=dev), ks
    if kind == "unpadded":
        cq = torch.tensor(np.cumsum([0, *UNPADDED_Q_LENS]), device=dev)
        ck = torch.tensor(np.cumsum([0, *UNPADDED_K_LENS]), device=dev)
        return (_segments_of(int(cq[-1]), cq, sq - int(cq[-1]), -1),
                _segments_of(int(ck[-1]), ck, sk - int(ck[-1]), -2))
    lengths = doc_lengths(rng, sq, lo=64, hi=700)
    ids = rng.permutation(len(lengths))
    seg = torch.tensor(np.repeat(ids, lengths), dtype=torch.int32,
                       device=dev)[None].repeat(b, 1)
    q_seg = seg.clone()
    if kind == "dead rows":
        q_seg[:, 300:340] = -1
    return q_seg, seg


def dropseg_faults(q, k, v, do, kw, want, tile=64):
    """The plain outputs as a kernel with one fault would give them: the
    keep mask one column off, the segment test ignored, a live tile
    skipped as dead, dropout applied to l (case (a)); K3 hashing with the
    kv head's index (case (b), GQA)."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    b, s, h, d = q.shape
    g = h // k.shape[2]
    p, seed = kw["dropout_p"], kw["seed"]
    heads = torch.arange(h, device=q.device)[:, None, None]

    def keep_at(head_of, k0=0):
        return torch.stack([FK.keep_scale(seed, bi * h + head_of(heads), 0,
                                          k0, s, s, p, q.device)
                            for bi in range(b)])

    def with_keep(keep, fn):
        real = FK._keep
        FK._keep = lambda *a: keep
        try:
            return fn()
        finally:
            FK._keep = real

    def fwd(**over):
        out, lse = FK.fa_forward_plain(q, k, v, return_lse=True,
                                       **{**kw, **over})
        return {"out": out, "lse": lse}
    if g > 1:
        kv_keep = keep_at(lambda x: x // g)
        grads = with_keep(kv_keep, lambda: FK.fa_backward_plain(
            q, k, v, want["out"], want["lse"], do, **kw))
        return [("K3 hashes with the kv head's index",
                 {"dk": grads[1], "dv": grads[2]})]
    off = keep_at(lambda x: x, k0=1)
    skip = torch.zeros(1, 1, s, s, device=q.device)
    skip[..., s // 2:s // 2 + tile, s // 4:s // 4 + tile] = float("-inf")
    # l summed over the dropped p: the kept share renormalised to 1
    sc = FK._scores(q, FK._repeat_kv(k, g), d ** -0.5, kw["causal"],
                    q_seg=kw["q_seg"], kv_seg=kw["kv_seg"])
    m = sc.amax(-1, keepdim=True)
    pr = torch.exp(sc - torch.where(torch.isfinite(m), m, 0.0)).nan_to_num(
        0.0) * FK.keep_bhqk(seed, b, h, s, s, p, q.device)
    del sc
    ld = pr.sum(-1, keepdim=True)
    out_l = torch.einsum("bhqk,bkhd->bqhd", (pr / ld.clamp_min(1e-30)).to(
        q.dtype), FK._repeat_kv(v, g)).contiguous()
    lse_l = (m + torch.log(ld.clamp_min(1e-30)))[..., 0]
    del pr
    return [("the keep mask one column off",
             with_keep(off, lambda: fwd())),
            ("the segment test ignored", fwd(q_seg=None, kv_seg=None)),
            ("a live tile skipped as dead", fwd(mask=skip)),
            ("dropout applied to l", {"out": out_l, "lse": lse_l})]


def keep_probes(dev="cuda"):
    """The keep pattern read straight off the kernels, bit for bit
    against ``keep_scale``, at B 2, S 2048, H 8 over 2 kv heads, D 128,
    non-causal, p 0.1, in bf16 and float32. q = 0 and segments ``(r +
    shift) // 128`` (shift 0, and 64 so that segments straddle the
    kernels' tiles) make every live probability 1 (lse and delta passed
    as 0 to K2/K3, the scale 1):
      K1: v[c] one-hot at c % 128, so out[r, h, c % 128] = keep(h, r, c)
          * s / n, n the segment's length (a power of two);
      K2: k[c] one-hot at c % 128, dO = 1 and v as for K1, so dp = 1, ds
          = keep * s and dq[r, h, c % 128] = keep(h, r, c) * s;
      K3: dO[r] one-hot at r % 128 on query head g0 of each group only,
          so dv[c, hk, r % 128] = keep(hk G + g0, r, c) * s: the query
          head's own index, for g0 = 0 and G - 1.
    Returns the number of links read and compared."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    b, s, h, hkv, d = 2, 2048, 8, 2, 128
    g = h // hkv
    links = 0
    pos = torch.arange(s, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        for shift in (0, 64):
            seg_1 = ((pos + shift) // 128).to(torch.int32)
            seg = seg_1[None].repeat(b, 1).contiguous()
            same = (seg_1[:, None] == seg_1[None, :]).float()    # [S, S]
            n = same.sum(-1)                                     # [S]
            keep = FK.keep_bhqk(DROP_SEED, b, h, s, s, GPT_DROPOUT, dev)
            kd = keep.to(dtype).float() * same                   # as rounded
            del keep
            onehot = torch.zeros(s, d, device=dev)
            onehot[pos, pos % d] = 1
            z = torch.zeros(b, s, h, d, dtype=dtype, device=dev)
            kv1 = onehot[None, :, None, :].expand(b, s, hkv, d).to(
                dtype).contiguous()
            kw = dict(q_seg=seg, kv_seg=seg, dropout_p=GPT_DROPOUT,
                      seed=DROP_SEED)
            out = FK.fa_forward_cuda(z, kv1, kv1, **kw)
            want = kd.reshape(b, h, s, s // d, d).sum(3)
            got = {"K1 out": (out.permute(0, 2, 1, 3).float(),
                              want / n[:, None])}
            zero = torch.zeros(b, h, s, device=dev)
            ones = torch.ones(b, s, h, d, dtype=dtype, device=dev)
            dq = FK.fa_dq_cuda(z, kv1, kv1, ones, zero, zero, scale=1.0,
                               **kw)
            got["K2 dq"] = (dq.permute(0, 2, 1, 3).float(), want)
            for g0 in (0, g - 1):
                do = torch.zeros(b, s, h, d, dtype=dtype, device=dev)
                do[:, :, g0::g] = onehot[None, :, None, :].to(dtype)
                _, dv = FK.fa_dkv_cuda(z, kv1, kv1, do, zero, zero,
                                       scale=1.0, **kw)
                wdv = kd[:, g0::g].transpose(-1, -2).reshape(
                    b, hkv, s, s // d, d).sum(3)
                got[f"K3 dv (query head {g0} of each group)"] = (
                    dv.permute(0, 2, 1, 3).float(), wdv)
            torch.cuda.synchronize()
            for name, (x, w) in got.items():
                if not torch.equal(x, w):
                    bad = (x != w).nonzero()[:4].tolist()
                    raise AssertionError(
                        f"keep probe {name} ({str(dtype)[6:]}, shift "
                        f"{shift}): {int((x != w).sum())} elements differ "
                        f"from keep_scale, first at [b, h, row, col % 128] "
                        f"{bad}")
                links += int(same.sum()) * (x.shape[0] * x.shape[1])
            print(f"keep probe exact: {str(dtype)[6:]}, segments shifted "
                  f"by {shift}: " + ", ".join(got), flush=True)
            del kd, got, out, dq, dv, do, z, kv1, ones
    return links


def dropseg_pairs(lengths, s):
    """Live (row, key) pairs of one head under causal attention over
    right-padded rows: row r of a row of length n sees min(r + 1, n)
    keys."""
    return sum(sum(min(r + 1, n) for r in range(s)) for n in lengths)


def dropseg_work(b, sq, sk, h, hkv, d, pairs, itemsize):
    """(bytes, flops) of K1 (or K6), K2 and K3 on ``pairs`` live pairs:
    :func:`masked_work` with the segment ids ([B, Sq] and [B, Sk] int32)
    in place of the bands; the dropout hash's integer operations are not
    counted (the card's peak table has no integer rate)."""
    work = masked_work(b, sq, sk, h, hkv, d, pairs, itemsize, n_fm=0)
    seg = 4 * b * (sq + sk)
    return {k: (nb + seg, fl) for k, (nb, fl) in work.items()}


def library_dropseg_ms(q, k, v, do, lengths):
    """The yardsticks the port never calls, on the same tensors seen as
    [B,H,S,D]: SDPA's flash backend with dropout_p=0.1, is_causal=True
    (no padding: it takes no mask), and its memory-efficient backend with
    the [B,1,S,S] bool causal-and-padding mask; forward and backward ms
    of each, None where a backend refuses."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    pos = torch.arange(s, device=q.device)
    lens = torch.tensor(lengths, device=q.device)
    mask = ((pos[None, :] <= pos[:, None])[None]
            & (pos[None, None, :] < lens[:, None, None]))[:, None]
    res = {}
    for key, backend, kw in (
            ("dropout", SDPBackend.FLASH_ATTENTION,
             dict(dropout_p=GPT_DROPOUT, is_causal=True)),
            ("segments", SDPBackend.EFFICIENT_ATTENTION,
             dict(attn_mask=mask))):
        try:
            with sdpa_kernel([backend]):
                fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, **kw), iters=5)
                out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
                bwd = cuda_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True), iters=3)
            res[key] = {"fwd": fwd, "bwd": bwd}
        except RuntimeError as e:   # the yardstick only
            res[key] = {"fwd": None, "bwd": None, "refused": str(e)}
    return res


def unpadded_drive(dev="cuda"):
    """``flash_attn_unpadded`` through the entry point a user calls, with
    gradients, the counts set to 0 just before: self-attention packing
    (equal padded totals: K1's segment arm) and cross-length packing (K6's
    segment arm), each then K2 and K3 in their segment arms. Returns the
    counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    from paddle_tpu_torch.ops import fa_kernel as FK

    g = torch.Generator(device=dev).manual_seed(7)

    def rnd(n):
        return torch.randn(n, GPT_HEADS, HEAD_DIM, generator=g, device=dev
                           ).to(torch.bfloat16).requires_grad_()
    cq = torch.tensor(np.cumsum([0, *UNPADDED_Q_LENS]), dtype=torch.int32,
                      device=dev)
    ck = torch.tensor(np.cumsum([0, *UNPADDED_K_LENS]), dtype=torch.int32,
                      device=dev)
    tq, tk = int(cq[-1]), int(ck[-1])
    q, k, v = rnd(tq), rnd(tk), rnd(tk)
    FK.reset_stats()
    out, _ = flash_attn_unpadded(q, q, q, cq, cq, max(UNPADDED_Q_LENS),
                                 max(UNPADDED_Q_LENS), causal=True)
    out.float().square().sum().backward()
    out2, _ = flash_attn_unpadded(q, k, v, cq, ck, max(UNPADDED_Q_LENS),
                                  max(UNPADDED_K_LENS))
    out2.float().square().sum().backward()
    torch.cuda.synchronize()
    counts = dict(FK.stats)
    want = {"fwd_launches": 1, "stream_fwd_launches": 1, "dq_launches": 2,
            "dkv_launches": 2, "seg_arm_launches": 6,
            "drop_arm_launches": 0}
    check_counts(counts, want, "flash_attn_unpadded")
    for name, x in (("out", out), ("out cross", out2), ("dq", q.grad),
                    ("dk", k.grad), ("dv", v.grad)):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"flash_attn_unpadded {name} not finite")
    print(f"unpadded ok: flash_attn_unpadded self-attention causal ({tq} "
          f"tokens in {len(UNPADDED_Q_LENS)} documents) and cross-length "
          f"({tq} against {tk}), with gradients: launches K1 "
          f"{counts['fwd_launches']} K6 {counts['stream_fwd_launches']} K2 "
          f"{counts['dq_launches']} K3 {counts['dkv_launches']}, all in "
          "the segment arm, plain calls 0", flush=True)
    return counts


def dropseg_phase(dev="cuda"):
    """The segment-id and dropout arms of K1-K3 and the segment arm of K6
    against their plain versions on the card, element by element
    (:func:`fa_limits`), dead rows exactly 0; the keep pattern read off
    each kernel bit for bit (:func:`keep_probes`); the planted faults of
    :func:`dropseg_faults` rejected; ``flash_attn_unpadded`` driven with
    exact counts; then timed at GPT's training shape beside the bound,
    the plain versions and SDPA."""
    import torch
    from paddle_tpu_torch.ops import fa_kernel as FK

    readings = {"probe_links": keep_probes(dev)}
    worst = {}
    for i, (name, (b, sq, sk, h, hkv, d), dtype, causal, kind,
            p) in enumerate(DROPSEG_CHECKS):
        dtype = getattr(torch, dtype)
        g = torch.Generator(device=dev).manual_seed(70 + i)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        q, k, v, do = (rnd(b, sq, h, d), rnd(b, sk, hkv, d),
                       rnd(b, sk, hkv, d), rnd(b, sq, h, d))
        q_seg, kv_seg = dropseg_segments(kind, b, sq, sk, 70 + i, dev)
        kw = dict(causal=causal, q_seg=q_seg, kv_seg=kv_seg, dropout_p=p,
                  seed=DROP_SEED - i if p else None)
        if sq != sk:
            out, lse = FK.fa_forward_masked_cuda(
                q, k, v, return_lse=True, causal=causal, q_seg=q_seg,
                kv_seg=kv_seg)
        else:
            out, lse = FK.fa_forward_cuda(q, k, v, return_lse=True, **kw)
        w_out, w_lse = FK.fa_forward_plain(q, k, v, return_lse=True, **kw)
        grads = FK.fa_backward_cuda(q, k, v, w_out, w_lse, do, **kw)
        w_grads = FK.fa_backward_plain(q, k, v, w_out, w_lse, do, **kw)
        torch.cuda.synchronize()
        got = dict(zip(FA_NAMES, (out, lse) + grads))
        want = dict(zip(FA_NAMES, (w_out, w_lse) + w_grads))
        readings[name], cmp, sigma = masked_check(name, q, k, v, do, kw,
                                                  got, want)
        if dtype == torch.bfloat16:
            arm = "stream" if sq != sk else "fwd"
            worst[arm] = max(worst.get(arm, 0.0), cmp["out"][1],
                             cmp["lse"][1])
            worst["dq"] = max(worst.get("dq", 0.0), cmp["dq"][1])
            worst["dkv"] = max(worst.get("dkv", 0.0), cmp["dk"][1],
                               cmp["dv"][1])
        print(f"kernel check ok: dropseg {name}: B,Sq,Sk,H,HKV,D="
              f"{(b, sq, sk, h, hkv, d)} causal={causal} {str(dtype)[6:]} "
              f"p={p}, {readings[name]['dead_rows']} dead rows exact: "
              + " ".join(f"{n} err {e:.3e} ratio {r:.3f}"
                         for n, (r, e) in cmp.items()), flush=True)
        if dtype == torch.bfloat16 and kind in ("padding", "packed") \
                and d == 128:
            for fault, tensors in dropseg_faults(q, k, v, do, kw, want):
                r = {n: fa_compare({n: t}, {n: want[n]}, sigma)[n][0]
                     for n, t in tensors.items()}
                readings[name]["planted: " + fault] = r
                if not max(r.values()) > 1.0:
                    raise AssertionError(f"the check passes a planted "
                                         f"fault: {fault}: ratios {r}")
                print(f"planted fault rejected: {fault}: " + " ".join(
                    f"{n} ratio {x:.2f}" for n, x in r.items()), flush=True)
        del q, k, v, do, out, lse, w_out, w_lse, grads, w_grads, got, want
        del sigma, q_seg, kv_seg
        torch.cuda.empty_cache()
    readings["unpadded"] = unpadded_drive(dev)

    # times at GPT's training shape: the dropout + segment arms of the
    # training path, and the segment arms alone (no dropout); K6's
    # segment arm at case (d)'s cross-length shape
    b, s, h, hkv, d = DROPSEG_TRAIN_SHAPE
    bf16 = torch.bfloat16
    q, k, v, do, _ = fa_inputs(*DROPSEG_TRAIN_SHAPE, bf16, seed=102,
                               dev=dev)
    lengths = padded_lengths(b, s, 70)
    q_seg, kv_seg = dropseg_segments("padding", b, s, s, 70, dev)
    lib = library_dropseg_ms(q, k, v, do, lengths)
    pairs = h * dropseg_pairs(lengths, s)
    work = dropseg_work(b, s, s, h, hkv, d, pairs, q.element_size())
    rows = {}
    for arm, p, lib_key in (("seg_dropout", GPT_DROPOUT, "dropout"),
                            ("seg", 0.0, "segments")):
        kw = dict(causal=True, q_seg=q_seg, kv_seg=kv_seg, dropout_p=p,
                  seed=DROP_SEED if p else None)
        out, lse = FK.fa_forward_cuda(q, k, v, return_lse=True, **kw)
        delta = FK._delta(out, do, None)
        t = {"fwd": cuda_ms(lambda: FK.fa_forward_cuda(
                 q, k, v, return_lse=True, **kw), iters=5),
             "dq": cuda_ms(lambda: FK.fa_dq_cuda(q, k, v, do, lse, delta,
                                                 **kw), iters=5),
             "dkv": cuda_ms(lambda: FK.fa_dkv_cuda(q, k, v, do, lse, delta,
                                                   **kw), iters=5)}
        plain_fwd = cuda_ms(lambda: FK.fa_forward_plain(
            q, k, v, return_lse=True, **kw), iters=1, warmup=1)
        plain_bwd = cuda_ms(lambda: FK.fa_backward_plain(
            q, k, v, out, lse, do, **kw), iters=1, warmup=1)
        torch.cuda.empty_cache()
        for key, plain_ms, lib_ms in (
                ("fwd", plain_fwd, lib[lib_key]["fwd"]),
                ("dq", plain_bwd, lib[lib_key]["bwd"]),
                ("dkv", plain_bwd, lib[lib_key]["bwd"])):
            nbytes, flops = work["stream" if key == "fwd" else key]
            bound_ms, bound_by = bound(nbytes, flops)
            rows[f"{arm}_{key}"] = dict(
                ms=t[key], plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, pairs=pairs, max_abs_err=worst[key])
            print(f"kernel time dropseg {arm} {key}: B,S,H,HKV,D="
                  f"{DROPSEG_TRAIN_SHAPE} causal, rows of {min(lengths)}-"
                  f"{max(lengths)} tokens, p={p}, bf16: kernel "
                  f"{t[key]:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"{lib_ms} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{nbytes} B, {flops} flop, {pairs} live pairs)",
                  flush=True)
        del out, lse, delta
    del q, k, v, do
    torch.cuda.empty_cache()
    # K6's segment arm at case (d)'s shape; the yardstick the
    # memory-efficient SDPA with the [1, 1, Sq, Sk] bool mask
    (_, (b, sq, sk, h, hkv, d), *_) = DROPSEG_CHECKS[5]
    g = torch.Generator(device=dev).manual_seed(103)
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(bf16)
    k, v = (torch.randn(b, sk, hkv, d, generator=g, device=dev).to(bf16)
            for _ in range(2))
    q_seg, kv_seg = dropseg_segments("unpadded", b, sq, sk, 0, dev)
    ms = cuda_ms(lambda: FK.fa_forward_masked_cuda(
        q, k, v, return_lse=True, q_seg=q_seg, kv_seg=kv_seg), iters=5)
    plain_ms = cuda_ms(lambda: FK.fa_forward_plain(
        q, k, v, return_lse=True, q_seg=q_seg, kv_seg=kv_seg), iters=1,
        warmup=1)
    keep = ((q_seg[0][:, None] == kv_seg[0][None, :])
            & (q_seg[0][:, None] >= 0))[None, None]
    try:
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (q, k, v)), attn_mask=keep),
                iters=5)
    except RuntimeError:
        lib_ms = None
    xpairs = h * int(keep.sum())
    nbytes, flops = dropseg_work(b, sq, sk, h, hkv, d, xpairs,
                                 q.element_size())["stream"]
    bound_ms, bound_by = bound(nbytes, flops)
    rows["seg_stream"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              bytes=nbytes, flops=flops, pairs=xpairs,
                              max_abs_err=worst["stream"])
    print(f"kernel time dropseg K6 segments: B,Sq,Sk,H,HKV,D="
          f"{(b, sq, sk, h, hkv, d)} non-causal bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {lib_ms} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by}: {nbytes} B, {flops} flop, {xpairs} live pairs)",
          flush=True)
    print("kernel time dropseg: max_abs_err is the largest over the bf16 "
          "checks; the plain and sdpa backward times compute dq, dk and dv "
          "together; sdpa for dropout is the flash backend with "
          "dropout_p=0.1, is_causal=True and no padding, for segments the "
          "memory-efficient backend with the bool mask " +
          "; ".join(f"{k_}: {x['refused']}" for k_, x in lib.items()
                    if "refused" in x), flush=True)
    rows["checks"] = readings
    return rows


# -- multi-tensor AdamW (K4) -------------------------------------------------

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


def param_shapes(cfg):
    """The shapes of LlamaForCausalLM(cfg)'s parameters, in order."""
    h, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = ((cfg.num_key_value_heads or cfg.num_attention_heads)
          * (h // cfg.num_attention_heads))
    layer = [(h, h), (kv, h), (kv, h), (h, h), (m, h), (m, h), (h, m),
             (h,), (h,)]
    return [(v, h)] + layer * cfg.num_hidden_layers + [(h,), (v, h)]


def adam_leaves(shapes, dtype, master, seed, dev="cuda", misalign=(),
                grad_dtype=None):
    """(params, grads, states) for leaves of ``shapes``; leaf i in
    ``misalign`` lies one element past an aligned address (no 16-byte
    vector access); grads in ``grad_dtype`` (default: the params')."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    params, grads, states = [], [], []
    for i, shp in enumerate(shapes):
        n = math.prod(shp)
        off = 1 if i in misalign else 0

        def rnd(scale=1.0, dt=torch.float32):
            x = torch.empty(n + off, dtype=dt, device=dev)[off:]
            return x.copy_(torch.randn(n, generator=g, device=dev)
                           * scale).view(shp)
        p = rnd(dt=dtype)
        st = {"moment1": rnd(0.1), "moment2": rnd(0.01).abs_()}
        if master:
            st["master"] = p.float()
        params.append(p)
        grads.append(rnd(dt=grad_dtype or dtype))
        states.append(st)
    return params, grads, states


def adam_mismatch(got, want):
    """Where K4's leaves differ from the plain version's, or None: every
    param, master and moment must be EQUAL (K4 rounds each operation as
    the plain version's PyTorch ops do)."""
    import torch
    for i, (p, st, wp, wst) in enumerate(zip(got[0], got[2], want[0],
                                             want[2])):
        for key, a, b in [("param", p, wp)] + [(k, st[k], wst[k])
                                               for k in st]:
            if not torch.equal(a, b):
                diff = (a.float() - b.float()).abs().max().item()
                return f"leaf {i} {key}: max |diff| {diff:.3e}"
    return None


# K4's arms: (name, grad dtype, clip, L1 coefficient). "clip": the
# global-norm factor of ClipGradByGlobalNorm(1.0) over the leaves' grads,
# read by the kernel from device memory, leaf 2 with need_clip False
K4_ARMS = (("clip", None, True, 0.0), ("l1", None, False, 1e-2),
           ("f32_grad", "float32", False, 0.0),
           ("clip_l1_f32_grad", "float32", True, 1e-2))
K4_L1 = 1e-2


def k4_arm_kwargs(grads, clip, l1, unclipped=(2,)):
    """The arm's keyword arguments for K4 and its plain version."""
    from paddle_tpu_torch.nn.clip_grad import ClipGradByGlobalNorm
    if not clip:
        return dict(l1=l1) if l1 else {}
    mask = [i not in unclipped for i in range(len(grads))]
    factor = ClipGradByGlobalNorm(1.0).factor(
        [(None, g) for g, keep in zip(grads, mask) if keep])
    return dict(l1=l1, clip=factor, clip_mask=mask)


def k4_faults(arm, bf16_grads):
    """K4 runs that the check must reject, each (name, arm keywords,
    whether the grads go in as float32 copies): the arm ignored; where
    the clip factor applies, the factor 10 % high and, for bf16 grads,
    the clipped grad not rounded back to bf16 (float32 copies of the
    grads take the kernel's float32 grad arm, which does not round)."""
    if not arm:
        return []
    out = [("the arm ignored", {}, False)]
    if arm.get("clip") is not None:
        out.append(("the clip factor x 1.1",
                    dict(arm, clip=arm["clip"] * 1.1), False))
        if bf16_grads:
            out.append(("the clipped grad not rounded to bf16", arm, True))
    return out


def k4_check(odd, dev, master, decoupled, arm_kw=None, grad_dtype=None):
    """K4 and its plain version over leaves of odd sizes, two steps;
    returns the share of params moved. Raises unless every param,
    master and moment is equal to the plain version's, or if a K4 that
    never wrote the params, ignored the arm or (in the clip arms) took
    the factor 10 % high or did not round the clipped grad would pass."""
    import torch
    from paddle_tpu_torch.ops import adamw_kernel as AK

    dtype = torch.bfloat16 if master else torch.float32

    def leaves():
        return adam_leaves(odd, dtype, master, seed=1, dev=dev,
                           misalign=(1, 4), grad_dtype=grad_dtype)
    got, want = leaves(), leaves()
    before = [p.clone() for p in got[0]]
    arm = arm_kw(got[1]) if arm_kw else {}
    faults = []
    for name, fkw, widen in k4_faults(arm, got[1][0].dtype == torch.bfloat16):
        p, g, st = leaves()
        faults.append((name, (p, [x.float() for x in g] if widen else g,
                              st), fkw))
    for step in (1, 2):
        kw = dict(lr=1e-3 * step, step=step, wd=0.01, decoupled=decoupled,
                  **ADAM)
        AK.adamw_update_cuda(*got, **kw, **arm)
        AK.adamw_update_plain(*want, **kw, **arm)
        for _, f, fkw in faults:
            AK.adamw_update_cuda(*f, **kw, **fkw)
    torch.cuda.synchronize()
    bad = adam_mismatch(got, want)
    if bad:
        raise AssertionError(f"K4 differs from its plain version: {bad}")
    if not adam_mismatch((before,) + got[1:], want):
        raise AssertionError("the K4 check passes params the kernel never "
                             "wrote")
    for name, f, _ in faults:
        if not adam_mismatch(f, want):
            raise AssertionError(f"the K4 check passes a kernel with "
                                 f"{name} ({sorted(arm)})")
    moved = (sum(int((p != b).sum()) for p, b in zip(got[0], before))
             / sum(p.numel() for p in before))
    if moved < 0.1:
        raise AssertionError(f"K4 moved only {moved:.3f} of the params")
    return moved, [name for name, _, _ in faults]


def adamw_phase(cfg, dev="cuda"):
    """K4 against its plain version over leaves of odd sizes (bf16 with
    f32 masters, f32 without; coupled and decoupled decay; then each arm:
    the clip factor from device memory, L1, float32 grads under bf16
    params; two steps), then timed over leaves of the training model's
    shapes, bare and in the arms the training paths run."""
    import torch
    from paddle_tpu_torch.ops import adamw_kernel as AK

    odd = [(7,), (300,), (1000,), (8193,), (3, 4101), (129, 33), (1,)]
    for master, decoupled in ((True, True), (True, False), (False, True),
                              (False, False)):
        moved, _ = k4_check(odd, dev, master, decoupled)
        print(f"kernel check ok: adamw {len(odd)} leaves of odd sizes, "
              f"{'bf16 + f32 master' if master else 'f32'}, "
              f"{'decoupled' if decoupled else 'coupled'} decay, 2 steps: "
              "params, masters and moments equal to the plain version's; "
              f"{100 * moved:.1f} % of the params changed; unwritten "
              "params rejected", flush=True)
    for name, gdt, clip, l1 in K4_ARMS:
        moved, faults = k4_check(
            odd, dev, True, True, grad_dtype=gdt and torch.float32,
            arm_kw=lambda gs, c=clip, l=l1: k4_arm_kwargs(gs, c, l))
        print(f"kernel check ok: adamw arm {name} (bf16 + f32 master, "
              f"grads {gdt or 'bf16'}, clip {'on, leaf 2 unclipped' if clip
              else 'off'}, L1 {l1}), 2 steps: params, masters and moments "
              "equal to the plain version's; rejected: "
              + "; ".join(["unwritten params"] + faults), flush=True)

    shapes = param_shapes(cfg)
    n = sum(math.prod(s) for s in shapes)
    kw = dict(lr=1e-4, step=3, wd=0.01, decoupled=True, **ADAM)
    timed = {}
    # bare (the train phase), clip (the fit phase), clip + L1 + float32
    # grads (the fit phase's resume run): bytes a parameter read and
    # written, grad 2 or 4 B + master, m1, m2 in and out + bf16 param out
    for name, gdt, clip, l1, per in (
            ("bare", None, False, 0.0, 28),
            ("clip", None, True, 0.0, 28),
            ("clip_l1_f32_grad", torch.float32, True, K4_L1, 30)):
        leaves = adam_leaves(shapes, torch.bfloat16, True, seed=2, dev=dev,
                             grad_dtype=gdt)
        arm = k4_arm_kwargs(leaves[1], clip, l1, unclipped=())
        ms = cuda_ms(lambda: AK.adamw_update_cuda(*leaves, **kw, **arm),
                     iters=5)
        plain_ms = cuda_ms(lambda: AK.adamw_update_plain(*leaves, **kw,
                                                         **arm),
                           iters=1, warmup=1)
        factor = arm.get("clip")
        del leaves, arm
        torch.cuda.empty_cache()
        nbytes, flops = per * n, (15 + 3 * clip + 2 * bool(l1)) * n
        bound_ms, bound_by = bound(nbytes, flops, peak=F32_FLOPS)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, bytes=nbytes, flops=flops,
                           factor=None if factor is None
                           else factor.item())
    # the library yardstick over float32 copies of the same leaves:
    # reads p, g, m, v and writes p, m, v, 28 B a parameter, the same
    # total as K4's bf16 param + f32 master (2 + 4 + 4 + 4 read, 2 + 4 +
    # 4 + 4 written) by another split; for the clip arms the fused
    # AdamW's own device-memory grad divisor (grad_scale = 1 / factor)
    g = torch.Generator(device=dev).manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(s, generator=g, device=dev))
          for s in shapes]
    for p in ps:
        p.grad = torch.randn(p.shape, generator=g, device=dev)
    opt = torch.optim.AdamW(ps, lr=1e-4, weight_decay=0.01, fused=True)
    library_ms = cuda_ms(opt.step, iters=3, warmup=1)
    opt.grad_scale = torch.full((), 1 / timed["clip"]["factor"],
                                device=dev)
    library_clip_ms = cuda_ms(opt.step, iters=3, warmup=1)
    del ps, opt
    torch.cuda.empty_cache()
    for name, lib in (("bare", library_ms), ("clip", library_clip_ms),
                      ("clip_l1_f32_grad", library_clip_ms)):
        t = timed[name]
        t.update(library_ms=lib, max_abs_err=0.0)
        print(f"kernel time adamw {name}: {len(shapes)} leaves, {n} params "
              f"(bf16 + f32 master): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, torch AdamW(fused"
              f"{'' if name == 'bare' else ', grad_scale'}) f32 "
              f"{lib:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['bytes']} B)", flush=True)
    base = timed.pop("bare")
    return dict(base, max_abs_err=0.0, params=n, leaves=len(shapes),
                arms=timed)


# -- training ----------------------------------------------------------------

# A random-init model's first loss: logits are h . W with the final
# RMSNorm's output (RMS 1 per element, weight ones) and W ~ N(0, 0.02),
# so each logit is ~ N(0, (0.02^2) * hidden); the cross entropy of
# Gaussian logits of variance s2 over V classes is ~ ln V + s2 / 2.
FIRST_LOSS_TOL = 0.5
PATH_LOSS_TOL = 2e-2   # kernels vs plain versions, bf16, on a loss of ~11
# the fused CE against a float32 head over the same bf16 values: its
# logits to 5e-4 (rounded to bf16 they would be off by up to 2**-9 of
# themselves, ~1e-2 at the largest logits of the init, ~6); the loss by
# no more than those logits can move it (a row's softmax minus its one-
# hot label sums to at most 2 in absolute value) plus 4 float32 ulps at
# ~11; the hidden-state and head gradients (bf16, from a bf16 cotangent)
# to 1e-2 of their norm
HEAD_LOGIT_TOL = 5e-4
HEAD_LOSS_TOL = 4e-6
HEAD_GRAD_TOL = 1e-2


def expected_first_loss(cfg):
    return math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.hidden_size


def train_setup(cfg, dev=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                steps=TRAIN_STEPS):
    """The bench step's objects: the model from seed 0, the criterion
    bound to its head, AdamW(1e-4, multi_precision) under hapi.Model,
    and ``steps`` copies of one batch from a numpy seed."""
    import numpy as np
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    m = Model(model)
    m.prepare(AdamW(1e-4, parameters=model.parameters(),
                    multi_precision=True),
              LlamaPretrainingCriterion(cfg).bind(model))
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return m, np.broadcast_to(ids, (steps,) + ids.shape).copy()


def head_check(m, ids):
    """The fused CE keeps float32 logits: its head's logits, its loss and
    the gradients of the hidden state and head weight on the training
    batch, before the first step, against a float32 head and cross
    entropy over the same bf16 values."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.models.llama import _head_logits

    net = m.network
    net.train()
    ids = torch.as_tensor(ids, device=m.device).long()
    with torch.no_grad():
        hidden = net(ids)
    h = hidden.detach().requires_grad_()
    h._fused_hidden = True
    w = net.lm_head.weight
    hf = h.detach().float().requires_grad_()
    wf = w.detach().float().requires_grad_()
    with torch.no_grad():
        logits = _head_logits(h[:, :-1], w)
        ref_logits = hf[:, :-1] @ wf.T
        logit_err = (logits - ref_logits).abs().max().item()
        logit_rms = ref_logits.square().mean().sqrt().item()
    del logits, ref_logits
    loss = m._loss(h, ids)
    got = torch.autograd.grad(loss, (h, w))
    ref = F.cross_entropy((hf[:, :-1] @ wf.T).flatten(0, 1),
                          ids[:, 1:].flatten())
    want = torch.autograd.grad(ref, (hf, wf))
    gap = abs(loss.item() - ref.item())
    gap_tol = 2 * logit_err + HEAD_LOSS_TOL
    rel = [((a.float() - b).norm() / b.norm()).item()
           for a, b in zip(got, want)]
    print(f"head check: logits max error {logit_err:.3e} (RMS "
          f"{logit_rms:.3f}, tol {HEAD_LOGIT_TOL}); fused CE loss "
          f"{loss.item():.7f}, float32 head {ref.item():.7f}, gap "
          f"{gap:.3e} (tol 2 x logits error + {HEAD_LOSS_TOL} = "
          f"{gap_tol:.3e}); gradient error / norm: hidden {rel[0]:.3e}, "
          f"head {rel[1]:.3e} (tol {HEAD_GRAD_TOL})", flush=True)
    if not (logit_err <= HEAD_LOGIT_TOL and gap <= gap_tol
            and max(rel) <= HEAD_GRAD_TOL):
        raise AssertionError("the fused CE departs from a float32 head")
    return dict(logit_max_err=logit_err, logit_rms=logit_rms,
                loss=loss.item(), ref=ref.item(), gap=gap,
                grad_rel_hidden=rel[0], grad_rel_head=rel[1])


def _counts():
    from paddle_tpu_torch.ops import adamw_kernel, fa_kernel, flash_attention
    return {**fa_kernel.stats, **{f"adamw_{k}": v
                                  for k, v in adamw_kernel.stats.items()},
            **{f"stash_{k}": v
               for k, v in flash_attention.stash_stats.items()}}


def attention_counts(cfg, n):
    """The flash-attention launches ``n`` forward+backward passes of every
    layer must show: K6 with a sliding window (FlashMask), else K1; K2
    and K3 either way; none in a segment or dropout arm."""
    fwd = n * cfg.num_hidden_layers
    k6 = bool(cfg.sliding_window)
    return {"fwd_launches": 0 if k6 else fwd,
            "stream_fwd_launches": fwd if k6 else 0,
            "dq_launches": fwd, "dkv_launches": fwd,
            "seg_arm_launches": 0, "drop_arm_launches": 0}


def check_counts(counts, want, what):
    """Exact launch counts and no plain-version call at all."""
    zero = [k for k in counts if "plain" in k]
    bad = {k: counts[k] for k in want if counts[k] != want[k]}
    bad.update({k: counts[k] for k in zero if counts[k]})
    if bad:
        raise AssertionError(f"{what} counts {counts}: want {want} and 0 "
                             f"for {zero}")


def _reset_counts():
    from paddle_tpu_torch.ops import adamw_kernel, fa_kernel, flash_attention
    fa_kernel.reset_stats()
    adamw_kernel.reset_stats()
    flash_attention.reset_stash_stats()


def train_phase(cfg, smi, dev=None, profile_steps=0, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, steps=TRAIN_STEPS, label="llama2_7b"):
    """The training step at full width and reduced depth: a counted run
    of ``steps`` steps, then a timed one, then synchronised single steps
    for the step time's median."""
    import torch
    from paddle_tpu_torch.models import count_params, flops_per_token

    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    m, xs = train_setup(cfg, dev, batch, seq, steps)
    on_card = m.device.type == "cuda"
    kv = cfg.num_key_value_heads or cfg.num_attention_heads
    print(f"train model: {label} width h={cfg.hidden_size} L={layers} "
          f"heads={cfg.num_attention_heads}/{kv} "
          f"ffn={cfg.intermediate_size} vocab={cfg.vocab_size}, window "
          f"{cfg.sliding_window}, {count_params(cfg) / 1e9:.3f}B params "
          f"bf16 + f32 masters, batch {batch} x {seq}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    head = head_check(m, xs[0])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = m.train_batch_loop([xs], [xs])
    first_wall = time.perf_counter() - t0
    counts = _counts()

    want = {**attention_counts(cfg, steps), "adamw_kernel_launches": steps}
    check_counts(counts, want, "training")
    ls = losses.tolist()
    expect = expected_first_loss(cfg)
    if not all(math.isfinite(x) for x in ls):
        raise AssertionError(f"training losses not finite: {ls}")
    if abs(ls[0] - expect) > FIRST_LOSS_TOL:
        raise AssertionError(f"first loss {ls[0]} is not within "
                             f"{FIRST_LOSS_TOL} of {expect:.4f}")
    if not ls[-1] < ls[0]:
        raise AssertionError(f"loss did not fall: {ls}")
    print(f"train ok: {label}, {steps} steps, losses "
          f"{[round(x, 4) for x in ls]} (first within {FIRST_LOSS_TOL} of "
          f"ln V + s2/2 = {expect:.4f}); launches K1 {counts['fwd_launches']}"
          f" K6 {counts['stream_fwd_launches']} K2 {counts['dq_launches']} "
          f"K3 {counts['dkv_launches']} ({layers} layers x {steps} steps), "
          f"K4 {counts['adamw_kernel_launches']}, plain calls 0", flush=True)

    t0 = time.perf_counter()
    m.train_batch_loop([xs], [xs])
    loop_s = time.perf_counter() - t0
    step_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        m.train_batch([xs[0]], [xs[0]])
        step_s.append(time.perf_counter() - t0)
    step_s.sort()
    tokens = batch * seq
    tok_s = steps * tokens / loop_s
    mfu = flops_per_token(cfg, seq) * tok_s / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    summary = dict(card=smi, layers=layers, batch=batch, seq=seq,
                   steps=steps, losses=ls, counted_run_s=first_wall,
                   loop_s=loop_s, tokens_per_s=tok_s, step_p50_s=step_s[2],
                   step_min_s=step_s[0], step_max_s=step_s[-1], mfu=mfu,
                   peak_mem_gib=peak, launches=counts, head=head)
    print(f"training {label} [{smi}]: {tok_s:.1f} tokens/s over a "
          f"{steps}-step "
          f"train_batch_loop ({loop_s:.3f} s), step p50 {step_s[2]:.4f} s "
          f"(min {step_s[0]:.4f}, max {step_s[-1]:.4f}; 5 synchronised "
          f"train_batch), MFU {100 * mfu:.2f} % of 989 TFLOP/s, peak "
          f"memory {peak if peak is None else round(peak, 2)} GiB",
          flush=True)
    if profile_steps:
        summary["profile"] = trace_steps(
            lambda: m.train_batch([xs[0]], [xs[0]]), profile_steps,
            f"{label} train step (batch {batch} x {seq}, L={layers})", smi)
    return summary


def path_compare_phase(cfg, dev=None, steps=3, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, gpt=False):
    """The same short run through the kernels and through their plain
    versions (the CUDA wrappers patched to the plain ones here; the
    package has no switch for it): the losses must agree. With ``gpt``
    it is GPT's step (:func:`gpt_setup`, the loss in float32): each run
    builds its model from seed 0, so its generator starts in the same
    state and draws the same hidden-dropout masks and attention seeds,
    and the hash gives both paths the same attention keep masks."""
    import gc

    import torch
    from paddle_tpu_torch.ops import adamw_kernel as AK
    from paddle_tpu_torch.ops import fa_kernel as FK

    def run():
        if gpt:
            m, xs, ys, _ = gpt_setup(cfg, dev, batch, seq, steps,
                                     f32_loss=True)
        else:
            m, xs = train_setup(cfg, dev, batch, seq, steps)
            xs, ys = [xs], [xs]
        _reset_counts()
        losses = m.train_batch_loop(xs, ys).tolist()
        counts = _counts()
        del m
        gc.collect()
        torch.cuda.empty_cache()
        return losses, counts

    kernel_losses, kc = run()
    names = ("fa_forward_cuda", "fa_forward_masked_cuda", "fa_backward_cuda")
    saved = [getattr(FK, n) for n in names] + [AK.adamw_update_cuda]
    FK.fa_forward_cuda = FK.fa_forward_masked_cuda = FK.fa_forward_plain
    FK.fa_backward_cuda = FK.fa_backward_plain
    AK.adamw_update_cuda = AK.adamw_update_plain
    try:
        plain_losses, pc = run()
    finally:
        for n, fn in zip(names, saved):
            setattr(FK, n, fn)
        AK.adamw_update_cuda = saved[-1]
    layers = cfg.num_hidden_layers
    n = layers * steps
    check_counts(kc, {**(gpt_counts(cfg, steps) if gpt else
                         attention_counts(cfg, steps)),
                      "adamw_kernel_launches": steps}, "kernel path")
    launched = [k for k in pc if k.endswith("launches") and pc[k]]
    if (launched or pc["plain_fwd_calls"] != n or pc["plain_bwd_calls"] != n
            or pc["adamw_plain_calls"] != steps):
        raise AssertionError(f"plain path counts {pc}")
    diff = max(abs(a - b) for a, b in zip(kernel_losses, plain_losses))
    window = getattr(cfg, "sliding_window", None)
    print(f"path check: {'gpt, dropout 0.1' if gpt else f'window {window}'}"
          f", batch {batch} x {seq}, "
          f"L={layers} full width, {steps} steps: kernels "
          f"{[round(x, 5) for x in kernel_losses]}, plain "
          f"{[round(x, 5) for x in plain_losses]}, max diff {diff:.3e} "
          f"(tol {PATH_LOSS_TOL})", flush=True)
    if not diff <= PATH_LOSS_TOL:
        raise AssertionError(f"kernel path and plain path differ by {diff}")
    return dict(layers=layers, steps=steps, batch=batch, seq=seq,
                window=window, kernel_losses=kernel_losses,
                plain_losses=plain_losses, max_diff=diff)


# -- GPT-3 1.3B training: right-padded rows, hidden and attention dropout ----


def gpt_setup(cfg, dev=None, batch=GPT_BATCH, seq=GPT_SEQ, steps=GPT_STEPS,
              f32_loss=False):
    """GPT's training objects: the model from seed 0 (its generator then
    draws every dropout mask and attention seed), the criterion,
    AdamW(1e-4, multi_precision) under hapi.Model, and ``steps`` copies of
    one right-padded batch from numpy seed 4 (row lengths seq/2 to seq,
    the bool key mask [B, 1, 1, S], labels -100 on the padding). Returns
    (model, inputs, labels, lengths): inputs ``[ids, position ids,
    mask]``, as ``Model`` feeds them positionally. The criterion takes
    the cross entropy in the logits' dtype, as the JAX package's does (a
    bf16 loss, 0.0625 apart at ~11); ``f32_loss`` widens the logits to
    float32 first, for the path comparison."""
    import numpy as np
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=dev, seed=0)
    m = Model(model)
    crit = LlamaPretrainingCriterion(cfg)
    m.prepare(AdamW(1e-4, parameters=model.parameters(),
                    multi_precision=True),
              (lambda logits, labels: crit(logits.float(), labels))
              if f32_loss else crit)
    rng = np.random.default_rng(4)
    lengths = rng.integers(seq // 2, seq + 1, batch)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    keep = np.arange(seq)[None] < lengths[:, None]
    labels = np.where(keep, ids, -100)
    pos = np.broadcast_to(np.arange(seq), (batch, seq))

    def steps_of(x):
        return np.broadcast_to(x, (steps,) + x.shape).copy()
    inputs = [steps_of(ids), steps_of(pos), steps_of(keep[:, None, None])]
    return m, inputs, [steps_of(labels)], lengths.tolist()


def gpt_counts(cfg, n):
    """GPT's launches over ``n`` steps: K1, K2 and K3 once per layer and
    step, every one in both the segment and the dropout arm; K6 never."""
    fwd = n * cfg.num_hidden_layers
    return {"fwd_launches": fwd, "stream_fwd_launches": 0,
            "dq_launches": fwd, "dkv_launches": fwd,
            "seg_arm_launches": 3 * fwd, "drop_arm_launches": 3 * fwd}


def gpt_phase(cfg, smi, dev=None, profile_steps=0, batch=GPT_BATCH,
              seq=GPT_SEQ, steps=GPT_STEPS):
    """GPT-3 1.3B at full width and depth: a counted run of ``steps``
    steps of ``train_batch_loop``, then a timed one, then synchronised
    single steps for the step time's median."""
    import torch
    from paddle_tpu_torch.models.gpt import count_params, flops_per_token

    t0 = time.perf_counter()
    m, xs, ys, lengths = gpt_setup(cfg, dev, batch, seq, steps)
    on_card = m.device.type == "cuda"
    print(f"gpt model: h={cfg.hidden_size} L={cfg.num_hidden_layers} "
          f"heads={cfg.num_attention_heads} ffn={cfg.intermediate_size} "
          f"vocab={cfg.vocab_size}, dropout hidden "
          f"{cfg.hidden_dropout_prob} attention "
          f"{cfg.attention_dropout_prob}, {count_params(cfg) / 1e9:.3f}B "
          f"params bf16 + f32 masters, batch {batch} x {seq} right-padded "
          f"to rows of {lengths}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = m.train_batch_loop(xs, ys)
    first_wall = time.perf_counter() - t0
    counts = _counts()
    check_counts(counts, {**gpt_counts(cfg, steps),
                          "adamw_kernel_launches": steps}, "gpt training")
    ls = losses.tolist()
    expect = expected_first_loss(cfg)
    if not all(math.isfinite(x) for x in ls):
        raise AssertionError(f"gpt losses not finite: {ls}")
    if abs(ls[0] - expect) > FIRST_LOSS_TOL:
        raise AssertionError(f"gpt first loss {ls[0]} is not within "
                             f"{FIRST_LOSS_TOL} of {expect:.4f}")
    if not ls[-1] < ls[0]:
        raise AssertionError(f"gpt loss did not fall: {ls}")
    print(f"gpt ok: {steps} steps, losses {[round(x, 4) for x in ls]} "
          f"(first within {FIRST_LOSS_TOL} of ln V + s2/2 = {expect:.4f}); "
          f"launches K1 {counts['fwd_launches']} K6 "
          f"{counts['stream_fwd_launches']} K2 {counts['dq_launches']} K3 "
          f"{counts['dkv_launches']} ({cfg.num_hidden_layers} layers x "
          f"{steps} steps; segment arm {counts['seg_arm_launches']}, dropout "
          f"arm {counts['drop_arm_launches']}), K4 "
          f"{counts['adamw_kernel_launches']}, plain calls 0", flush=True)

    t0 = time.perf_counter()
    m.train_batch_loop(xs, ys)
    loop_s = time.perf_counter() - t0
    one_x, one_y = [x[0] for x in xs], [y[0] for y in ys]
    step_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        m.train_batch(one_x, one_y)
        step_s.append(time.perf_counter() - t0)
    step_s.sort()
    padded = batch * seq
    real = sum(lengths)
    tok_s = steps * padded / loop_s
    mfu = flops_per_token(cfg, seq) * tok_s / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    summary = dict(card=smi, layers=cfg.num_hidden_layers, batch=batch,
                   seq=seq, steps=steps, lengths=lengths, losses=ls,
                   counted_run_s=first_wall, loop_s=loop_s,
                   tokens_per_s=tok_s, real_tokens_per_s=steps * real / loop_s,
                   step_p50_s=step_s[2], step_min_s=step_s[0],
                   step_max_s=step_s[-1], mfu=mfu,
                   flops_per_token=flops_per_token(cfg, seq),
                   peak_mem_gib=peak, launches=counts)
    print(f"training gpt3_1_3b [{smi}]: {tok_s:.1f} padded tokens/s "
          f"({steps * real / loop_s:.1f} real: {real} of {padded} tokens a "
          f"step) over a {steps}-step train_batch_loop ({loop_s:.3f} s), "
          f"step p50 {step_s[2]:.4f} s (min {step_s[0]:.4f}, max "
          f"{step_s[-1]:.4f}; 5 synchronised train_batch), MFU "
          f"{100 * mfu:.2f} % of 989 TFLOP/s at "
          f"{flops_per_token(cfg, seq) / 1e9:.3f} GFLOP a padded token, "
          f"peak memory {peak if peak is None else round(peak, 2)} GiB",
          flush=True)
    if profile_steps:
        summary["profile"] = trace_steps(
            lambda: m.train_batch(one_x, one_y), profile_steps,
            f"gpt3_1_3b train step (batch {batch} x {seq}, L="
            f"{cfg.num_hidden_layers})", smi)
    return summary


# -- packed documents (FlashMask's startend_row_indices) ---------------------

PACKED_STEPS = 3
DOC_NLL_TOL = 2e-2   # summed token NLL, packed row vs each document alone


def doc_lengths(rng, seq, lo=128, hi=4096):
    """Document lengths in [lo, hi] from ``rng`` that fill ``seq``."""
    out, left = [], seq
    while left > hi + lo:
        n = int(rng.integers(lo, hi + 1))
        out.append(n)
        left -= n
    if left > hi:                    # two documents, each in [lo, hi]
        n = int(rng.integers(lo, left - lo + 1))
        out.append(n)
        left -= n
    return out + [left]


def packed_inputs(rows, vocab, seed, dev):
    """ids, position ids restarting at each document and the C=1
    ``startend_row_indices [B, 1, S, 1]`` int32 (key j's document end),
    for rows of document lengths."""
    import numpy as np
    import torch
    seq = sum(rows[0])
    ids = np.random.default_rng(seed).integers(0, vocab, (len(rows), seq))
    pos = np.zeros((len(rows), seq), np.int64)
    for b, lengths in enumerate(rows):
        lo = 0
        for n in lengths:
            pos[b, lo:lo + n] = np.arange(n)
            lo += n
    idx = doc_ends(rows, seq, "cpu")[..., None]
    return (torch.as_tensor(ids, device=dev), torch.as_tensor(pos, device=dev),
            idx.to(dev))


def packed_phase(cfg, smi, dev=None, batch=MISTRAL_BATCH, seq=MISTRAL_SEQ,
                 steps=PACKED_STEPS):
    """The Mistral step on packed documents, by hand: forward with
    ``attn_mask_startend_row_indices``, the criterion, ``backward()``,
    the optimizer's step, ``clear_grad()`` (``Model._step``'s calls:
    ``Model`` feeds its inputs positionally, so it cannot reach the
    keyword). K6, K2 and K3 must launch once per layer and step."""
    import numpy as np

    m, _ = train_setup(cfg, dev, batch, seq, 1)
    net, crit, opt = m.network, m._loss, m._optimizer
    rng = np.random.default_rng(3)
    rows = [doc_lengths(rng, seq) for _ in range(batch)]
    ids, pos, idx = packed_inputs(rows, cfg.vocab_size, 3, m.device)
    net.train()
    _reset_counts()
    losses = []
    for _ in range(steps):
        loss = crit(net(ids, position_ids=pos,
                        attn_mask_startend_row_indices=idx), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    ls = [float(x) for x in losses]
    counts = _counts()
    check_counts(counts, {**attention_counts(cfg, steps),
                          "adamw_kernel_launches": steps}, "packed")
    if not (all(math.isfinite(x) for x in ls) and ls[-1] < ls[0]):
        raise AssertionError(f"packed losses not finite and falling: {ls}")
    print(f"packed ok: {batch} rows x {seq} tokens of {sum(map(len, rows))} "
          f"documents (lengths {rows}), {steps} steps by hand, losses "
          f"{[round(x, 4) for x in ls]}; launches K6 "
          f"{counts['stream_fwd_launches']} K2 {counts['dq_launches']} K3 "
          f"{counts['dkv_launches']} ({cfg.num_hidden_layers} layers x "
          f"{steps} steps), K1 {counts['fwd_launches']}, plain calls 0",
          flush=True)
    return dict(rows=rows, losses=ls, launches=counts)


def token_nll(logits, ids):
    """-log p(ids[t + 1]) of each position t, float32 ``[S - 1]``."""
    import torch
    lsm = torch.log_softmax(logits[0, :-1].float(), dim=-1)
    return -lsm.gather(-1, ids[0, 1:, None])[:, 0]


def document_phase(cfg, dev=None, lengths=(1500, 2292, 4400)):
    """One packed row of three documents (the last longer than the
    window) through the kernels, in float32: each document's summed token
    NLL (its tokens predicting the next within it) against the same
    document run alone, within DOC_NLL_TOL. The same row with no document
    bounds, where tokens see the documents before theirs, is the planted
    fault: every document after the first must fail the same test."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    ids, pos, idx = packed_inputs([list(lengths)], cfg.vocab_size, 4,
                                  model.device)
    _reset_counts()
    with torch.no_grad():
        packed = token_nll(model(ids, position_ids=pos,
                                 attn_mask_startend_row_indices=idx), ids)
        leaky = token_nll(model(ids, position_ids=pos), ids)
        docs, lo = [], 0
        for n in lengths:
            alone = token_nll(model(ids[:, lo:lo + n]),
                              ids[:, lo:lo + n]).double()
            got = packed[lo:lo + n - 1].double()
            bad = leaky[lo:lo + n - 1].double()
            docs.append(dict(
                tokens=n - 1, alone=alone.sum().item(),
                diff=(got - alone).sum().abs().item(),
                max_token_diff=(got - alone).abs().max().item(),
                leaky_diff=(bad - alone).sum().abs().item(),
                leaky_max_token_diff=(bad - alone).abs().max().item()))
            lo += n
    counts = _counts()
    check_counts(counts, {"stream_fwd_launches": cfg.num_hidden_layers
                          * (2 + len(lengths)), "fwd_launches": 0},
                 "document check")
    print("document check: " + "; ".join(
        f"{d['tokens'] + 1} tokens: summed NLL alone {d['alone']:.4f}, "
        f"packed off by {d['diff']:.3e} (max token {d['max_token_diff']:.2e})"
        f", unbounded row off by {d['leaky_diff']:.3e} (max token "
        f"{d['leaky_max_token_diff']:.2e})" for d in docs)
        + f" (tol {DOC_NLL_TOL} summed)", flush=True)
    bad = [d for d in docs if not d["diff"] <= DOC_NLL_TOL]
    if bad:
        raise AssertionError(f"a packed document departs from itself run "
                             f"alone: {bad}")
    passed = [d for d in docs[1:] if not d["leaky_diff"] > DOC_NLL_TOL]
    if passed:
        raise AssertionError(f"the check passes the row with no document "
                             f"bounds: {passed}")
    return docs


# -- LLaMA pretraining as users run it: Model.fit -----------------------------

# LLaMA-2's recipe (Touvron et al. 2023, sec. 2.2): AdamW beta 0.9/0.95,
# eps 1e-5, weight decay 0.1, global-norm clip 1.0, linear warmup (2000
# steps, cut here to FIT_WARMUP) then cosine decay to 10 % of the peak
FIT_LAYERS, FIT_STEPS, FIT_WARMUP, FIT_PEAK_LR = 20, 10, 3, 3e-4
FIT_EARLY = 3          # steps whose clip factor must be below 1
RESUME_STEPS = 3       # N: N steps, save, load, N more against 2N
RESUME_WIDTH = dict(hidden_size=1024, intermediate_size=2752,
                    num_attention_heads=8)   # head_dim 128, as LLaMA's
RESUME_L1 = 1e-5
RECOMPUTE_BATCH = 2    # rows of the 2-layer recompute comparisons


def fit_schedule(lr_mod, steps, warmup=FIT_WARMUP, peak=FIT_PEAK_LR):
    return lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(peak, steps - warmup, eta_min=peak / 10),
        warmup, 0.0, peak)


def fit_setup(cfg, dev=None, *, l1=0.0, master_grad=False, seed=0):
    """``LlamaForCausalLM(cfg)`` built in float32 from ``seed``, through
    ``amp.decorate(O2, bf16)``; LLaMA-2's AdamW under ``hapi.Model`` with
    ``amp_configs`` O2 (``l1``: ``weight_decay=L1Decay(l1)`` in place of
    the decoupled 0.1)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    from paddle_tpu_torch.regularizer import L1Decay

    net = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=seed),
                       level="O2", dtype="bfloat16", master_grad=master_grad)
    opt = AdamW(fit_schedule(lr, FIT_STEPS), beta1=0.9, beta2=0.95,
                epsilon=1e-5, parameters=net.parameters(),
                weight_decay=L1Decay(l1) if l1 else 0.1,
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    return Model(net, inputs=["input_ids"], labels=["labels"]).prepare(
        opt, LlamaPretrainingCriterion(cfg).bind(net),
        amp_configs={"level": "O2", "dtype": "bfloat16"})


def fit_rows(cfg, batch, seq, steps, seed=0):
    """``steps`` batches of one batch of random token rows from a numpy
    seed (the batch repeats, so the loss falls by memorisation within a
    few steps, as in the train phase)."""
    import numpy as np
    ids = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return np.tile(ids, (steps, 1))


def fit_recorder():
    """A ``hapi`` callback that records each step's learning rate (the
    schedule's float, read before the step), its loss (the float ``fit``
    already fetched), the optimizer's clip factor (a device tensor, read
    once after the loop) and the host clock at the step's end (the loss
    fetch has waited for the step)."""
    import torch
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            super().__init__()
            self.lrs, self.losses, self.factors, self.ends = [], [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(self.model._optimizer.get_lr())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.factors.append(self.model._optimizer._clip_factor)
            self.ends.append(time.perf_counter())

        def on_train_end(self, logs=None):
            self.factors = torch.stack(self.factors).tolist()
    return Recorder()


def run_fit(m, rows, batch, steps, loader=None):
    """``Model.fit`` over ``loader``, by default a ``DataLoader`` of
    ``TensorDataset([rows, rows])`` in order."""
    from paddle_tpu_torch.hapi.callbacks import LRScheduler
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    rec = fit_recorder()
    t0 = time.perf_counter()
    if loader is None:
        loader = DataLoader(TensorDataset([rows, rows]), batch_size=batch,
                            shuffle=False)
    m.fit(loader, epochs=1, verbose=0, num_iters=steps,
          callbacks=[LRScheduler(), rec])
    return rec, t0


@contextlib.contextmanager
def offloaded(on=True):
    """LLaMA's decoder layers recomputed with ``offload=True`` (the
    configuration has no flag for it in either package: a user passes it
    to ``fleet.recompute``)."""
    import functools

    from paddle_tpu_torch.distributed.fleet import recompute
    from paddle_tpu_torch.models import llama
    if not on:
        yield
        return
    llama.recompute = functools.partial(recompute, offload=True)
    try:
        yield
    finally:
        llama.recompute = recompute


def fit_phase(cfg, smi, dev=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              steps=FIT_STEPS, label="fit", offload=False, check_clip=True):
    """``Model.fit`` over LLaMA-2-7B's width at ``cfg``'s depth with
    recompute (``cfg``'s granularity, or ``offload``), decorated O2,
    LLaMA-2's AdamW, clip and schedule, a DataLoader of random rows:
    exact launch counts (K1 twice a layer and step, forward and
    recompute, once under ``full_attn``), the schedule, the clip factor
    (below 1 on the first steps with ``check_clip``), falling losses;
    tokens/s, step p50, MFU (the model's FLOPs only, recompute not
    counted) and peak memory."""
    import torch
    from paddle_tpu_torch.models import count_params, flops_per_token
    from paddle_tpu_torch.optimizer import lr

    layers = cfg.num_hidden_layers
    gran = "offload" if offload else cfg.recompute_granularity
    t0 = time.perf_counter()
    m = fit_setup(cfg, dev)
    on_card = m.device.type == "cuda"
    rows = fit_rows(cfg, batch, seq, steps)
    print(f"{label} model: llama2_7b width h={cfg.hidden_size} L={layers}, "
          f"recompute {gran}, "
          f"{count_params(cfg) / 1e9:.3f}B params built float32, decorated "
          f"O2 bf16 (the float32 originals are the masters), batch {batch} "
          f"x {seq}, {steps} steps, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with offloaded(offload):
        rec, t_start = run_fit(m, rows, batch, steps)
    counts = _counts()
    fwd = layers * steps
    k1 = fwd if gran == "full_attn" else 2 * fwd
    # full_attn: every layer's tag kept its core's result, none missed
    check_counts(counts, {"fwd_launches": k1, "stream_fwd_launches": 0,
                          "dq_launches": fwd, "dkv_launches": fwd,
                          "seg_arm_launches": 0, "drop_arm_launches": 0,
                          "adamw_kernel_launches": steps,
                          "stash_kept": fwd if gran == "full_attn" else 0,
                          "stash_missed": 0}, label)
    want_lrs = []
    sched = fit_schedule(lr, steps)
    for _ in range(steps):
        want_lrs.append(sched())
        sched.step()
    if rec.lrs != want_lrs:
        raise AssertionError(f"fit learning rates {rec.lrs}, schedule "
                             f"{want_lrs}")
    ls, factors = rec.losses, rec.factors
    norms = [1.0 / f if f < 1 else None for f in factors]
    if check_clip and not all(f < 1 for f in factors[:FIT_EARLY]):
        raise AssertionError(
            f"clip factors {factors}: the global norm of the early steps "
            "is not above 1 at this init")
    expect = expected_first_loss(cfg)
    if not all(math.isfinite(x) for x in ls):
        raise AssertionError(f"fit losses not finite: {ls}")
    if abs(ls[0] - expect) > FIRST_LOSS_TOL:
        raise AssertionError(f"first loss {ls[0]} is not within "
                             f"{FIRST_LOSS_TOL} of {expect:.4f}")
    if not ls[-1] < ls[0]:
        raise AssertionError(f"fit loss did not fall: {ls}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    total = (torch.cuda.get_device_properties(0).total_memory / 2 ** 30
             if on_card else None)
    step_s = sorted(b - a for a, b in zip(rec.ends, rec.ends[1:]))
    tokens = batch * seq
    tok_s = (steps - 1) * tokens / (rec.ends[-1] - rec.ends[0])
    mfu = flops_per_token(cfg, seq) * tok_s / BF16_FLOPS
    print(f"{label} ok: {steps} steps, losses {[round(x, 4) for x in ls]} "
          f"(first within {FIRST_LOSS_TOL} of {expect:.4f}); learning "
          f"rates {[float(f'{x:.6g}') for x in rec.lrs]} as the schedule; "
          f"clip factors {[round(f, 5) for f in factors]} (global norms "
          f"{[None if n is None else round(n, 3) for n in norms]}); "
          f"launches K1 {counts['fwd_launches']} ({k1 // fwd} x {layers} "
          f"layers x {steps} steps: forward"
          f"{'' if k1 == fwd else ' and recompute'}), K2 "
          f"{counts['dq_launches']} K3 {counts['dkv_launches']}, K4 "
          f"{counts['adamw_kernel_launches']}, plain calls 0", flush=True)
    print(f"{label} llama2_7b L={layers} recompute {gran} [{smi}]: "
          f"{tok_s:.1f} "
          f"tokens/s over steps 2-{steps} ({rec.ends[-1] - rec.ends[0]:.3f}"
          f" s; the first step took {rec.ends[0] - t_start:.3f} s), step "
          f"p50 {step_s[len(step_s) // 2]:.4f} s (min {step_s[0]:.4f}, max "
          f"{step_s[-1]:.4f}), MFU {100 * mfu:.2f} % of 989 TFLOP/s (the "
          f"model's FLOPs only, recompute not counted), peak memory "
          f"{peak if peak is None else round(peak, 2)} GiB of "
          f"{total if total is None else round(total, 2)}", flush=True)
    del m
    return dict(card=smi, layers=layers, batch=batch, seq=seq, steps=steps,
                losses=ls, lrs=rec.lrs, clip_factors=factors,
                tokens_per_s=tok_s, step_p50_s=step_s[len(step_s) // 2],
                step_min_s=step_s[0], step_max_s=step_s[-1], mfu=mfu,
                peak_mem_gib=peak, card_mem_gib=total, launches=counts,
                first_step_s=rec.ends[0] - t_start)


def resume_phase(cfg, dev=None, batch=RECOMPUTE_BATCH, seq=TRAIN_SEQ,
                 n=RESUME_STEPS):
    """N steps of ``fit``, ``Model.save`` to a temporary directory, a
    fresh model and ``Model.load``, N more steps: bit for bit 2N
    uninterrupted steps (losses and every parameter). Decorated with
    ``master_grad`` (float32 grads) and ``L1Decay`` beside the clip, so
    K4 runs its three arms in one launch a step."""
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.io import Subset, TensorDataset

    rows = fit_rows(cfg, batch, seq, 2 * n, seed=1)
    _reset_counts()
    whole = fit_setup(cfg, dev, l1=RESUME_L1, master_grad=True)
    want = run_fit(whole, rows, batch, 2 * n)[0].losses
    first = fit_setup(cfg, dev, l1=RESUME_L1, master_grad=True)
    got = run_fit(first, rows[:n * batch], batch, n)[0].losses
    tmp = tempfile.mkdtemp(prefix="fit_resume_")
    try:
        first.save(os.path.join(tmp, "ckpt"))
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
        del first
        fresh = fit_setup(cfg, dev, l1=RESUME_L1, master_grad=True)
        fresh.load(os.path.join(tmp, "ckpt"))
    finally:
        shutil.rmtree(tmp)
    got += run_fit(fresh, rows[n * batch:], batch, n)[0].losses
    counts = _counts()
    check_counts(counts, {"adamw_kernel_launches": 4 * n}, "resume")
    if got != want:
        raise AssertionError(f"resumed losses {got} != uninterrupted {want}")
    for (name, a), b in zip(whole.network.state_dict().items(),
                            fresh.network.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"resumed {name} differs from the "
                                 "uninterrupted run's")
    print(f"resume ok: llama h={cfg.hidden_size} L={cfg.num_hidden_layers}"
          f" bf16 (master_grad, L1 {RESUME_L1}, clip 1.0), {n} steps + save"
          f" ({nbytes} bytes written, removed) + load + {n} steps equal "
          f"{2 * n} uninterrupted steps bit for bit, losses "
          f"{[round(x, 5) for x in got]} and every parameter; K4 launches "
          f"{counts['adamw_kernel_launches']}, plain calls 0", flush=True)
    del whole, fresh
    return dict(losses=got, bytes=nbytes, launches=counts)


def recompute_equal_phase(llama_cfg, gpt_cfg, dev=None, seq=TRAIN_SEQ):
    """At 2 layers of full width, one forward and backward with recompute
    off and on (LLaMA "full" and "core_attn"; GPT with dropout 0.1, two
    forwards so the second draws after the first's replay): the losses
    and every gradient bit for bit."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)

    def grads(make, cfg, ids, forwards):
        net = make(cfg, device=dev, seed=0)
        net.train()
        crit = LlamaPretrainingCriterion(cfg)
        if getattr(cfg, "fuse_linear_cross_entropy", False):
            crit.bind(net)
        out = []
        for _ in range(forwards):
            loss = crit(net(ids), ids)
            loss.backward()
            out.append((loss.detach(), {n: p.grad.clone()
                                        for n, p in net.named_parameters()}))
            net.zero_grad(set_to_none=True)
        del net
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def compare(what, a, b):
        for i, ((la, ga), (lb, gb)) in enumerate(zip(a, b)):
            if not torch.equal(la, lb):
                raise AssertionError(f"{what} forward {i}: loss "
                                     f"{la.item()} != {lb.item()}")
            for name in ga:
                if not torch.equal(ga[name], gb[name]):
                    d = (ga[name].float() - gb[name].float()).abs().max()
                    raise AssertionError(f"{what} forward {i}: gradient of "
                                         f"{name} differs by up to {d}")
        return a[0][0].item()

    res = {}
    dev_t = torch.device(dev or "cuda")
    ids = torch.as_tensor(np.random.default_rng(2).integers(
        0, llama_cfg.vocab_size, (RECOMPUTE_BATCH, seq)), device=dev_t)
    _reset_counts()
    off = grads(LlamaForCausalLM, llama_cfg, ids, 1)
    for gran in ("full", "core_attn", "full_attn", "offload"):
        with offloaded(gran == "offload"):
            on = grads(LlamaForCausalLM, dataclasses.replace(
                llama_cfg, recompute=True, recompute_granularity=(
                    "full" if gran == "offload" else gran)), ids, 1)
        res[f"llama_{gran}"] = compare(f"llama recompute {gran}", off, on)
    counts = _counts()
    # K1: 2 without recompute, 4 under full, core_attn and offload, 2
    # under full_attn, where both layers' tags keep their core's result
    check_counts(counts, {"fwd_launches": 2 * 8, "dq_launches": 2 * 5,
                          "dkv_launches": 2 * 5, "stash_kept": 2,
                          "stash_missed": 0}, "llama recompute")
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, gpt_cfg.vocab_size, (RECOMPUTE_BATCH, seq)), device=dev_t)
    off = grads(GPTForCausalLM, gpt_cfg, ids, 2)
    on = grads(GPTForCausalLM, dataclasses.replace(gpt_cfg, recompute=True),
               ids, 2)
    res["gpt_dropout"] = compare("gpt recompute", off, on)
    if torch.equal(off[0][0], off[1][0]):
        raise AssertionError("GPT's two forwards drew the same dropout")
    print(f"recompute ok: 2 layers at full width, batch {RECOMPUTE_BATCH} x "
          f"{seq}: LLaMA recompute full, core_attn, full_attn and offload, "
          f"GPT recompute with dropout {gpt_cfg.hidden_dropout_prob} (two "
          f"forwards): losses { {k: round(v, 5) for k, v in res.items()} } "
          "and every gradient bit-equal to recompute off; K1 twice a layer "
          "under recompute, once under full_attn", flush=True)
    return res


# -- the rest of training around the step --------------------------------------

OFFLOAD_LAYERS = 8     # offload's saved products: ~0.70 GB a layer in bf16
OPT_LAYERS, OPT_STEPS = 8, 3
OPT_LR = 1e-5
WORKERS_LAYERS, WORKERS_STEPS = 8, 3
# the foreach pass against the leaf rule on the same card tensors, at
# CHECK_LR (at OPT_LR an SGD step, ~1e-10 under the clip, moves a float32
# weight by less than its rounding): every tensor bit-equal, but Lamb's,
# whose trust ratio sums its norms in another order, to LAMB_STEP_TOL of
# what the leaf rule moved that tensor
CHECK_LR = 1e-2
LAMB_STEP_TOL = 1e-3
LBFGS_DIMS, LBFGS_ITERS = 1000, 100


def stash_bytes(cfg, batch, seq):
    """What a full_attn region keeps a layer: the attention output
    ``[B, S, H, D]`` in bf16 and its lse ``[B, H, S]`` in float32."""
    heads = cfg.num_attention_heads
    return batch * seq * cfg.hidden_size * 2 + batch * heads * seq * 4


def full_attn_phase(cfg, smi, fit_res, dev=None, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, steps=FIT_STEPS):
    """The ``fit`` phase's run with ``recompute_granularity="full_attn"``:
    K1 once a layer and step (the replay takes the tagged attention
    output), K2 and K3 as ``fit``; the losses equal ``fit``'s step for
    step (the same seeds, rows and kernels on the same values); the peak
    against ``fit``'s and the stash."""
    got = fit_phase(cfg, smi, dev, batch, seq, steps, label="full_attn")
    want = fit_res["losses"]
    diff = max(abs(a - b) for a, b in zip(got["losses"], want))
    if got["losses"] != want:
        raise AssertionError(f"full_attn losses {got['losses']} differ from "
                             f"fit's {want} by up to {diff}")
    stash = cfg.num_hidden_layers * stash_bytes(cfg, batch, seq) / 2 ** 30
    peak, fit_peak = got["peak_mem_gib"], fit_res["peak_mem_gib"]
    print(f"full_attn ok [{smi}]: losses equal fit's step for step (largest "
          f"difference {diff}); K1 {got['launches']['fwd_launches']} against "
          f"fit's {fit_res['launches']['fwd_launches']}; peak "
          f"{peak if peak is None else round(peak, 2)} GiB against fit's "
          f"{fit_peak if fit_peak is None else round(fit_peak, 2)} (stash "
          f"{stash:.3f} GiB); {got['tokens_per_s']:.1f} tokens/s against "
          f"{fit_res['tokens_per_s']:.1f}, step p50 {got['step_p50_s']:.4f} "
          f"s against {fit_res['step_p50_s']:.4f}", flush=True)
    return dict(got, fit_loss_max_diff=diff, stash_gib=stash)


def offload_phase(smi, dev=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  steps=FIT_STEPS, layers=OFFLOAD_LAYERS):
    """``fit`` at ``layers`` with full recompute and again with
    ``recompute(offload=True)`` (the products' outputs kept): the losses
    equal, K1 twice a layer and step in both; each run's peak and
    tokens/s."""
    from paddle_tpu_torch.models import LlamaConfig
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, recompute=True,
                                fuse_linear_cross_entropy=True)
    full = fit_phase(cfg, smi, dev, batch, seq, steps, label="offload_full",
                     check_clip=False)
    gc.collect()
    off = fit_phase(cfg, smi, dev, batch, seq, steps, label="offload",
                    offload=True, check_clip=False)
    if off["losses"] != full["losses"]:
        diff = max(abs(a - b) for a, b in zip(off["losses"],
                                              full["losses"]))
        raise AssertionError(f"offload losses {off['losses']} differ from "
                             f"full's {full['losses']} by up to {diff}")
    print(f"offload ok [{smi}]: L={cfg.num_hidden_layers}, losses equal full recompute's "
          f"step for step; peak {off['peak_mem_gib']} GiB against "
          f"{full['peak_mem_gib']}; {off['tokens_per_s']:.1f} tokens/s "
          f"against {full['tokens_per_s']:.1f}", flush=True)
    return dict(full=full, offload=off)


def optimizer_cases():
    """The eleven first-order optimizers and K4's AdamW (for its step
    time), each a ``(name, factory(parameters))``: O2's float32 masters
    where the optimizer takes ``multi_precision``, the global-norm clip
    1.0 on every one."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    def make(cls, mp=True, **kw):
        def build(params):
            extra = {"multi_precision": True} if mp else {}
            return cls(OPT_LR, parameters=params,
                       grad_clip=ClipGradByGlobalNorm(1.0), **extra, **kw)
        return build
    return [("SGD", make(O.SGD, weight_decay=0.01)),
            ("Momentum", make(O.Momentum, use_nesterov=True)),
            ("Adagrad", make(O.Adagrad)),
            ("RMSProp", make(O.RMSProp, centered=True, momentum=0.9)),
            ("Adamax", make(O.Adamax, mp=False)),
            ("Adadelta", make(O.Adadelta, mp=False)),
            ("Lamb", make(O.Lamb)),
            ("NAdam", make(O.NAdam, mp=False)),
            ("RAdam", make(O.RAdam, mp=False)),
            ("Rprop", make(O.Rprop, mp=False)),
            ("ASGD", make(O.ASGD)),
            ("AdamW (K4)", make(O.AdamW))]


def foreach_mismatch(opt, pairs, clip, step, skip=False):
    """The optimizer's foreach pass and its leaf rule at ``CHECK_LR``,
    each on its own copy of the same leaves (the first decoder layer's
    and the final norm's params, grads and states on the card): the
    largest departure of a master, a state tensor or a param without a
    master, over what the leaf rule moved that tensor (0.0 where all are
    bit-equal; a tensor the rule left as it was and the pass did not
    counts as infinite). A param with a master must be that master's
    cast, as the rule makes it. ``skip`` leaves the pass's copy as it
    was: the fault of an update skipped, which the check must reject."""
    import copy

    import torch
    ps = [p for p, _ in pairs]
    gs = [g for _, g in pairs]

    def copies():
        return ([p.detach().clone() for p in ps],
                [copy.deepcopy(opt._get_state(p)) for p in ps])
    bp, bs = copies()
    fp, fs = copies()
    lp, ls = copies()
    mask = [getattr(p, "need_clip", True) for p in ps]
    if not skip:
        opt._apply_foreach(fp, gs, fs, CHECK_LR, step, clip, mask)
    opt._apply_leaves(lp, gs, ls, CHECK_LR, step, clip, mask)
    torch.cuda.synchronize()
    worst = 0.0
    for f, l, b, sf, sl, sb in zip(fp, lp, bp, fs, ls, bs):
        if "master" in sl:
            if not torch.equal(f, sf["master"].to(f.dtype)):
                return math.inf
            trios = []
        else:
            trios = [(f, l, b)]
        trios += [(sf[k], sl[k], sb[k]) for k in sl]
        for x, y, z in trios:
            if not isinstance(y, torch.Tensor):
                if x != y:
                    return math.inf
                continue
            d = (x.float() - y.float()).abs().max().item()
            if d:
                moved = (y.float() - z.float()).abs().max().item()
                worst = max(worst, d / moved if moved else math.inf)
    return worst


def optimizers_phase(smi, dev=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     layers=OPT_LAYERS, steps=OPT_STEPS):
    """LLaMA-2-7B's width at ``layers``, batch x seq, decorated O2 from
    the same seed for every optimizer: ``steps`` ``train_batch`` steps,
    each one foreach pass on the card and no leaf-rule step (K4 for
    AdamW), finite losses; then on a fresh batch's grads the foreach pass
    against the leaf rule on copies of the first layer's leaves
    (:func:`foreach_mismatch`), and the skipped update rejected; the
    optimizer step's time (CUDA events) and the peak memory. Then LBFGS
    on the extended Rosenbrock function in ``LBFGS_DIMS`` dimensions."""
    import numpy as np
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import optimizer as base

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers,
                                fuse_linear_cross_entropy=True)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, batch, seq)).astype(np.int32)
    on_card = (dev or "cuda") != "cpu"
    out = {}
    for name, make in optimizer_cases():
        net = amp.decorate(LlamaForCausalLM(cfg, device=dev, seed=0),
                           level="O2", dtype="bfloat16")
        m = Model(net).prepare(
            make(list(net.parameters())),
            LlamaPretrainingCriterion(cfg).bind(net),
            amp_configs={"level": "O2", "dtype": "bfloat16"})
        opt = m._optimizer
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        base.reset_stats()
        losses = [m.train_batch([ids[0]], [ids[0]]) for _ in range(steps)]
        counts, passes = _counts(), dict(base.stats)
        k4 = name.endswith("(K4)")
        want = {"foreach_passes": 0 if k4 else steps, "leaf_rule_steps": 0}
        if passes != want or counts["adamw_kernel_launches"] != (
                steps if k4 else 0):
            raise AssertionError(f"{name}: {passes} and K4 "
                                 f"{counts['adamw_kernel_launches']} over "
                                 f"{steps} steps; want {want}")
        fwd = cfg.num_hidden_layers * steps
        check_counts(counts, {"fwd_launches": fwd, "dq_launches": fwd,
                              "dkv_launches": fwd}, name)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name} losses not finite: {losses}")
        # one more batch's grads: the check, then the timed step
        net.train()
        loss = m._forward_loss(m._tensors([ids[1]]),
                               m._tensors([ids[1]]))[1]
        loss.backward()
        pairs = [(p, base.grad_of(p)) for p in net.parameters()]
        clip = opt._grad_clip.factor(pairs)
        err = fault = None
        if not k4:
            first = [(p, g) for (n, p), (_, g) in zip(
                net.named_parameters(), pairs)
                if n.startswith(("llama.layers.0.", "llama.norm."))]
            limit = LAMB_STEP_TOL if name == "Lamb" else 0.0
            err = foreach_mismatch(opt, first, clip, opt._step_count + 1)
            fault = foreach_mismatch(opt, first, clip, opt._step_count + 1,
                                     skip=True)
            if err > limit or not fault > limit:
                raise AssertionError(
                    f"{name}: the foreach pass departs from the leaf rule "
                    f"by {err:.3g} of the step (limit {limit}); the "
                    f"skipped update by {fault:.3g}, which must be "
                    "rejected")
        ms = cuda_ms(opt.step, 3, warmup=0) if on_card else None
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)
        out[name] = dict(losses=losses, step_ms=ms, peak_mem_gib=peak,
                         foreach_err=err, skip_fault_err=fault,
                         passes=passes)
        print(f"optimizer {name} [{smi}]: losses "
              f"{[round(x, 4) for x in losses]}, {passes['foreach_passes']} "
              f"foreach passes, {passes['leaf_rule_steps']} leaf-rule steps, "
              f"K4 {counts['adamw_kernel_launches']}; step "
              f"{ms if ms is None else round(ms, 4)} ms; peak "
              f"{peak if peak is None else round(peak, 2)} GiB"
              + ("" if err is None else
                 f"; foreach vs leaf rule at lr {CHECK_LR}: {err:.3g} of "
                 f"the step, skipped update {fault:.3g} (rejected)"),
              flush=True)
        del m, net, opt, loss, pairs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    out["LBFGS"] = lbfgs_rosenbrock(smi, dev)
    return out


def lbfgs_rosenbrock(smi, dev=None, n=LBFGS_DIMS, iters=LBFGS_ITERS):
    """LBFGS (history 10) on the extended Rosenbrock function (Moré,
    Garbow and Hillstrom) in ``n`` dimensions from (-1.2, 1, ...): it
    must reach the minimum at ones."""
    import torch
    from paddle_tpu_torch.optimizer import LBFGS

    w = torch.nn.Parameter(torch.tensor([-1.2, 1.0] * (n // 2),
                                        device=dev or "cuda"))
    opt = LBFGS(parameters=[w], max_iter=iters, history_size=10)

    def rosenbrock():
        a, b = w[0::2], w[1::2]
        return (100 * (b - a * a) ** 2 + (1 - a) ** 2).sum()

    def closure():
        loss = rosenbrock()
        loss.backward()
        return loss
    with torch.no_grad():
        first = rosenbrock().item()
    t0 = time.perf_counter()
    loss = opt.step(closure)
    wall = time.perf_counter() - t0
    err = (w.detach() - 1).abs().max().item()
    if not (loss < 1e-6 * first and err < 1e-3):
        raise AssertionError(f"LBFGS on Rosenbrock: loss {first} -> {loss}, "
                             f"|x - 1| up to {err} after {opt.n_iter} "
                             "iterations")
    print(f"optimizer LBFGS [{smi}]: extended Rosenbrock n={n}, loss "
          f"{first} -> {loss} in {opt.n_iter} iterations ({wall:.3f} s), "
          f"|x - 1| <= {err:.3g}", flush=True)
    return dict(first_loss=first, loss=loss, iterations=opt.n_iter,
                wall_s=wall, max_err=err)


def workers_phase(smi, dev=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                  layers=WORKERS_LAYERS, steps=WORKERS_STEPS):
    """``fit`` for ``steps`` steps at ``layers`` (recompute, O2, the fit
    recipe) after CUDA is initialised, from ``DataLoader(num_workers=2)``
    over the fit rows (forked worker processes over shared memory), and
    from an ``IterableDataset`` of the same rows through the prefetch
    thread: losses bit-equal to ``num_workers=0``; no worker and no
    segment left."""
    import multiprocessing as mp

    import torch
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=layers, recompute=True,
                                fuse_linear_cross_entropy=True)
    rows = fit_rows(cfg, batch, seq, steps)
    if (dev or "cuda") != "cpu" and not torch.cuda.is_initialized():
        raise AssertionError("workers: CUDA is not initialised")

    class InWorker(io.TensorDataset):
        def __getitem__(self, i):
            if io.get_worker_info() is None:
                raise AssertionError("a sample fetched outside a worker")
            return super().__getitem__(i)

    class Stream(io.IterableDataset):
        def __iter__(self):
            if io.get_worker_info() is None:
                raise AssertionError("a stream read outside the prefetch "
                                     "thread")
            for r in rows:
                yield r, r

    loaders = {
        "num_workers=0": None,
        "num_workers=2 (processes)": io.DataLoader(
            InWorker([rows, rows]), batch_size=batch, num_workers=2),
        "IterableDataset, num_workers=2 (thread)": io.DataLoader(
            Stream(), batch_size=batch, num_workers=2)}
    res = {}
    for what, loader in loaders.items():
        m = fit_setup(cfg, dev)
        res[what] = run_fit(m, rows, batch, steps, loader)[0].losses
        del m
        gc.collect()
    want = res["num_workers=0"]
    for what, got in res.items():
        if got != want:
            raise AssertionError(f"workers: {what} losses {got} != "
                                 f"num_workers=0's {want}")
    if mp.active_children():
        raise AssertionError(f"workers left behind: {mp.active_children()}")
    print(f"workers ok [{smi}]: fit L={cfg.num_hidden_layers} {steps} steps "
          f"after CUDA "
          f"init, losses {[round(x, 5) for x in want]} bit-equal from "
          f"{', '.join(res)}; no worker left", flush=True)
    return res


# -- the serving engine ------------------------------------------------------

PROMPT_LENS = (32, 1024, 200, 512, 77, 900, 333, 640)
SAMPLED = (2, 5)          # request indices that sample; the rest greedy
NEW_TOKENS = 32
COSINE_MIN = 0.999        # engine vs dense last-prompt-token logits
# a bf16 engine against a float32 model of its own weights: the bf16
# trunk's rounding over 32 random layers, not the kernels', sets how far
# apart they sit (the unquantized engine read 0.9977 on an H100, as low
# as the int8 one); a fault in K7 (a wrong scale row, a dropped column)
# or a stale graph input moves the logits far past this
COSINE_MIN_F32 = 0.995
# argmax must agree where the dense top-2 gap exceeds this: about twice
# the bf16 noise between the chunked paged path and the dense forward
# (max abs logit difference 0.19-0.23 at full depth on an H100)
MARGIN = 0.5
# the ragged phase: Mistral-7B, prompts across and past its 4096 window
# (20.6k prompt tokens), three greedy ones longer than the window
RAGGED_PROMPT_LENS = (48, 300, 700, 1500, 2100, 4500, 5200, 6300)
RAGGED_SAMPLED = (1, 3)
RAGGED_POOL_PAGES = 2048
RAGGED_MAX_SEQ = 8192
PROFILE_STEPS = 3


def warm_up(eng, vocab):
    """First uses of every step class before the timed run: 8 requests
    arriving at once ramp the decode batch through every bucket, once
    greedy and once sampling (the ragged step's two token capacities
    come up on the way). On the card each class's CUDA graph is captured
    here."""
    import numpy as np
    for sampled in (False, True):
        for i in range(8):
            eng.add_request(np.arange(1 + i, 9 + i, dtype=np.int32) % vocab,
                            max_new_tokens=16, do_sample=sampled, top_k=50,
                            seed=i)
        eng.run()


def engine_phase(cfg, smi, dev=None, profile_steps=0, *, label="llama2_7b",
                 ragged=False, prompt_lens=PROMPT_LENS, sampled=SAMPLED,
                 num_pages=KV_POOL_PAGES, max_seq_len=None,
                 weight_quant=None):
    """``weight_quant``: the engine converts the model's trunk to int8 or
    int4 codes (K7): its launches are checked beside K5's, the trunk's
    weight bytes before and after are read, and the dense checks run on
    a float32 model of the quantized weights (:func:`quant_twin`)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import weight_only_kernel as WK
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import attention as A

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    print(f"model: {label} width h={cfg.hidden_size} "
          f"L={cfg.num_hidden_layers} heads={cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads or cfg.num_attention_heads} "
          f"ffn={cfg.intermediate_size} vocab={cfg.vocab_size} window="
          f"{cfg.sliding_window}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
          f"params {cfg.dtype}, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    first_logits, first_at = {}, {}
    eng = None

    def on_event(ev):
        if ev["type"] == "token" and ev["req_id"] not in first_logits:
            first_logits[ev["req_id"]] = eng.logits_row(ev["req_id"]).clone()
            first_at[ev["req_id"]] = time.perf_counter()

    trunk_before = trunk_weight_bytes(model)
    eng = ServingEngine(model, page_size=PAGE_SIZE, num_pages=num_pages,
                        max_batch=8, prefill_chunk=256, on_event=on_event,
                        device=dev, ragged=ragged, max_seq_len=max_seq_len,
                        weight_quant=weight_quant)
    trunk_after = trunk_weight_bytes(model)
    if weight_quant:
        print(f"weight_quant {weight_quant}: trunk weights "
              f"{trunk_before / 1e9:.4f} GB -> {trunk_after / 1e9:.4f} GB "
              f"(scales included), {trunk_after / trunk_before:.4f}x",
              flush=True)
    print(f"kv pool: {eng.cache.num_pages} pages x {PAGE_SIZE} tokens, "
          f"{eng.cache.bytes_total / 2 ** 30:.2f} GiB "
          f"{eng.cache_dtype}; {'ragged' if ragged else 'bucketed'} step",
          flush=True)
    t_warm = time.perf_counter()
    warm_up(eng, cfg.vocab_size)
    m = eng.metrics
    captured_warm = m.graphs_captured.value
    print(f"warm-up: {captured_warm} CUDA graphs captured "
          f"({m.step_program_classes.value:.0f} step classes) in "
          f"{time.perf_counter() - t_warm:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in prompt_lens]
    A.reset_stats()
    WK.reset_stats()
    first_logits.clear()
    dispatches0 = m.step_dispatches.value
    fetches0 = m.step_fetches.value
    chunks0 = m.prefill_chunks.value
    replays0 = m.graph_replays.value
    t_start = time.perf_counter()
    rids = []
    for i, p in enumerate(prompts):
        samp = i in sampled
        rids.append(eng.add_request(
            p, max_new_tokens=NEW_TOKENS, do_sample=samp,
            temperature=0.8 if samp else 1.0,
            top_k=50 if samp else 0, top_p=0.9 if samp else 1.0,
            seed=1000 + i))
    step_s, decode_steps = [], []       # decode_steps: (seconds, lanes)
    while not eng.scheduler.all_done():
        chunks = m.prefill_chunks.value
        t = time.perf_counter()
        events = eng.step()
        dt = time.perf_counter() - t
        step_s.append(dt)
        if m.prefill_chunks.value == chunks:
            decode_steps.append(
                (dt, sum(e["type"] == "token" for e in events)))
    decode_s = sum(d for d, _ in decode_steps)
    decode_tokens = sum(n for _, n in decode_steps)
    wall = time.perf_counter() - t_start
    steps = len(step_s)
    ttft = [first_at[r] - t_start for r in rids]
    counts = dict(A.stats)
    k7_counts = dict(WK.stats)
    forwards = m.step_dispatches.value - dispatches0
    fetches = m.step_fetches.value - fetches0
    prefills = m.prefill_chunks.value - chunks0
    replays = m.graph_replays.value - replays0
    captured_run = m.graphs_captured.value - captured_warm

    res = eng.results()
    for rid, p in zip(rids, prompts):
        r = res[rid]
        if r["finish_reason"] != "length" or \
                len(r["tokens"]) != NEW_TOKENS:
            raise AssertionError(f"request {rid} (prompt {p.size}) "
                                 f"finished {r['finish_reason']} with "
                                 f"{len(r['tokens'])} tokens")
    if ragged:
        # one K5 call a layer and dispatch, both forms over the plan
        want = {k: layers * forwards for k in (
            "kernel_launches", "tile_launches", "decode_launches",
            "combine_launches")}
        want["plain_calls"] = 0
        if not (forwards == fetches == steps
                and m.step_program_classes.value <= 2):
            raise AssertionError(
                f"ragged step: {forwards} dispatches and {fetches} fetches "
                f"in {steps} steps (want one each a step), "
                f"{m.step_program_classes.value} program classes (<= 2)")
    else:
        # one K5 call a layer and forward: a prefill chunk's through the
        # tile form, a decode step's through the split form and its combine
        want = {"kernel_launches": layers * forwards, "plain_calls": 0,
                "tile_launches": layers * prefills,
                "decode_launches": layers * (forwards - prefills),
                "combine_launches": layers * (forwards - prefills)}
    if counts != want:
        raise AssertionError(
            f"attention counts {counts}: want {want} ({layers} layers x "
            f"{forwards} forwards, {prefills} of them with a prefill chunk)")
    if on_card and replays != forwards:
        raise AssertionError(f"{replays} CUDA graph replays for {forwards} "
                             "forwards: a step ran outside its graph")
    if weight_quant and not ragged:
        # the 7 products a layer and forward: a decode bucket (B <= 8
        # rows) through the decode form, a 256-token chunk the tile form
        k7_want = k7_expected(llama_linears(cfg), [
            (1, forwards - prefills), (256, prefills)], on_card, layers)
        if k7_counts != k7_want:
            raise AssertionError(f"K7 counts {k7_counts}: want {k7_want}")
        print(f"K7 ok: {k7_counts} ({layers} layers x 7 products x "
              f"{forwards} forwards)", flush=True)
    print(f"engine ok: {len(rids)} requests x {NEW_TOKENS} tokens in "
          f"{steps} steps, {forwards} forwards ({prefills} with a prefill "
          f"chunk), {fetches} fetches, {m.step_program_classes.value:.0f} "
          f"program classes; CUDA graphs {m.graphs_captured.value} "
          f"captured ({captured_run} in the timed run), {replays} replays "
          f"= forwards; K5 launches {counts}; plain calls 0", flush=True)

    peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
            else None)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    firsts = [first_logits[r] for r in rids]
    if weight_quant:
        # against a float32 model of the quantized weights
        f32 = quant_twin(model)
        worst_cos, tf = dense_checks(f32, prompts, [res[r]["tokens"]
                                                    for r in rids], firsts,
                                     greedy, cos_min=COSINE_MIN_F32)
        f32_cos = [r["cosine"] for r in tf]
    else:
        worst_cos, tf = dense_checks(model, prompts, [res[r]["tokens"]
                                                      for r in rids],
                                     firsts, greedy)
        # the bf16 trunk's own distance from float32: the same weights in
        # a float32 model (read, the yardstick of the quantized runs)
        f32 = quant_twin(model)
        f32_cos = first_cosines(f32, prompts, firsts, greedy)
    del f32
    print(f"first-token cosine against a float32 model of the same "
          f"weights: min {min(f32_cos):.6f} over {len(f32_cos)} greedy "
          "requests", flush=True)

    ex = m.export()
    tokens = len(rids) * NEW_TOKENS
    summary = dict(
        card=smi, label=label, ragged=ragged, layers=layers,
        requests=len(rids), prompt_tokens=int(sum(prompt_lens)),
        steps=steps, forwards=forwards, fetches=fetches,
        program_classes=ex["step_program_classes"],
        graphs_captured=ex["graphs_captured"], graph_replays=replays,
        wall_s=wall, output_tok_s=tokens / wall,
        decode_tok_s=(decode_tokens / decode_s if decode_s else None),
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_max_s=max(ttft),
        step_p50_s=float(np.percentile(step_s, 50)), step_max_s=max(step_s),
        decode_steps=len(decode_steps),
        decode_step_p50_s=(float(np.percentile(
            [d for d, _ in decode_steps], 50)) if decode_steps else None),
        decode_lanes_mean=(decode_tokens / len(decode_steps)
                           if decode_steps else None),
        preemptions=ex["preemptions"], worst_cosine=worst_cos,
        teacher_forced=tf, launches=counts["kernel_launches"],
        form_launches={k: counts[k] for k in (
            "tile_launches", "decode_launches", "combine_launches")},
        peak_mem_gib=peak, f32_cosines=f32_cos,
        weight_quant=weight_quant, trunk_bytes_before=trunk_before,
        trunk_bytes_after=trunk_after, k7_counts=k7_counts)
    tag = f"serving {label} [{smi}]"
    print(f"{tag}: TTFT p50 {summary['ttft_p50_s']:.4f} s max "
          f"{summary['ttft_max_s']:.4f} s ({len(rids)} requests queued at "
          "once)", flush=True)
    print(f"{tag}: decode {summary['decode_tok_s']:.1f} tok/s over the "
          f"{len(decode_steps)} decode-only steps (p50 "
          f"{summary['decode_step_p50_s']:.4f} s, "
          f"{summary['decode_lanes_mean']:.2f} lanes on average), output "
          f"{summary['output_tok_s']:.1f} tok/s over {wall:.3f} s",
          flush=True)
    print(f"{tag}: step p50 {summary['step_p50_s']:.4f} s max "
          f"{summary['step_max_s']:.4f} s; peak memory "
          f"{summary['peak_mem_gib']} GiB", flush=True)
    if on_card:
        summary["profile"] = profile_decode(
            eng, cfg, max(profile_steps, PROFILE_STEPS), smi, label,
            mixed=ragged)
    return summary


def dense_checks(model, prompts, tokens, first_logits, greedy,
                 cos_min=COSINE_MIN):
    """Each greedy request against one dense forward of the same model
    (plain float32 attention) over its prompt and its generated tokens
    but the last: the first token's logits within cosine ``cos_min`` of
    the dense last-prompt-token logits; and, teacher-forced, every
    generated token the dense argmax at its position wherever the dense
    top-2 margin exceeds MARGIN (a graph that replayed stale positions,
    page tables or slots fails here). Returns (worst cosine, per-request
    readings)."""
    import numpy as np
    import torch

    worst_cos, readings = 1.0, []
    for i in greedy:
        p, toks = prompts[i], tokens[i]
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])
        with torch.inference_mode():
            h = model.llama(torch.as_tensor(seq, device=model.device)
                            .long()[None])[0, p.size - 1:]
            dense = model.lm_head(h).float()          # [new tokens, V]
        got = first_logits[i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"prompt {p.size}: non-finite logits")
        cos = torch.nn.functional.cosine_similarity(got, dense[0],
                                                    dim=0).item()
        diff = (got - dense[0]).abs().max().item()
        worst_cos = min(worst_cos, cos)
        top2 = dense.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu()
        agree = (dense.argmax(-1).cpu() == torch.as_tensor(toks))
        firm = margin > MARGIN
        bad = (firm & ~agree).nonzero()[:, 0].tolist()
        readings.append(dict(prompt=int(p.size), cosine=cos, max_diff=diff,
                             firm=int(firm.sum()), agree=int(agree.sum()),
                             disagree_firm=bad))
        print(f"dense check: prompt {p.size}: first token cosine {cos:.6f},"
              f" max abs diff {diff:.4f}; teacher-forced: {int(agree.sum())}"
              f" of {len(toks)} tokens the dense argmax, {int(firm.sum())} "
              f"past the margin {MARGIN}, disagreeing there: {bad}",
              flush=True)
        if cos < cos_min:
            raise AssertionError(f"prompt {p.size}: cosine {cos} < "
                                 f"{cos_min}")
        if bad:
            raise AssertionError(f"prompt {p.size}: tokens {bad} differ "
                                 f"from the dense argmax past the margin")
        if toks[0] != int(got.argmax()):
            raise AssertionError(f"prompt {p.size}: first greedy token "
                                 "is not the argmax of its logits")
    return worst_cos, readings


def profile_decode(eng, cfg, n_steps, smi, label="llama2_7b", mixed=False):
    """``torch.profiler`` over ``n_steps`` decode-only steps of a full
    batch of 8 (context ~512): device busy time per step and the kernels
    that take it, beside the wall of ``n_steps`` untraced steps just
    before (the trace's own wall is inflated by the tracing of every
    kernel a graph replays). ``mixed``: first the same over steps that
    carry a 256-token prefill chunk beside decode lanes."""
    import numpy as np
    import torch

    def profiled(what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        out = trace_steps(eng.step, n_steps, what, smi)
        out["untraced_wall_ms"] = wall_ms
        print(f"profile [{smi}]: {what}: untraced wall {wall_ms:.3f} ms, "
              f"device busy {out['device_ms']:.3f} ms (idle "
              f"{100 * (1 - out['device_ms'] / wall_ms):.1f} %), "
              f"{out['kernels']:.0f} kernels", flush=True)
        return out

    rng = np.random.default_rng(1)
    # enough new tokens that no lane finishes before the decode profile:
    # the 16 prefill steps (2 chunks each) decode the lanes already in
    for _ in range(8):
        eng.add_request(rng.integers(1, cfg.vocab_size, 512)
                        .astype(np.int32), max_new_tokens=2 * n_steps + 24)
    out = {}
    if mixed:
        eng.step()
        out["mixed"] = profiled(f"{label} mixed step (a 256-token chunk "
                                "beside decode lanes)")
    while eng.scheduler.waiting or eng.scheduler.prefill_queue:
        eng.step()
    eng.step()
    lanes = len(eng.scheduler.running)
    out["decode"] = profiled(f"{label} decode step ({lanes} lanes, ctx "
                             "~512-560)")
    out["decode"]["lanes"] = lanes
    eng.run()
    return out


def trace_steps(step, n_steps, what, smi):
    """``torch.profiler`` over ``n_steps`` calls of ``step`` (after one
    untraced call): wall vs device busy time per step and the kernels
    that take the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    # kernel rows only: an operator's row repeats its kernels' time
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True,
                  key=lambda e: e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    launches = sum(e.count for e in rows) / n_steps
    top = [(e.key, e.self_device_time_total / 1e3 / n_steps, e.count
            // n_steps) for e in rows[:12]]
    # device time by kind: the port's own kernels (each in a top-level
    # anonymous namespace of its csrc/*.cu), cuBLAS GEMMs, and PyTorch's
    # other kernels
    groups = {"port kernels": 0.0, "cuBLAS GEMMs": 0.0, "other": 0.0}
    for e in rows:
        kind = ("port kernels" if e.key.removeprefix("void ").startswith(
                    "(anonymous namespace)::") else
                "cuBLAS GEMMs" if any(w in e.key.lower() for w in (
                    "nvjet", "gemm", "cublas", "cutlass")) else "other")
        groups[kind] += e.self_device_time_total / 1e3 / n_steps
    print(f"profile [{smi}]: {what}: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms ({100 * device_ms / wall_ms:.1f} %), idle "
          f"{100 * (1 - device_ms / wall_ms):.1f} %, {launches:.0f} "
          "kernels; " + ", ".join(f"{k} {v:.3f} ms"
                                  for k, v in groups.items()), flush=True)
    for name, ms, count in top:
        print(f"profile: {ms:8.3f} ms/step  x{count:<5d} {name[:90]}",
              flush=True)
    return dict(wall_ms=wall_ms, device_ms=device_ms, kernels=launches,
                groups_ms=groups,
                top=[dict(name=n, ms_per_step=m, calls_per_step=c)
                     for n, m, c in top])


# -- speculative decoding in the engine --------------------------------------

SPEC_K = 4
SPEC_DRAFT_LAYERS = 2     # the small draft: LLaMA-2-7B's width, 2 layers
SPEC_F32_LAYERS = 2       # the float32 pass: 2 layers at full width
SPEC_F32_DRAFT_LAYERS = 1


def class_k5(key, layers, draft_layers, tiled=True):
    """K5's launches (calls and each form's) one dispatch of the engine's
    step class ``key`` makes: a decode step the split form and its
    combine a layer, a prefill chunk, a verify step and the draft's
    catch-up the tile form a layer, the draft's proposal the split form
    a draft layer and step, a ragged step both forms a layer. Without
    ``tiled`` (float32 queries, which the tile form does not take) every
    call is the split form's."""
    kind, shape = key[0], key[1]
    if kind == "draft_propose":
        n = draft_layers * shape[1]        # k+1 steps of the draft
    else:
        n = draft_layers if kind == "draft_step" else layers
    split = not tiled or kind in ("draft_propose", "ragged") or (
        kind == "step" and shape[1] == 1)
    tile = tiled and (kind == "ragged" or not split)
    return {"kernel_launches": n, "decode_launches": n * split,
            "combine_launches": n * split, "tile_launches": n * tile,
            "plain_calls": 0}


def k5_by_class(eng, before, layers, draft_layers, tiled=True):
    """{class kind: {"dispatches": n, and the K5 launches they must have
    made}} for the engine's dispatches since ``before`` (each class's
    dispatch count then); on the card each class's graph must have
    captured exactly its :func:`class_k5`."""
    out = {}
    for key, sc in eng._classes.items():
        per = class_k5(key, layers, draft_layers, tiled)
        if sc.graph is not None and sc.launches != per:
            raise AssertionError(f"the graph of {key} captured K5 launches "
                                 f"{sc.launches}, want {per}")
        n = sc.dispatches - before.get(key, 0)
        acc = out.setdefault(key[0], dict.fromkeys(("dispatches", *per), 0))
        acc["dispatches"] += n
        for k, v in per.items():
            acc[k] += n * v
    return out


def step_margin(dense_row, req, step, a, b):
    """How close the sampler's choice between tokens ``a`` and ``b`` at
    token index ``step`` sits to a tie, in logits, from dense logits: for
    a greedy request their gap; for a sampled one the smallest of the gap
    of their scores (the scaled, filtered logits plus the request's
    counter noise there, both kept) and each token's distance from the
    filters' boundary (the lowest kept scaled logit): a token there is
    kept or dropped by the least rounding, which flips the choice."""
    import torch
    from paddle_tpu_torch.serving.sampling import (_filter_top_k,
                                                   _filter_top_p, lane_noise)
    if not req.get("do_sample"):
        return abs(float(dense_row[a]) - float(dense_row[b]))
    dev, t = dense_row.device, req["temperature"]
    scaled = (dense_row / t)[None]
    keep = _filter_top_k(scaled, torch.tensor([req["top_k"]], device=dev))
    keep &= _filter_top_p(scaled.masked_fill(~keep, float("-inf")),
                          torch.tensor([req["top_p"]], device=dev))
    scaled, keep = scaled[0], keep[0]
    score = scaled + lane_noise(
        torch.tensor([req["seed"] & 0x7FFFFFFF], device=dev),
        torch.tensor([step], device=dev), dense_row.shape[0])[0]
    edge = float(scaled[keep].min())
    gaps = [abs(float(scaled[x]) - edge) * t for x in (a, b)]
    if keep[a] and keep[b]:
        gaps.append(abs(float(score[a]) - float(score[b])) * t)
    return min(gaps)


def departures(model, prompts, plain, spec, reqs, tie, what):
    """Each request whose speculative stream departs from the plain
    engine's: at the first departing token the two tokens must sit within
    ``tie`` of each other in one dense float32 forward (:func:`
    step_margin`): bf16's split and tile forms of K5 round apart, which
    can flip only a near-tie. Returns [(request, token, margin)]."""
    import numpy as np
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, plain, spec)):
        d = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if d is None:
            continue
        dense = dense_logits(model, np.concatenate(
            [p, np.asarray(a[:d], np.int32)]))[-1]
        out.append((i, d, step_margin(dense, reqs[i], d, a[d], b[d])))
    far = [x for x in out if not x[2] <= tie]
    if far:
        raise AssertionError(
            f"{what}: departures from the plain engine (request, token, "
            f"dense margin) {out}; past a tie (<= {tie}): {far}")
    return out


def spec_requests(prompt_lens, sampled):
    return [dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9,
                 seed=1000 + i) if i in sampled else dict(seed=1000 + i)
            for i in range(len(prompt_lens))]


def spec_prompts(vocab, prompt_lens=PROMPT_LENS):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in prompt_lens]


def spec_engine_run(model, draft, cfg, smi, label, prompts, reqs, dev=None,
                    *, k=SPEC_K, ragged=False, num_pages=KV_POOL_PAGES,
                    new=NEW_TOKENS, profile=0):
    """One engine over ``model`` (speculative with ``draft``, else
    plain), warmed up so that every step class's graph is captured, then
    ``prompts`` with the request arguments ``reqs``: every request
    finishes with its count;
    K5's launches equal what each class's dispatches make (:func:`
    k5_by_class`), the plain version never; one host fetch a round; each
    dispatch a graph replay on the card. Returns (tokens per request,
    readings)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving import attention as A

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    spec = draft is not None
    layers = cfg.num_hidden_layers
    dlayers = draft.cfg.num_hidden_layers if spec else 0
    eng = ServingEngine(model, page_size=PAGE_SIZE, num_pages=num_pages,
                        max_batch=8, prefill_chunk=256, device=dev,
                        ragged=ragged, draft_model=draft,
                        speculative_k=k if spec else None)
    warm_up(eng, cfg.vocab_size)
    m = eng.metrics
    names = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_fallbacks", "step_fetches", "graph_replays",
             "graphs_captured", "step_dispatches", "prefill_chunks")
    m0 = {n: getattr(m, n).value for n in names}
    before = {key: sc.dispatches for key, sc in eng._classes.items()}
    A.reset_stats()
    t_start = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new, **r)
            for p, r in zip(prompts, reqs)]
    step_s, round_s = [], []
    while not eng.scheduler.all_done():
        chunks = m.prefill_chunks.value
        t = time.perf_counter()
        eng.step()
        dt = time.perf_counter() - t
        step_s.append(dt)
        if m.prefill_chunks.value == chunks:
            round_s.append(dt)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    d = {n: getattr(m, n).value - m0[n] for n in names}
    res = eng.results()
    tokens = [res[r]["tokens"] for r in rids]
    for rid, toks in zip(rids, tokens):
        if res[rid]["finish_reason"] != "length" or len(toks) != new:
            raise AssertionError(f"{label}: request {rid} finished "
                                 f"{res[rid]['finish_reason']} with "
                                 f"{len(toks)} tokens")
    counts = dict(A.stats)
    tiled = cfg.dtype == "bfloat16"
    by_kind = k5_by_class(eng, before, layers, dlayers, tiled)
    want = {k: sum(v[k] for v in by_kind.values()) for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: K5 counts {counts}, the classes' "
                             f"dispatches make {want} ({by_kind})")
    rounds = d["spec_rounds"]
    per_round = {}
    if spec:
        if ragged:
            ok = d["step_fetches"] == len(step_s)
        else:
            ok = d["step_fetches"] == rounds + d["prefill_chunks"] or \
                d["spec_fallbacks"]
        if not rounds or not ok:
            raise AssertionError(f"{label}: {d['step_fetches']} fetches for "
                                 f"{rounds} rounds and {d['prefill_chunks']} "
                                 f"prefill chunks in {len(step_s)} steps")
        # each bucketed round is one proposal (k+1 split-form steps a
        # draft layer) and one verify (the tile form a layer); the draft's
        # catch-ups come on top
        per_round = {kind: {f: v[f] / rounds for f in (
            "dispatches", "decode_launches", "combine_launches",
            "tile_launches")} for kind, v in by_kind.items()
            if kind.startswith("draft") or kind == "verify"}
        exact = {"draft_propose": dlayers * (k + 1), "verify": layers}
        for kind, n in exact.items():
            got = per_round.get(kind, {})
            form = "decode_launches" if kind == "draft_propose" or \
                not tiled else "tile_launches"
            if not ragged or kind == "draft_propose":
                if got.get("dispatches") != 1.0 or got.get(form) != n:
                    raise AssertionError(f"{label}: {kind} per round "
                                         f"{got}, want one dispatch of {n}")
    if on_card and d["graph_replays"] != d["step_dispatches"]:
        raise AssertionError(f"{label}: {d['graph_replays']} graph replays "
                             f"for {d['step_dispatches']} dispatches")
    for c in (eng.cache, eng._draft_cache):
        if c is not None and c.free_pages != c.allocatable_pages:
            raise AssertionError(f"{label}: a page pool did not return "
                                 "to its allocatable pages")
    out = dict(
        label=label, ragged=ragged, k=k if spec else 0,
        draft_layers=dlayers, wall_s=wall,
        tok_s=len(rids) * new / wall,
        round_p50_s=(float(np.percentile(round_s, 50)) if round_s
                     else None),
        steps=len(step_s), rounds=rounds,
        acceptance=(d["spec_accepted_tokens"] / d["spec_draft_tokens"]
                    if d["spec_draft_tokens"] else None),
        drafted=d["spec_draft_tokens"], accepted=d["spec_accepted_tokens"],
        fallbacks=d["spec_fallbacks"], fetches=d["step_fetches"],
        prefill_chunks=d["prefill_chunks"],
        graphs_captured=m.graphs_captured.value,
        graph_replays=d["graph_replays"], k5=counts,
        k5_per_round=per_round,
        verify_launches=by_kind.get("verify", {}).get("kernel_launches",
                                                      0),
        peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                      if on_card else None))
    print(f"spec {label} [{smi}]: {out['tok_s']:.1f} tok/s over "
          f"{wall:.3f} s, {len(step_s)} steps, round (decode step) p50 "
          f"{out['round_p50_s']}, {rounds} rounds, acceptance "
          f"{out['acceptance']} ({d['spec_accepted_tokens']} of "
          f"{d['spec_draft_tokens']}), fallbacks {d['spec_fallbacks']}; "
          f"graphs {out['graphs_captured']} captured, "
          f"{d['graph_replays']} replayed; fetches {d['step_fetches']} "
          f"({d['prefill_chunks']} prefill chunks); K5 {counts}, per round "
          f"{per_round}; peak {out['peak_mem_gib']} GiB of 79.18",
          flush=True)
    if profile and on_card:
        out["profile"] = profile_decode(eng, cfg, profile, smi, label)
    del eng
    gc.collect()
    return tokens, out


def spec_phase(smi, dev=None, profile_steps=0, *, cfg=None, f32_cfg=None,
               prompt_lens=PROMPT_LENS, sampled=SAMPLED,
               num_pages=KV_POOL_PAGES, new=NEW_TOKENS):
    """``ServingEngine(draft_model=, speculative_k=4)`` over LLaMA-2-7B at
    full width and depth, bf16: the serve phase's requests with no draft,
    with a self-draft and with a 2-layer draft of the same width, then
    the ragged step with that draft; each speculative stream equal to
    the plain one or departing only at a near-tie (:func:`departures`).
    Then float32 at 2 layers of full width: a self-draft (every proposal
    accepted) and, ragged, a 1-layer draft, both streams equal to the
    plain engine's."""
    import dataclasses

    import torch
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = cfg or LlamaConfig.llama2_7b(dtype="bfloat16",
                                       use_flash_attention=False)
    f32_cfg = f32_cfg or LlamaConfig.llama2_7b(
        num_hidden_layers=SPEC_F32_LAYERS, dtype="float32",
        use_flash_attention=False)
    reqs = spec_requests(prompt_lens, sampled)
    res = {}

    def pair(c, draft_layers, seed):
        t0 = time.perf_counter()
        model = LlamaForCausalLM(c, device=dev, seed=seed)
        draft = LlamaForCausalLM(dataclasses.replace(
            c, num_hidden_layers=draft_layers), device=dev, seed=seed + 1)
        model.eval()
        draft.eval()
        print(f"spec: target {c.num_hidden_layers} layers, draft "
              f"{draft_layers} of width {c.hidden_size}, {c.dtype}, built "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        return model, draft, spec_prompts(c.vocab_size, prompt_lens)

    model, draft, prompts = pair(cfg, SPEC_DRAFT_LAYERS, 0)
    kw = dict(num_pages=num_pages, new=new)
    plain, res["plain"] = spec_engine_run(model, None, cfg, smi, "plain",
                                          prompts, reqs, dev, **kw)
    for name, d, ragged, prof in (
            ("self", model, False, 0),
            ("draft2", draft, False, profile_steps),
            ("draft2_ragged", draft, True, 0)):
        toks, res[name] = spec_engine_run(model, d, cfg, smi, name, prompts,
                                          reqs, dev, ragged=ragged,
                                          profile=prof, **kw)
        res[name]["departures"] = departures(
            model, prompts, plain, toks, reqs, MARGIN, f"spec {name}")
        print(f"spec {name}: {sum(a == b for a, b in zip(plain, toks))} of "
              f"{len(toks)} streams equal to the plain engine's; "
              f"departures (request, token, dense margin <= {MARGIN}): "
              f"{res[name]['departures']}", flush=True)
    del model, draft
    gc.collect()
    if torch.device(dev or "cuda").type == "cuda":
        torch.cuda.empty_cache()
    model, draft, prompts = pair(f32_cfg, SPEC_F32_DRAFT_LAYERS, 2)
    plain, res["f32_plain"] = spec_engine_run(model, None, f32_cfg, smi,
                                              "f32 plain", prompts, reqs,
                                              dev, **kw)
    for name, d, ragged in (("f32_self", model, False),
                            ("f32_draft1_ragged", draft, True)):
        toks, res[name] = spec_engine_run(model, d, f32_cfg, smi, name,
                                          prompts, reqs, dev, ragged=ragged,
                                          **kw)
        if toks != plain:
            raise AssertionError(f"spec {name}: float32 streams differ "
                                 "from the plain engine's")
    if res["f32_self"]["acceptance"] != 1.0:
        raise AssertionError(f"spec f32_self: acceptance "
                             f"{res['f32_self']['acceptance']}, not 1.0")
    print(f"spec float32 [{smi}]: {SPEC_F32_LAYERS} layers of width "
          f"{f32_cfg.hidden_size}: self-draft and ragged "
          f"{SPEC_F32_DRAFT_LAYERS}-layer draft streams equal to the plain "
          f"engine's, self-draft acceptance 1.0", flush=True)
    return res


# -- the prefix cache and its host tier ---------------------------------------

PREFIX_SHARED = 1024      # a family's shared prompt: 64 pages
PREFIX_SUFFIXES = (32, 64, 96, 128, 160, 192, 224, 256)
PREFIX_NEW = 32
# run 3's device pool: the largest at which family B's wave evicts all
# that family A left cached (136 pages, its 64-page shared chain
# included; prefix_reckoning prints the sums). The scheduler's admission
# (worst_case_need + the watermark) staggers a wave, so at 240 pages B
# evicts only A's suffix pages and the shared chain stays on the card
PREFIX_SMALL_POOL = 139
PREFIX_HOST_BYTES = 2 << 30   # run 3's host pool; a family's chain ~1.1 GB
PREFIX_F32_LAYERS = 2
PREFIX_F32_DRAFT_LAYERS = 1
PREFIX_HIT_SUFFIX = 128   # the isolated TTFT pair: 1024 cached + 128 new


def prefix_families(vocab, shared=PREFIX_SHARED, suffixes=PREFIX_SUFFIXES):
    """Two prompt families, A and B: each one shared prompt of ``shared``
    tokens and one request a suffix length, tokens from a seed."""
    import numpy as np
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        head = rng.integers(1, vocab, shared)
        out.append([np.concatenate([head, rng.integers(1, vocab, n)])
                    .astype(np.int32) for n in suffixes])
    return out


def prefix_engine(model, dev, num_pages, **kw):
    """The serve phase's engine (page 16, 8 lanes, 256-token chunks),
    warmed up so that every step class's graph is captured."""
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, page_size=PAGE_SIZE, num_pages=num_pages,
                        max_batch=8, prefill_chunk=256, device=dev, **kw)
    warm_up(eng, model.cfg.vocab_size)
    return eng


def prefix_wave(eng, prompts, new, layers, *, tiled=True, logits=False):
    """One wave: ``prompts`` queued at once (greedy, ``new`` tokens
    each), stepped to the end. Every request finishes with its count;
    K5's launches equal what the step classes' dispatches make (:func:`
    k5_by_class`). Returns the tokens, each request's cached pages (its
    last acquire), TTFTs, the prefill tokens computed, the prefill
    chunks, K5's counts, the metric deltas and, with ``logits``, each
    request's first-token logits."""
    from paddle_tpu_torch.serving import attention as A

    m = eng.metrics
    names = ("prefill_chunks", "tier_spill_pages", "tier_spill_dropped",
             "tier_restore_pages", "tier_restore_hits",
             "tier_restore_misses", "tier_corrupt_dropped",
             "prefix_hit_pages", "prefix_miss_pages", "prefix_evictions",
             "graph_replays", "step_dispatches")
    m0 = {n: getattr(m, n).value for n in names}
    spill0, restore0 = (list(h._samples) for h in (m.tier_spill_s,
                                                   m.tier_restore_s))
    before = {key: sc.dispatches for key, sc in eng._classes.items()}
    first_at, first = {}, {}

    def on_event(ev):
        rid = ev["req_id"]
        if ev["type"] == "token" and rid not in first_at:
            first_at[rid] = time.perf_counter()
            if logits:
                first[rid] = eng.logits_row(rid).clone()

    eng.on_event = on_event
    A.reset_stats()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=new) for p in prompts]
    add_s = time.perf_counter() - t0       # the tier's restores included
    while not eng.scheduler.all_done():
        eng.step()
    wall = time.perf_counter() - t0
    eng.on_event = None
    res = eng.results()
    tokens = [res[r]["tokens"] for r in rids]
    for r, t in zip(rids, tokens):
        if res[r]["finish_reason"] != "length" or len(t) != new:
            raise AssertionError(f"prefix: request {r} finished "
                                 f"{res[r]['finish_reason']} with {len(t)}")
    counts = dict(A.stats)
    dlayers = eng.draft.cfg.num_hidden_layers if eng.draft else 0
    by_kind = k5_by_class(eng, before, layers, dlayers, tiled)
    want = {k: sum(v[k] for v in by_kind.values()) for k in counts}
    if counts != want:
        raise AssertionError(f"prefix: K5 counts {counts}, the classes' "
                             f"dispatches make {want} ({by_kind})")
    d = {n: getattr(m, n).value - m0[n] for n in names}
    if eng._graphs and d["graph_replays"] != d["step_dispatches"]:
        raise AssertionError(f"prefix: {d['graph_replays']} replays for "
                             f"{d['step_dispatches']} dispatches")
    cached = [eng._requests[r].cached_pages for r in rids]
    ps = eng.cache.page_size
    return dict(
        tokens=tokens, cached=cached,
        ttft=[first_at[r] - t0 for r in rids], add_s=add_s, wall=wall,
        prefill_tokens=int(sum(p.size - c * ps
                               for p, c in zip(prompts, cached))),
        counts=counts, metrics=d,
        spill_s=m.tier_spill_s._samples[len(spill0):],
        restore_s=m.tier_restore_s._samples[len(restore0):],
        first=[first.get(r) for r in rids])


def tier_of(wave):
    """A :func:`prefix_wave`'s tier counters."""
    return {k: v for k, v in wave["metrics"].items()
            if k.startswith("tier")}


def prefix_chunks(prompts, cached, ps=PAGE_SIZE, chunk=256):
    """Prefill chunks the requests need past their cached pages."""
    return sum(math.ceil((p.size - c * ps) / chunk)
               for p, c in zip(prompts, cached))


def prefix_isolated(eng, prompt):
    """TTFT of one request alone on an idle engine."""
    first = []
    eng.on_event = lambda ev: (ev["type"] == "token" and not first
                               and first.append(time.perf_counter()))
    t0 = time.perf_counter()
    rid = eng.add_request(prompt, max_new_tokens=2)
    while not eng.scheduler.all_done():
        eng.step()
    eng.on_event = None
    return first[0] - t0, eng._requests[rid].cached_pages


def prefix_reckoning(eng, fam):
    """Run 3's pool against a family wave: the pages its 8 requests need
    at their peak (history + new tokens but the last, the shared prompt
    once), what the family leaves cached, and what admission charges
    (``worst_case_need`` of a request holding nothing, the
    watermark)."""
    c, s = eng.cache, eng.scheduler
    peak = (c.pages_for(PREFIX_SHARED)
            + sum(c.pages_for(p.size + PREFIX_NEW - 1)
                  - c.pages_for(PREFIX_SHARED) for p in fam))
    cached = (c.pages_for(PREFIX_SHARED)
              + sum(p.size // c.page_size - PREFIX_SHARED // c.page_size
                    for p in fam))
    first_need = c.pages_for(fam[0].size + 1 + s.spec_reserve_tokens)
    return dict(allocatable=c.allocatable_pages,
                watermark=s.watermark_pages, wave_peak=peak,
                family_cached=cached, first_need=first_need)


def link_rates(eng, n_pages=64):
    """The host link at a chain's size: ``n_pages`` of every layer's K/V
    gathered on the card and copied to pinned host memory, and copied
    back, and one spilled page's device work, CUDA-event timed. Returns
    (bytes, D2H ms, H2D ms, spill ms a page)."""
    import torch
    c = eng.cache
    idx = torch.arange(1, n_pages + 1, device=c.device)
    dev = c._kv.index_select(2, idx)
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True), iters=5)
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=5)
    # one spilled page's device work: the index copy, the gather of every
    # layer, the copy to pinned memory (what KVTier.spill enqueues)
    page_ms = cuda_ms(lambda: c.gather_pages([1], sync=False), iters=10)
    return dev.numel() * dev.element_size(), d2h, h2d, page_ms


def prefix_phase(smi, dev=None, *, cfg=None, f32_cfg=None,
                 shared=PREFIX_SHARED, suffixes=PREFIX_SUFFIXES,
                 new=PREFIX_NEW, num_pages=KV_POOL_PAGES,
                 small_pool=PREFIX_SMALL_POOL, host_bytes=PREFIX_HOST_BYTES,
                 hit_suffix=PREFIX_HIT_SUFFIX):
    """``ServingEngine(prefix_cache=True, host_pool=HostPagePool(...))``
    over the serve phase's LLaMA-2-7B (full width and depth, bf16, seed
    0): two prompt families (a shared prompt of ``shared`` tokens and 8
    suffixes each), 32 greedy tokens a request, a family a wave.

    1. No prefix cache: A, then B (the baseline streams and counts).
    2. ``prefix_cache=True``: A, then B. Streams equal run 1's or depart
       at a near-tie (:func:`departures`); the prefill chunks, and K5's
       tile launches with them (layers x chunks), drop by exactly the
       chunks the cached pages save; each hit request's first-token
       logits and tokens pass the serve phase's dense checks. Then one
       hit request and one cold request of the same length alone: TTFT.
    3. ``prefix_cache=True, host_pool=`` over ``small_pool`` pages: A, B,
       A. B's wave evicts A's chain (spilled), A's second wave restores
       it: restored pages > 0, every A request hits its whole chain, no
       spill dropped, no corrupt payload; streams as run 1's.
    4. Float32 at 2 layers of full width, token for token equal to the
       cache-off engine: runs 2 and 3, the ragged step, a 1-layer draft
       (k 4), and a migration (``prefill_only`` -> ``export_request`` ->
       ``serialize_pages`` -> ``deserialize_pages`` -> ``adopt_request``
       on an engine holding the prefix).

    Every pool's address is unchanged across each run."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import HostPagePool

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg or LlamaConfig.llama2_7b(dtype="bfloat16",
                                       use_flash_attention=False)
    f32_cfg = f32_cfg or LlamaConfig.llama2_7b(
        num_hidden_layers=PREFIX_F32_LAYERS, dtype="float32",
        use_flash_attention=False)
    layers = cfg.num_hidden_layers
    tag = f"prefix [{smi}]"
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    fa, fb = prefix_families(cfg.vocab_size, shared, suffixes)
    print(f"{tag}: model {layers} layers width {cfg.hidden_size} "
          f"{cfg.dtype} built in {time.perf_counter() - t0:.1f} s; two "
          f"families of {len(fa)} prompts, {shared} shared tokens + "
          f"{min(suffixes)}-{max(suffixes)}, {new} greedy tokens each",
          flush=True)
    res = {}

    def run(name, waves, npages, logits=False, **kw):
        eng = prefix_engine(model, dev, npages, **kw)
        ptrs = eng.cache.pool_ptrs()
        out = [prefix_wave(eng, w, new, layers, logits=logits)
               for w in waves]
        if eng.cache.pool_ptrs() != ptrs:
            raise AssertionError(f"{name}: a pool moved")
        for i, w in enumerate(out):
            print(f"{tag} {name} wave {i}: {w['wall']:.3f} s, prefill "
                  f"tokens {w['prefill_tokens']} in "
                  f"{w['metrics']['prefill_chunks']} chunks, hit pages "
                  f"{w['metrics']['prefix_hit_pages']} miss "
                  f"{w['metrics']['prefix_miss_pages']}, TTFT p50 "
                  f"{np.percentile(w['ttft'], 50):.4f} s, K5 "
                  f"{w['counts']}, tier {tier_of(w)}", flush=True)
        return eng, out

    # 1. the baseline
    eng, cold = run("cache off", (fa, fb), num_pages)
    del eng
    for w, fam in zip(cold, (fa, fb)):
        if w["metrics"]["prefill_chunks"] != prefix_chunks(fam, [0] * 8) \
                or w["counts"]["tile_launches"] != layers * \
                w["metrics"]["prefill_chunks"]:
            raise AssertionError("cache off: chunks or tile launches")
    # 2. the prefix cache
    eng, hot = run("prefix_cache", (fa, fb), num_pages, logits=True,
                   prefix_cache=True)
    saved = []
    for w, c, fam in zip(hot, cold, (fa, fb)):
        chunks = w["metrics"]["prefill_chunks"]
        if chunks != prefix_chunks(fam, w["cached"]) or \
                w["counts"]["tile_launches"] != layers * chunks:
            raise AssertionError(f"prefix_cache: {chunks} chunks, tile "
                                 f"launches {w['counts']}, cached "
                                 f"{w['cached']}")
        saved.append(c["metrics"]["prefill_chunks"] - chunks)
        if c["counts"]["tile_launches"] - w["counts"]["tile_launches"] \
                != layers * saved[-1] or saved[-1] <= 0:
            raise AssertionError("prefix_cache: tile launches did not "
                                 "drop by the chunks not run")
        if w["cached"][0] != 0 or any(
                x != shared // PAGE_SIZE for x in w["cached"][1:]):
            raise AssertionError(f"prefix_cache: cached pages "
                                 f"{w['cached']}")
    prompts = fa + fb
    plain = [t for w in cold for t in w["tokens"]]
    got = [t for w in hot for t in w["tokens"]]
    greedy = [dict(seed=0)] * len(prompts)
    res["departures"] = departures(model, prompts, plain, got, greedy,
                                   MARGIN, "prefix_cache")
    hits = [i for i in range(len(prompts)) if i % len(fa)]
    worst_cos, _ = dense_checks(model, prompts, got,
                                [x for w in hot for x in w["first"]], hits)
    rng = np.random.default_rng(11)
    hit_p = np.concatenate([fa[0][:shared], rng.integers(
        1, cfg.vocab_size, hit_suffix)]).astype(np.int32)
    cold_p = rng.integers(1, cfg.vocab_size, hit_p.size).astype(np.int32)
    ttft_hit, hit_pages = prefix_isolated(eng, hit_p)
    ttft_cold, cold_pages = prefix_isolated(eng, cold_p)
    if hit_pages != shared // PAGE_SIZE or cold_pages != 0:
        raise AssertionError(f"isolated: cached {hit_pages}, {cold_pages}")
    res["hot"] = dict(
        prefill_tokens=[w["prefill_tokens"] for w in hot],
        cold_prefill_tokens=[w["prefill_tokens"] for w in cold],
        chunks_saved=saved,
        tile_launches=sum(w["counts"]["tile_launches"] for w in hot),
        cold_tile_launches=sum(w["counts"]["tile_launches"] for w in cold),
        ttft_p50_hit=float(np.percentile(
            [w["ttft"][i] for w in hot for i in range(1, len(fa))], 50)),
        ttft_p50_cold_run=float(np.percentile(
            [t for w in cold for t in w["ttft"]], 50)),
        ttft_first_of_family=[w["ttft"][0] for w in hot],
        ttft_isolated_hit=ttft_hit, ttft_isolated_cold=ttft_cold,
        worst_cosine=worst_cos,
        equal_streams=sum(a == b for a, b in zip(plain, got)))
    r = res["hot"]
    print(f"{tag} prefix_cache: prefill tokens {r['prefill_tokens']} "
          f"(cache off {r['cold_prefill_tokens']}), chunks saved "
          f"{saved}, K5 tile launches {r['tile_launches']} (cache off "
          f"{r['cold_tile_launches']} = {layers} x the chunks not run "
          f"more); TTFT p50 hit requests {r['ttft_p50_hit']:.4f} s, "
          f"cache-off run {r['ttft_p50_cold_run']:.4f} s; alone: hit "
          f"({shared} cached + {hit_suffix}) {ttft_hit:.4f} s, cold "
          f"{ttft_cold:.4f} s; {r['equal_streams']} of {len(plain)} "
          f"streams equal, departures {res['departures']}; worst cosine "
          f"{worst_cos:.6f}", flush=True)
    del eng
    gc.collect()
    # 3. the host tier under a small pool
    pool = HostPagePool(host_bytes)
    eng = prefix_engine(model, dev, small_pool, prefix_cache=True,
                        host_pool=pool)
    reck = prefix_reckoning(eng, fb)
    print(f"{tag} small pool: {reck}", flush=True)
    ptrs = eng.cache.pool_ptrs()
    tier = [prefix_wave(eng, w, new, layers) for w in (fa, fb)]
    left = eng.cache.probe_prefix(fa[0], fa[0].size)
    if left:
        raise AssertionError(f"small pool: family B's wave left {left} "
                             "pages of A's chain on the card")
    tier.append(prefix_wave(eng, fa, new, layers))
    if eng.cache.pool_ptrs() != ptrs:
        raise AssertionError("small pool: a pool moved")
    w3 = tier[2]["metrics"]
    chain = [(p.size - 1) // PAGE_SIZE for p in fa]
    spilled = sum(w["metrics"]["tier_spill_pages"] for w in tier)
    if not (w3["tier_restore_pages"] > 0 and tier[2]["cached"] == chain
            and all(w["metrics"]["tier_spill_dropped"] == 0
                    and w["metrics"]["tier_corrupt_dropped"] == 0
                    for w in tier)):
        raise AssertionError(f"the tier degraded: "
                             f"{[tier_of(w) for w in tier]}, cached "
                             f"{tier[2]['cached']} (chains {chain})")
    res["tier_departures"] = departures(
        model, fa, cold[0]["tokens"], tier[2]["tokens"], greedy[:len(fa)],
        MARGIN, "tier restore")
    page_bytes = eng.cache.bytes_total / eng.cache.num_pages
    spill_s = sum(s for w in tier for s in w["spill_s"])
    restore_s = sum(tier[2]["restore_s"])
    link = link_rates(eng) if on_card else None
    res["tier"] = dict(
        reckoning=reck, spilled_pages=spilled,
        restored_pages=w3["tier_restore_pages"],
        restores=w3["tier_restore_hits"], spill_s=spill_s,
        restore_s=restore_s, page_bytes=page_bytes,
        spill_gb_s=spilled * page_bytes / spill_s / 1e9 if spill_s else None,
        restore_gb_s=(w3["tier_restore_pages"] * page_bytes / restore_s
                      / 1e9 if restore_s else None),
        wave3_add_s=tier[2]["add_s"],
        ttft_p50_restored=float(np.percentile(tier[2]["ttft"], 50)),
        equal_streams=sum(a == b for a, b in zip(cold[0]["tokens"],
                                                 tier[2]["tokens"])),
        host_pool=eng.tier_stats(),
        link=(dict(bytes=link[0], d2h_ms=link[1], h2d_ms=link[2],
                   d2h_gb_s=link[0] / link[1] / 1e6,
                   h2d_gb_s=link[0] / link[2] / 1e6,
                   spill_page_device_ms=link[3]) if link else None))
    t = res["tier"]
    print(f"{tag} tier: {spilled} pages spilled ({t['spill_s']:.3f} s of "
          f"flushes, {t['spill_gb_s']} GB/s serialized), "
          f"{t['restored_pages']} restored in {t['restores']} restores "
          f"({t['restore_s']:.3f} s, {t['restore_gb_s']} GB/s); wave 3 "
          f"TTFT p50 {t['ttft_p50_restored']:.4f} s, its add_request "
          f"{t['wave3_add_s']:.3f} s; host link {t['link']}; "
          f"{t['equal_streams']} of {len(fa)} streams equal, departures "
          f"{res['tier_departures']}; host pool {t['host_pool']}",
          flush=True)
    del eng, pool
    gc.collect()
    res["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    del model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    res["f32"] = prefix_f32(smi, dev, f32_cfg, fa, fb, new, num_pages,
                            small_pool, host_bytes)
    print(f"{tag}: peak memory {res['peak_mem_gib']} GiB (bf16 runs)",
          flush=True)
    return res


def prefix_f32(smi, dev, cfg, fa, fb, new, num_pages, small_pool,
               host_bytes):
    """Float32 at 2 layers of full width: the cache off, then every
    form of the cache, token for token equal to it."""
    import dataclasses

    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import (HostPagePool, deserialize_pages,
                                          serialize_pages)

    layers = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=dev, seed=2)
    draft = LlamaForCausalLM(dataclasses.replace(
        cfg, num_hidden_layers=PREFIX_F32_DRAFT_LAYERS), device=dev, seed=3)
    model.eval()
    draft.eval()

    def serve(waves, npages, **kw):
        eng = prefix_engine(model, dev, npages, **kw)
        ptrs = eng.cache.pool_ptrs()
        out = [prefix_wave(eng, w, new, layers, tiled=False)
               for w in waves]
        if eng.cache.pool_ptrs() != ptrs:
            raise AssertionError("f32: a pool moved")
        return eng, out

    # the migrated request: A's shared prompt and a suffix no engine
    # cached, so the payload carries the suffix's pages
    rng = np.random.default_rng(13)
    mig = np.concatenate([fa[0][:PREFIX_SHARED], rng.integers(
        1, cfg.vocab_size, 200)]).astype(np.int32)
    base_eng, base = serve((fa, fb, fa, [mig]), num_pages)
    del base_eng
    want = [w["tokens"] for w in base]
    out = {}
    for name, waves, npages, kw in (
            ("prefix_cache", (fa, fb), num_pages, dict(prefix_cache=True)),
            ("tier", (fa, fb, fa), small_pool,
             dict(prefix_cache=True, host_pool=HostPagePool(host_bytes))),
            ("ragged", (fa, fb), num_pages,
             dict(prefix_cache=True, ragged=True)),
            ("draft", (fa, fb), num_pages,
             dict(prefix_cache=True, draft_model=draft, speculative_k=4))):
        eng, got = serve(waves, npages, **kw)
        if [w["tokens"] for w in got] != want[:len(waves)]:
            raise AssertionError(f"f32 {name}: streams differ from the "
                                 "cache-off engine's")
        out[name] = dict(hit_pages=sum(w["metrics"]["prefix_hit_pages"]
                                       for w in got),
                         restored=sum(w["metrics"]["tier_restore_pages"]
                                      for w in got))
        if name == "tier" and not out[name]["restored"]:
            raise AssertionError("f32 tier: nothing restored")
        if name == "draft" and eng.metrics.spec_rounds.value == 0:
            raise AssertionError("f32 draft: no speculative round")
        if name == "prefix_cache":
            holder = eng              # A and B cached: the adopter below
        else:
            del eng
    # a migration: prefilled on one engine, decoded on one that holds the
    # prefix, through the wire format
    src = prefix_engine(model, dev, num_pages, prefix_cache=True)
    p = mig
    rid = src.add_request(p, max_new_tokens=new, prefill_only=True)
    src.run()
    skip = holder.cache.probe_prefix(p, p.size + 1)
    payload = serialize_pages(*src.export_request(rid, skip_pages=skip))
    src.release_request(rid)
    meta, k, v, _ = deserialize_pages(payload)
    ptrs = holder.cache.pool_ptrs()
    arid = holder.adopt_request(meta, k, v, max_new_tokens=new)
    holder.run()
    if holder.results()[arid]["tokens"] != want[3][0] or \
            holder.cache.pool_ptrs() != ptrs or not skip \
            or not meta["n_pages"]:
        raise AssertionError("f32 migration: the adopted stream differs "
                             f"(skip {skip})")
    out["migration"] = dict(skip_pages=skip, payload_bytes=len(payload),
                            pages=meta["n_pages"])
    print(f"prefix float32 [{smi}]: {layers} layers of width "
          f"{cfg.hidden_size}: the cache, the tier, the ragged step, a "
          f"{PREFIX_F32_DRAFT_LAYERS}-layer draft and a migration "
          f"({meta['n_pages']} pages past the adopter's {skip}, "
          f"{len(payload)} bytes) all equal to the cache-off engine token "
          f"for token: {out}", flush=True)
    return out


# -- the attention cases outside the kernels' arms ---------------------------

ATTN_SHAPE = (2, 2048, 16, HEAD_DIM)      # GPT-3 1.3B's attention, bf16
ATTN_DROP = 0.1
ATTN_Q_LENS, ATTN_K_LENS = (1000, 1500, 1596), (1400, 900, 1796)


def attn_cases_phase(dev="cuda", shape=ATTN_SHAPE, q_lens=ATTN_Q_LENS,
                     k_lens=ATTN_K_LENS):
    """B1-B4 on the card: the returned probabilities (the dense route)
    beside K1's ``out``; dropout under a mask that keeps every link (the
    dense route) against K1's dropout arm at the same seed, a seed one
    off rejected, and the kept share of the live links; causal
    ``flash_attn_unpadded`` with different q and k boundaries through
    K6's two bands and the banded K2/K3 (launches exact, no dense call)
    against their plain versions; the rotary embedding in bf16 against
    its float32 form, each style and table form."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_rotary_position_embedding as rope
    from paddle_tpu_torch.nn.functional import (_cross_causal_bands,
                                                flash_attn_unpadded)
    from paddle_tpu_torch.ops import fa_kernel as FK
    from paddle_tpu_torch.ops import flash_attention as FA

    b, s, h, d = shape
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*sh):
        return torch.randn(*sh, generator=g, device=dev).to(bf16)
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    res = {}
    # B1
    FK.reset_stats()
    dense0 = FA.stats["dense"]
    want = FA.flash_attention_bshd(q, k, v, causal=True)
    got, probs = FA.flash_attention_bshd(q, k, v, causal=True,
                                         return_probs=True)
    if FA.stats["dense"] != dense0 + 1 or FK.stats["fwd_launches"] != 1:
        raise AssertionError(f"B1 routes: dense {FA.stats['dense'] - dense0}"
                             f", K1 {FK.stats['fwd_launches']}")
    ratio = k5_ratio(got, want, BF16_TOL)
    rows = probs.float().sum(-1)
    res["b1"] = dict(ratio=ratio, row_sum_err=(rows - 1).abs().max().item())
    if not ratio <= 1.0 or res["b1"]["row_sum_err"] > 2e-2:
        raise AssertionError(f"B1: out against K1's ratio {ratio}, "
                             f"probability rows off 1 by "
                             f"{res['b1']['row_sum_err']}")
    del probs, rows
    # B2: an all-keep mask sends dropout to the dense route; K1's arm at
    # the same seed must draw the same links
    seed = DROP_SEED
    ones = torch.ones(s, s, dtype=torch.bool, device=dev)
    k1 = FA.flash_attention_bshd(q, k, v, causal=True, dropout_p=ATTN_DROP,
                                 seed=seed)
    dense = FA.flash_attention_bshd(q, k, v, mask=ones, causal=True,
                                    dropout_p=ATTN_DROP, seed=seed)
    fault = FA.flash_attention_bshd(q, k, v, mask=ones, causal=True,
                                    dropout_p=ATTN_DROP, seed=seed - 1)
    ratio, fault_ratio = (k5_ratio(x, k1, BF16_TOL) for x in (dense, fault))
    _, undropped = FA.dense_attention(q, k, v, causal=True,
                                      return_probs=True)
    _, dropped = FA.dense_attention(q, k, v, causal=True,
                                    dropout_p=ATTN_DROP, seed=seed,
                                    return_probs=True)
    live = undropped > 0
    n = int(live.sum())
    share = int(((dropped > 0) & live).sum()) / n
    sigma = (ATTN_DROP * (1 - ATTN_DROP) / n) ** 0.5
    del undropped, dropped, live
    res["b2"] = dict(ratio=ratio, fault_ratio=fault_ratio, kept=share,
                     sigma=sigma)
    if not (ratio <= 1.0 < fault_ratio
            and abs(share - (1 - ATTN_DROP)) <= 3 * sigma):
        raise AssertionError(f"B2: {res['b2']}")
    # B3 through the entry a user calls, with gradients
    cq = torch.tensor(np.cumsum([0, *q_lens]), dtype=torch.int32,
                      device=dev)
    ck = torch.tensor(np.cumsum([0, *k_lens]), dtype=torch.int32,
                      device=dev)
    tq, tk = int(cq[-1]), int(ck[-1])
    x = [rnd(n_, h, d).requires_grad_() for n_ in (tq, tk, tk)]
    do = rnd(tq, h, d)
    FK.reset_stats()
    dense0 = FA.stats["dense"]
    out, _ = flash_attn_unpadded(*x, cq, ck, max(q_lens), max(k_lens),
                                 causal=True)
    out.backward(do)
    counts = dict(FK.stats)
    check_counts(counts, {"fwd_launches": 0, "stream_fwd_launches": 1,
                          "dq_launches": 1, "dkv_launches": 1,
                          "seg_arm_launches": 0, "drop_arm_launches": 0},
                 "B3 flash_attn_unpadded cross-packed causal")
    if FA.stats["dense"] != dense0:
        raise AssertionError("B3 took the dense route")
    pq, pk = (-tq) % 128, (-tk) % 128
    bands = _cross_causal_bands(cq, ck, tk, tq + pq, tk + pk)
    fm = dict(zip(("fm_start", "fm_end", "fm_start2", "fm_end2"), bands))
    qp, kp, vp, dop = (F.pad(t.detach(), (0, 0, 0, 0, 0, n_))[None]
                       for t, n_ in zip((*x, do), (pq, pk, pk, pq)))
    # the backward's plain version from the out and lse the kernels gave
    # it (K6 again on the same inputs: the same bits), so that each
    # kernel is held to its own arithmetic
    gout, glse = FK.fa_forward(qp, kp, vp, return_lse=True, **fm)
    if not torch.equal(gout[0, :tq], out.detach()):
        raise AssertionError("B3: K6 gave other bits on the same inputs")
    wout, wlse = FK.fa_forward_plain(qp, kp, vp, fm=bands, return_lse=True)
    wdq, wdk, wdv = FK.fa_backward_plain(qp, kp, vp, gout, glse, dop,
                                         fm=bands)
    got = dict(out=gout, lse=glse,
               **{n_: F.pad(t.grad, (0, 0, 0, 0, 0, p_))[None]
                  for n_, t, p_ in zip(("dq", "dk", "dv"), x,
                                       (pq, pk, pk))})
    want = dict(out=wout, lse=wlse, dq=wdq, dk=wdk, dv=wdv)
    readings, _, _ = masked_check("B3 cross-packed causal", qp, kp, vp, dop,
                                  dict(causal=False, fm=bands), got, want)
    res["b3"] = dict(readings, launches=counts, tq=tq, tk=tk)
    del gout, glse, wout, wlse, wdq, wdk, wdv, got, want
    # B4
    worst = 0.0
    pos = torch.randint(0, 4096, (b, s), generator=g, device=dev)
    tab_s, tab_c = (torch.randn(4096, d, generator=g, device=dev)
                    for _ in range(2))
    for neox in (True, False):
        for tables, with_pos in ((False, True), (False, False),
                                 (True, True)):
            kw = dict(position_ids=pos if with_pos else None,
                      use_neox_rotary_style=neox)
            if tables:
                kw.update(sin=tab_s, cos=tab_c)
            lo = rope(q, k, v, **kw)
            hi = rope(q.float(), k.float(), v.float(), **kw)
            worst = max(worst, max(k5_ratio(a_, b_, 2.0 ** -8)
                                   for a_, b_ in zip(lo, hi)))
    res["b4_ratio"] = worst
    if not worst <= 1.0:
        raise AssertionError(f"B4: bf16 rope off its float32 form: ratio "
                             f"{worst}")
    print(f"attn_cases ok: B1 return_probs out vs K1 ratio "
          f"{res['b1']['ratio']:.3f}; B2 all-keep mask + dropout vs K1's "
          f"arm ratio {res['b2']['ratio']:.3f} (seed one off "
          f"{res['b2']['fault_ratio']:.1f}), kept {share:.5f} (1 - p = "
          f"{1 - ATTN_DROP}, sigma {sigma:.2e}); B3 cross-packed causal "
          f"{tq} x {tk}: K6 1, K2 1, K3 1, dense 0, {readings}; B4 rope "
          f"ratio {worst:.3f}", flush=True)
    return res


# -- generate() --------------------------------------------------------------

# LLaMA-2-7B: batch 8 x 512-token prompts, 128 new tokens; beams: batch 2 x
# 4 beams, 64 new; speculative: k 4; Mistral-7B: batch 2 x 4600 (past the
# 4096 window), 64 new; GPT-3 1.3B: batch 8 x 1024, 128 new
GEN_BATCH, GEN_PROMPT, GEN_NEW = 8, 512, 128
GEN_BEAMS, GEN_BEAM_BATCH, GEN_BEAM_NEW = 4, 2, 64
GEN_SPEC_K = 4
GEN_MISTRAL = (2, 4600, 64)
GEN_GPT = (8, 1024, 128)
GEN_EOS = 2
# the int8 cache's teacher-forced margin, stated before the first run:
# each K/V element moves by at most 1/254 of its row's absmax (~0.6 % of a
# row's RMS for 128 Gaussian-like values, ~3x bf16's own 2**-9 rounding of
# K/V), so its logit noise is taken as up to twice the bf16 path's (0.19-
# 0.23 at full depth), and the margin doubles the bf16 check's 0.5
INT8_MARGIN = 1.0
# beam scores (sums of float32 log-probs of bf16 logits): a bf16 logit of
# |x| ~ 5-10 is rounded by up to 2**-5, so 0.02 a token bounds the
# rounding and the kernel-vs-dense noise of the chosen tokens' log-probs
BEAM_TOL_PER_TOKEN = 0.02
GEN_FAULT_WINDOW = 16   # the window-off-by-one probe's window
# float32 logits of two summation orders: a top-2 gap below this is a tie
F32_TIE = 1e-3


def gen_k5_cases():
    """``cached_attention``'s K5 call at the decode and prefill shapes of
    generate's three models, its int8 and window arms and the speculative
    verify (S = k+1): (name, b, s, t, h, kv, offset, window, int8, dtype,
    head_dim)."""
    import torch
    bf16 = torch.bfloat16
    t_ll = GEN_PROMPT + GEN_NEW
    mb, mp, mn = GEN_MISTRAL
    t_mi = -(-(mp + mn) // 16) * 16
    gb, gp, gn = GEN_GPT
    return [
        ("llama2_7b decode", GEN_BATCH, 1, t_ll, 32, 32, t_ll - 65, None,
         False, bf16, 128),
        ("llama2_7b prefill", GEN_BATCH, GEN_PROMPT, t_ll, 32, 32, 0, None,
         False, bf16, 128),
        ("llama2_7b speculative verify S=k+1", GEN_BATCH, GEN_SPEC_K + 1,
         t_ll + 16, 32, 32, 300, None, False, bf16, 128),
        ("llama2_7b decode int8", GEN_BATCH, 1, t_ll, 32, 32, t_ll - 9, None,
         True, bf16, 128),
        ("llama2_7b prefill int8", GEN_BATCH, GEN_PROMPT, t_ll, 32, 32, 0,
         None, True, bf16, 128),
        ("mistral_7b decode window 4096", mb, 1, t_mi, 32, 8, mp + 30, 4096,
         False, bf16, 128),
        ("mistral_7b prefill window 4096", mb, mp, t_mi, 32, 8, 0, 4096,
         False, bf16, 128),
        ("mistral_7b decode int8 window 4096", mb, 1, t_mi, 32, 8, mp + 2,
         4096, True, bf16, 128),
        ("gpt3_1_3b decode", gb, 1, gp + gn, 16, 16, gp + 100, None, False,
         bf16, 128),
        ("gpt3_1_3b prefill", gb, gp, gp + gn, 16, 16, 0, None, False, bf16,
         128),
        ("float32 prompt (split form)", 2, 64, 128, 8, 8, 10, 40, False,
         torch.float32, 128),
    ]


def gen_k5_inputs(b, s, t, h, kv, int8, dtype, d, seed, dev):
    """Random q, k_new, v_new and a cache whose every slot holds random
    values (stale slots past the offset included, which the mask hides)."""
    import torch
    from paddle_tpu_torch.serving.attention import quantize_q8
    g = torch.Generator(device=dev).manual_seed(seed)
    tr = -(-t // 16) * 16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = rnd(b, s, h, d).to(dtype)
    kn, vn = rnd(b, s, kv, d).to(dtype), rnd(b, s, kv, d).to(dtype)
    if int8:
        kb, vb = quantize_q8(rnd(b, tr, kv, d)), quantize_q8(rnd(b, tr, kv, d))
    else:
        kb, vb = rnd(b, tr, kv, d).to(dtype), rnd(b, tr, kv, d).to(dtype)
    return q, kn, vn, kb, vb


def _clone_cache(x):
    return tuple(y.clone() for y in x) if isinstance(x, tuple) else x.clone()


def gen_kernel_checks(dev="cuda"):
    """``cached_attention`` through K5 against its plain version (the JAX
    package's einsum form) at every case of :func:`gen_k5_cases`, with the
    ``kernels`` phase's K5 tolerance; then two planted faults (a cache
    slot written at offset + 1, the window one key too wide) that the same
    comparison must reject; then K5's time at generate's LLaMA decode
    shape (B 8, context 512-639) beside the plain version, SDPA on the
    cache and the bound. Returns (worst bf16 error, checks, timing)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import attention as A

    worst, checks = 0.0, []
    for i, (name, b, s, t, h, kv, off, win, int8, dtype, d) in enumerate(
            gen_k5_cases()):
        q, kn, vn, kb, vb = gen_k5_inputs(b, s, t, h, kv, int8, dtype, d,
                                          200 + i, dev)
        before = dict(A.stats)
        got, kb, vb = G.cached_attention(q, kn, vn, kb, vb,
                                         G.CachePlan(off, b, s, kb),
                                         d ** -0.5, window=win)
        forms = {k_: A.stats[k_] - before[k_] for k_ in
                 ("kernel_launches", "decode_launches", "tile_launches",
                  "combine_launches")}
        want = G.cached_attention_plain(q, kb, vb, off, d ** -0.5, win)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        ratio = k5_ratio(got, want, tol)
        err = (got.float() - want.float()).abs().max().item()
        tiled = A.tile_capable(dtype, torch.int8 if int8 else dtype, d) \
            and s >= 2
        want_forms = {"kernel_launches": 1,
                      "decode_launches": 0 if tiled else 1,
                      "tile_launches": 1 if tiled else 0,
                      "combine_launches": 0 if tiled else 1}
        if not torch.isfinite(got.float()).all() or not ratio <= 1.0 \
                or forms != want_forms:
            raise AssertionError(f"generate K5 {name}: ratio {ratio}, max "
                                 f"abs err {err}, launches {forms} (want "
                                 f"{want_forms})")
        if tol == BF16_TOL:
            worst = max(worst, err)
        checks.append(dict(name=name, max_abs_err=err, ratio=ratio,
                           forms=forms))
        print(f"generate K5 check ok: {name}: B {b} S {s} T {t} H {h}/{kv} "
              f"offset {off} window {win} {'int8' if int8 else dtype}: "
              f"max_abs_err={err:.3e} ratio {ratio:.3f} (tol {tol}), "
              f"launches {forms}", flush=True)
        del q, kn, vn, kb, vb, got, want

    # planted faults: the kernel's output against the plain version over a
    # cache written one slot late, and over a window one key too wide
    bf16 = torch.bfloat16
    for fault in ("a cache slot written at offset + 1",
                  "the window off by one"):
        win = GEN_FAULT_WINDOW if fault.startswith("the window") else None
        q, kn, vn, kb, vb = gen_k5_inputs(8, 1, 64, 32, 32, False, bf16,
                                          128, 300, dev)
        kb2, vb2 = _clone_cache(kb), _clone_cache(vb)
        got, kb, vb = G.cached_attention(q, kn, vn, kb, vb,
                                         G.CachePlan(40, 8, 1, kb),
                                         128 ** -0.5, window=win)
        want = G.cached_attention_plain(q, kb, vb, 40, 128 ** -0.5, win)
        if not k5_ratio(got, want, BF16_TOL) <= 1.0:
            raise AssertionError(f"generate K5 fault probe: {fault}: the "
                                 "kernel itself fails the check")
        if win:
            bad = G.cached_attention_plain(q, kb, vb, 40, 128 ** -0.5,
                                           win + 1)
        else:
            idx = torch.tensor([41], device=dev)
            kb2.index_copy_(1, idx, kn.to(kb2.dtype))
            vb2.index_copy_(1, idx, vn.to(vb2.dtype))
            bad = G.cached_attention_plain(q, kb2, vb2, 40, 128 ** -0.5)
        ratio = k5_ratio(got, bad, BF16_TOL)
        if not ratio > 1.0:
            raise AssertionError(f"the generate K5 check passes a planted "
                                 f"fault: {fault}: ratio {ratio}")
        print(f"planted fault rejected: generate K5 {fault}: ratio "
              f"{ratio:.2f}", flush=True)

    # K5 at the decode step's shape, context in the middle of 513-639
    b, h, d = GEN_BATCH, 32, 128
    t = GEN_PROMPT + GEN_NEW
    off = GEN_PROMPT + GEN_NEW // 2
    q, kn, vn, kb, vb = gen_k5_inputs(b, 1, t, h, h, False, bf16, d, 400,
                                      dev)
    plan = G.CachePlan(off, b, 1, kb)
    G.cached_attention(q, kn, vn, kb, vb, plan, d ** -0.5)
    q2 = q.reshape(b, h, d)
    kp, vp = (x.view(-1, 16, h, d) for x in (kb, vb))
    ms = graph_ms(lambda: A.planned_attention(
        q2, kp, vp, plan.page_table, plan.context_lens, plan.k5,
        scale=d ** -0.5), iters=20)
    plain_ms = cuda_ms(lambda: G.cached_attention_plain(
        q, kb, vb, off, d ** -0.5), iters=5, warmup=1)
    ctx = off + 1
    qs = q.transpose(1, 2)
    ks, vs = (x[:, :ctx].transpose(1, 2) for x in (kb, vb))
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, scale=d ** -0.5), iters=20)
    # q read and out written once, every row's live K/V once, the page
    # table and the per-row metadata; 4 D flops per (row, head, key)
    nbytes = (2 * q.numel() * 2 + 2 * b * ctx * h * d * 2
              + 4 * (b * (t // 16) + 4 * b))
    flops = 4 * b * h * ctx * d
    bound_ms, bound_by = bound(nbytes, flops)
    timing = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                  flops=flops, context=ctx, batch=b)
    print(f"kernel time generate decode (B {b}, context {ctx}, H=KV {h}): "
          f"K5 {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {flops} "
          "flop)", flush=True)
    return worst, checks, timing


def gen_program(model):
    """The model's most recently used generate program: its static
    buffers, its graphs and what its last call left (the beam's best
    scores, the speculative rounds' acceptance)."""
    return next(reversed(model._gen_cache.values()))


def _gen_counts():
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import attention as A
    return {**A.stats, **{f"gen_{k}": v for k, v in G.stats.items()}}


def _gen_reset():
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import attention as A
    A.reset_stats()
    G.reset_stats()


def gen_expected(forwards, on_card, fetches, captured=0):
    """The counts of a generate call: ``forwards`` = [(layers, tokens a
    row, times)], each K5 call through the tile form (bf16 pages, >= 2
    tokens) or the split form and its combine; on the CPU the plain
    version instead. Every forward after the first of a call is a graph
    replay (``replays``)."""
    want = dict.fromkeys(("kernel_launches", "decode_launches",
                          "tile_launches", "combine_launches",
                          "plain_calls", "gen_plain_calls"), 0)
    for layers, s, times, tiled in forwards:
        n = layers * times
        if not on_card:
            want["gen_plain_calls"] += n
            continue
        want["kernel_launches"] += n
        if tiled and s >= 2:
            want["tile_launches"] += n
        else:
            want["decode_launches"] += n
            want["combine_launches"] += n
    want["gen_host_fetches"] = fetches
    want["gen_graphs_captured"] = captured
    return want


def gen_check_counts(what, want, replays):
    got = _gen_counts()
    got_sub = {k: got[k] for k in want}
    if got_sub != want:
        raise AssertionError(f"generate {what}: counts {got_sub}, want "
                             f"{want}")
    if got["gen_graph_replays"] != replays:
        raise AssertionError(f"generate {what}: {got['gen_graph_replays']} "
                             f"graph replays, want {replays}: a step ran "
                             "outside its graph")
    return got


def gpt_dense_logits(model, ids):
    """GPT's logits over ``ids [1, S]`` with plain float32 attention (the
    dense reference of the generate checks)."""
    import torch
    from paddle_tpu_torch.nn.functional import gelu
    from paddle_tpu_torch.ops.flash_attention import _attention_ref
    gm = model.gpt
    s = ids.shape[1]
    x = gm.wte(ids) + gm.wpe(torch.arange(s, device=ids.device))[None]
    for blk in gm.h:
        at = blk.attn
        qkv = at.qkv_proj(blk.ln_1(x)).reshape(1, s, 3, at.nh, at.hd)
        q, k, v = qkv.unbind(dim=2)
        out = _attention_ref(q.float(), k.float(), v.float(),
                             causal=True).to(x.dtype)
        x = x + at.out_proj(out.reshape(1, s, at.nh * at.hd))
        x = x + blk.fc_out(gelu(blk.fc_in(blk.ln_2(x)), approximate=True))
    return model.lm_head(gm.ln_f(x)).float()


def dense_logits(model, seq):
    """[len(seq), V] float32 logits of one dense forward (plain float32
    attention) over the token row ``seq``."""
    import torch
    ids = torch.as_tensor(seq, device=model.device).long()[None]
    with torch.inference_mode():
        if hasattr(model, "gpt"):
            return gpt_dense_logits(model, ids)[0]
        return model.lm_head(model.llama(ids)[0]).float()


def gen_dense_check(model, prompts, toks, margin, what, first_logits=None,
                    adjust=None, cos_min=COSINE_MIN):
    """Each row of a greedy generate result against one dense forward over
    its prompt and its tokens but the last: the first token's prefill
    logits within cosine COSINE_MIN of the dense ones (when given), and,
    teacher-forced, each token the dense argmax (after ``adjust``, the
    logit processors of the call) wherever the dense top-2 margin exceeds
    ``margin``. Returns per-row readings and the dense logits."""
    import numpy as np
    import torch
    rows, dense_all = [], []
    for r, p in enumerate(prompts):
        tk = np.asarray(toks[r])
        dense = dense_logits(model, np.concatenate([p, tk[:-1]]))[
            p.size - 1:]
        if adjust is not None:
            dense = adjust(dense, p, tk)
        dense_all.append(dense)
        top2 = dense.topk(2, dim=-1).values
        mg = (top2[:, 0] - top2[:, 1]).cpu()
        agree = dense.argmax(-1).cpu() == torch.as_tensor(tk).long()
        firm = mg > margin
        bad = (firm & ~agree).nonzero()[:, 0].tolist()
        rd = dict(row=r, firm=int(firm.sum()), agree=int(agree.sum()),
                  disagree_firm=bad)
        if first_logits is not None:
            got = first_logits[r].float()
            cos = torch.nn.functional.cosine_similarity(got, dense[0],
                                                        dim=0).item()
            rd["cosine"] = cos
            if not (cos >= cos_min and int(got.argmax()) == int(tk[0])):
                raise AssertionError(
                    f"generate {what} row {r}: first-token cosine {cos} "
                    f"(>= {cos_min}) or its argmax {int(got.argmax())} "
                    f"!= the first token {int(tk[0])}")
        rows.append(rd)
        if bad:
            raise AssertionError(f"generate {what} row {r}: tokens {bad} "
                                 "differ from the dense argmax past the "
                                 f"margin {margin}")
    cos = [r["cosine"] for r in rows if "cosine" in r]
    print(f"generate dense check {what}: {len(rows)} rows, "
          f"{sum(r['agree'] for r in rows)} of {sum(len(t) for t in toks)} "
          f"tokens the dense argmax, {sum(r['firm'] for r in rows)} past "
          f"the margin {margin}, none disagreeing there"
          + (f"; first-token cosine min {min(cos):.6f}" if cos else ""),
          flush=True)
    return rows, dense_all


def rp_adjust(rp, min_new, eos):
    """The logit processors of a ``repetition_penalty`` / ``min_new_tokens``
    call, applied to dense logits ``[N, V]`` row by row (the seen set is
    the prompt and the tokens before each position)."""
    import torch

    def adjust(dense, p, tk):
        out = dense.clone()
        seen = torch.zeros(dense.shape[1], dtype=torch.bool,
                           device=dense.device)
        seen[torch.as_tensor(p, device=dense.device).long()] = True
        for j in range(dense.shape[0]):
            lg = out[j]
            out[j] = torch.where(seen, torch.where(lg > 0, lg / rp, lg * rp),
                                 lg)
            if j + 1 <= min_new:
                out[j, eos] = float("-inf")
            seen[int(tk[j])] = True
        return out
    return adjust


def first_divergence(a, b):
    """Per row the first index where the token rows differ (None if
    equal)."""
    import numpy as np
    out = []
    for x, y in zip(np.asarray(a), np.asarray(b)):
        d = np.nonzero(x != y)[0]
        out.append(int(d[0]) if d.size else None)
    return out


def dense_score(dense, toks, eos, lenpen):
    """A beam's score from dense logits: the summed log-probs of its tokens
    up to and including the first ``eos``, over the GNMT penalty of that
    length when ``lenpen``."""
    import torch
    lp = torch.log_softmax(dense, dim=-1)
    n = len(toks)
    for j, t_ in enumerate(toks):
        if t_ == eos:
            n = j + 1
            break
    idx = torch.as_tensor(toks[:n], device=dense.device).long()
    score = lp[torch.arange(n, device=dense.device), idx].sum().item()
    if lenpen:
        score /= ((5.0 + n) / 6.0) ** lenpen
    return score


def dense_margins(model, prompts, toks):
    """Per row the dense top-2 margin [new] at each of its tokens (one
    dense forward over the prompt and the tokens but the last)."""
    import numpy as np
    out = []
    for r, p in enumerate(prompts):
        top = dense_logits(model, np.concatenate(
            [p, np.asarray(toks[r])[:-1]]))[p.size - 1:].topk(2).values
        out.append((top[:, 0] - top[:, 1]).cpu())
    return out


def short_round_ties(prog, margins, k, new, tie, what):
    """The speculative rounds of a self-draft that stopped before ``k``
    proposals. In each, the rows whose own proposal was rejected there
    (their accepted count is the round's, the batch minimum) must sit
    within ``tie`` of a tie in the dense logits at that token: the
    draft's single-token steps and the verify's S = k+1 forward run
    other kernels and round apart, which can flip only a near-tie.
    ``margins``: :func:`dense_margins` of the call's tokens. Returns
    [(token, accepted, rejecting rows, their margins)]."""
    rows_acc = prog.accepted_rows[:len(prog.accepted)].cpu()
    out, pos = [], 1
    for r, m in enumerate(prog.accepted):
        if m < k and pos + m < new:
            rej = (rows_acc[r] == m).nonzero()[:, 0].tolist()
            gaps = [float(margins[row][pos + m]) for row in rej]
            if not rej or max(gaps) > tie:
                raise AssertionError(
                    f"generate speculative {what}: the round at token {pos} "
                    f"stopped after {m} proposals; rows {rej} rejected "
                    f"there at dense margins {gaps} (a tie is <= {tie})")
            out.append((pos, m, rej, gaps))
        pos += m + 1
    return out


def gen_timed(model, ids, smi, label, on_card, **kw):
    """One generate configuration's readings: the prefill time (a call
    with max_new_tokens=1, the second of two), the full call (the second
    of two, so its graph is already captured), decode tokens/s over the
    full call less the prefill, the decode step p50 over 16 single
    replays of its graph, graphs captured and replayed, peak memory."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import generation as G

    def sync():
        if on_card:
            torch.cuda.synchronize()

    b = ids.shape[0]
    new = kw.get("max_new_tokens")
    times = {}
    for key, n in (("prefill", 1), ("full", new)):
        for _ in range(2):
            sync()
            replays = G.stats["graph_replays"]
            t0 = time.perf_counter()
            kw_n = {**kw, "max_new_tokens": n}
            if "min_new_tokens" in kw:
                kw_n["min_new_tokens"] = min(kw["min_new_tokens"], n)
            out = model.generate(ids, **kw_n)
            times[key] = time.perf_counter() - t0
    replays = G.stats["graph_replays"] - replays
    prog = gen_program(model)
    step_s = []
    if on_card:
        prog.rewind()
        for _ in range(16):
            sync()
            t0 = time.perf_counter()
            prog.run("step", prog.step)
            sync()
            step_s.append(time.perf_counter() - t0)
    decode_s = times["full"] - times["prefill"]
    rd = dict(card=smi, label=label, batch=b, prompt=ids.shape[1],
              new_tokens=new, prefill_s=times["prefill"],
              call_s=times["full"],
              decode_tok_s=b * (new - 1) / decode_s if decode_s > 0 else None,
              step_p50_s=(float(np.percentile(step_s, 50)) if step_s
                          else None),
              graphs_captured=len(prog.graphs), graph_replays=replays,
              peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                            if on_card else None))
    print(f"generate {label} [{smi}]: prefill (TTFT) {rd['prefill_s']:.4f} s "
          f"(B {b} x {ids.shape[1]}), call {rd['call_s']:.4f} s for {new} "
          f"tokens, decode {rd['decode_tok_s']:.1f} tok/s, step p50 "
          f"{rd['step_p50_s']} s, graphs {rd['graphs_captured']} captured, "
          f"{rd['graph_replays']} replayed in the call, peak memory "
          f"{rd['peak_mem_gib']} GiB", flush=True)
    return rd, out


def profile_generate(model, n_steps, smi, label):
    """``torch.profiler`` over ``n_steps`` replays of the greedy decode
    step's graph (rewound to just after the prefill), beside the untraced
    wall of ``n_steps`` replays just before, as ``profile_decode`` does."""
    import torch
    prog = gen_program(model)

    def step():
        prog.run("step", prog.step)

    prog.rewind()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    prog.rewind()
    what = (f"{label} generate decode step (B {GEN_BATCH}, ctx "
            f"{GEN_PROMPT}-{GEN_PROMPT + n_steps + 1})")
    out = trace_steps(step, n_steps, what, smi)
    out["untraced_wall_ms"] = wall_ms
    print(f"profile [{smi}]: {what}: untraced wall {wall_ms:.3f} ms, device "
          f"busy {out['device_ms']:.3f} ms (idle "
          f"{100 * (1 - out['device_ms'] / wall_ms):.1f} %), "
          f"{out['kernels']:.0f} kernels", flush=True)
    return out


def gen_prompts(rng, b, s, vocab):
    import numpy as np
    return [rng.integers(3, vocab, s).astype(np.int32) for _ in range(b)]


def generate_llama(cfg, smi, dev=None, profile_steps=0, batch=GEN_BATCH,
                   prompt=GEN_PROMPT, new=GEN_NEW, beam=(GEN_BEAM_BATCH,
                   GEN_BEAMS, GEN_BEAM_NEW), draft_layers=2):
    """generate() over LLaMA-2-7B at full width and depth: greedy, sampled
    (twice with one seed, once with another), repetition penalty +
    min_new_tokens + eos, the int8 cache, beam search (with and without
    the length penalty and eos), speculative decoding with a self-draft
    and with a ``draft_layers``-layer draft; exact counts and the dense,
    beam-score and speculative checks."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models import generation as G

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    rng = np.random.default_rng(10)
    prompts = gen_prompts(rng, batch, prompt, cfg.vocab_size)
    ids = torch.as_tensor(np.stack(prompts), device=model.device)
    res = {}

    def counted(what, fn, forwards, fetches, replays, captured):
        _gen_reset()
        out = fn()
        got = gen_check_counts(what, gen_expected(forwards, on_card, fetches,
                                                  captured if on_card else 0),
                               replays if on_card else 0)
        print(f"generate {what}: counts ok {got}", flush=True)
        return out, got

    tiled = cfg.dtype == "bfloat16"
    vanilla = [(L, prompt, 1, tiled), (L, 1, new - 1, tiled)]
    # greedy: the first call captures the step's graph, the second replays
    greedy, counts = counted(
        "greedy (first call)", lambda: model.generate(ids, new), vanilla,
        1, new - 1, 1)
    greedy2, counts2 = counted(
        "greedy", lambda: model.generate(ids, new), vanilla, 1, new - 1, 0)
    if not torch.equal(greedy, greedy2):
        raise AssertionError("generate greedy: two calls differ")
    res["greedy_counts"] = counts2
    caches = model._init_caches(batch, prompt + new)
    with torch.inference_mode():
        first = model._forward_cached(ids, caches, 0)[0][:, -1].float()
    del caches
    res["greedy_dense"], _ = gen_dense_check(model, prompts, greedy.numpy(),
                                             MARGIN, "greedy", first)
    res["greedy"], _ = gen_timed(model, ids, smi, "llama2_7b greedy",
                                 on_card, max_new_tokens=new)
    if on_card:
        res["profile"] = profile_generate(model, max(profile_steps,
                                                     PROFILE_STEPS), smi,
                                          "llama2_7b")

    samp = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
    s1, _ = counted("sampled seed 1", lambda: model.generate(
        ids, new, seed=1, **samp), vanilla, 1, new - 1, 1)
    s1b, _ = counted("sampled seed 1 again", lambda: model.generate(
        ids, new, seed=1, **samp), vanilla, 1, new - 1, 0)
    s2, _ = counted("sampled seed 2", lambda: model.generate(
        ids, new, seed=2, **samp), vanilla, 1, new - 1, 0)
    if not torch.equal(s1, s1b) or torch.equal(s1, s2):
        raise AssertionError("generate sampling: one seed twice must give "
                             "equal tokens and another seed others")
    res["sampled_differ_frac"] = float((s1 != s2).float().mean())
    res["sampled"], _ = gen_timed(model, ids, smi, "llama2_7b sampled",
                                  on_card, max_new_tokens=new, seed=1,
                                  **samp)
    print(f"generate sampled: seed 1 twice equal, seed 2 differs in "
          f"{100 * res['sampled_differ_frac']:.1f} % of the tokens",
          flush=True)

    min_new = min(16, new // 2)
    rpkw = dict(repetition_penalty=1.2, min_new_tokens=min_new,
                eos_token_id=GEN_EOS)
    rp, _ = counted("repetition penalty + min_new_tokens + eos",
                    lambda: model.generate(ids, new, **rpkw), vanilla, 1,
                    new - 1, 1)
    rpn = rp.numpy()
    for row in rpn:
        hit = np.nonzero(row == GEN_EOS)[0]
        if hit.size and (hit[0] < min_new
                         or (row[hit[0]:] != GEN_EOS).any()):
            raise AssertionError(f"generate rp: eos misplaced in {row}")
    res["rp_dense"], _ = gen_dense_check(
        model, prompts, rpn, MARGIN, "repetition penalty + min_new_tokens",
        adjust=rp_adjust(1.2, min_new, GEN_EOS))
    res["rp"], _ = gen_timed(model, ids, smi, "llama2_7b rp+min_new+eos",
                             on_card, max_new_tokens=new, **rpkw)

    q8, _ = counted("int8 cache", lambda: model.generate(
        ids, new, cache_dtype="int8"), vanilla, 1, new - 1, 1)
    res["int8_dense"], _ = gen_dense_check(model, prompts, q8.numpy(),
                                           INT8_MARGIN, "int8 cache")
    res["int8"], _ = gen_timed(model, ids, smi, "llama2_7b int8 cache",
                               on_card, max_new_tokens=new,
                               cache_dtype="int8")
    res["int8_vs_bf16_equal_frac"] = float((q8 == greedy).float().mean())

    # beam search on the first rows, with greedy on the same rows
    bb, kk, bn = beam
    bids = ids[:bb]
    bprompts = prompts[:bb]
    g_b, _ = counted("greedy on the beam rows", lambda: model.generate(
        bids, bn), [(L, prompt, 1, tiled), (L, 1, bn - 1, tiled)], 1, bn - 1,
        1)
    beam_fw = [(L, prompt, 1, tiled), (L, 1, bn - 1, tiled)]
    beams = {}
    for lp, eos in ((0.6, GEN_EOS), (0.0, None)):
        what = f"beam {bb} x {kk} length_penalty {lp} eos {eos}"
        out, _ = counted(what, lambda: model.generate(
            bids, bn, num_beams=kk, length_penalty=lp, eos_token_id=eos),
            beam_fw, 1, bn - 1, 1)
        scores = gen_program(model).best_scores.float().cpu().tolist()
        dense = [dense_logits(model, np.concatenate(
            [p, out[r].numpy()[:-1]]))[p.size - 1:]
            for r, p in enumerate(bprompts)]
        rescored = [dense_score(d_, out[r].tolist(), -1 if eos is None
                                else eos, lp) for r, d_ in enumerate(dense)]
        tol = BEAM_TOL_PER_TOKEN * bn
        diffs = [abs(a - b_) for a, b_ in zip(scores, rescored)]
        if max(diffs) > tol:
            raise AssertionError(f"generate {what}: reported scores {scores}"
                                 f" vs dense re-scores {rescored} (tol {tol})")
        beams[lp] = dict(scores=scores, rescored=rescored, out=out)
        print(f"generate {what}: best scores {scores}, dense re-scores "
              f"{rescored} (|diff| <= {max(diffs):.4f}, tol {tol})",
              flush=True)
    g_dense = [dense_logits(model, np.concatenate(
        [p, g_b[r].numpy()[:-1]]))[p.size - 1:] for r, p in enumerate(
            bprompts)]
    g_scores = [dense_score(d_, g_b[r].tolist(), -1, 0.0)
                for r, d_ in enumerate(g_dense)]
    tol = BEAM_TOL_PER_TOKEN * bn
    for r, (bs_, gs_) in enumerate(zip(beams[0.0]["rescored"], g_scores)):
        if bs_ < gs_ - tol:
            raise AssertionError(f"generate beam row {r}: best beam's score "
                                 f"{bs_} below greedy's {gs_} - {tol}")
    res["beam"] = dict(greedy_scores=g_scores, **{
        f"lenpen_{k}": dict(scores=v["scores"], rescored=v["rescored"])
        for k, v in beams.items()})
    print(f"generate beam: no length penalty, no eos: best beam (dense "
          f"re-score) {beams[0.0]['rescored']} >= greedy {g_scores} - {tol}",
          flush=True)
    res["beam_timed"], _ = gen_timed(
        model, bids, smi, f"llama2_7b beam {bb}x{kk}", on_card,
        max_new_tokens=bn, num_beams=kk, length_penalty=0.6,
        eos_token_id=GEN_EOS)

    # speculative decoding: a self-draft, then a small draft of the width
    k = GEN_SPEC_K
    rounds_full = -(-(new - 1) // (k + 1))
    dense_greedy = [dense_logits(model, np.concatenate(
        [p, greedy[r].numpy()[:-1]]))[p.size - 1:]
        for r, p in enumerate(prompts)]
    draft_cfg = type(cfg)(**{**cfg.__dict__, "num_hidden_layers":
                             draft_layers})
    draft = LlamaForCausalLM(draft_cfg, device=dev, seed=1)
    draft.eval()
    for name, dm in (("self-draft", model), (f"{draft_layers}-layer draft",
                                             draft)):
        Ld = dm.cfg.num_hidden_layers
        _gen_reset()
        t0 = time.perf_counter()
        out = model.generate(ids, new, draft_model=dm, speculative_k=k)
        call_s = time.perf_counter() - t0
        rounds = model._last_spec_rounds
        got = _gen_counts()
        fw = [(L, prompt, 1, tiled), (L, k + 1, rounds, tiled),
              (Ld, prompt, 1, tiled), (Ld, 1, (k + 1) * rounds, tiled)]
        want = gen_expected(fw, on_card, rounds + 1, 1 if on_card else 0)
        if {k_: got[k_] for k_ in want} != want or \
                got["gen_graph_replays"] != (rounds if on_card else 0):
            raise AssertionError(f"generate speculative {name}: counts "
                                 f"{got}, want {want} and {rounds} replays")
        div = first_divergence(out.numpy(), greedy.numpy())
        for r, j in enumerate(div):
            if j is not None:
                top2 = dense_greedy[r][j].topk(2).values
                gap = float(top2[0] - top2[1])
                if gap > MARGIN:
                    raise AssertionError(
                        f"generate speculative {name} row {r}: departs from "
                        f"vanilla greedy at token {j}, dense margin {gap}")
        sd, _ = gen_dense_check(model, prompts, out.numpy(), MARGIN,
                                f"speculative {name}")
        prog = gen_program(model)
        spec = dict(rounds=rounds, rounds_full=rounds_full, call_s=call_s,
                    counts=got, diverge=div, dense=sd,
                    accepted=prog.accepted)
        if dm is model:
            # a self-draft accepts every proposal but where the draft's
            # and the verify's kernels round a near-tie apart
            spec["short_rounds"] = short_round_ties(
                prog, dense_margins(model, prompts, out.numpy()), k, new,
                MARGIN, f"{name} (bf16)")
        res[f"spec_{name}"] = {k_: v for k_, v in spec.items()
                               if k_ != "counts"}
        print(f"generate speculative {name} (k {k}): {rounds} rounds "
              f"(full acceptance {rounds_full}), accepted a round "
              f"{prog.accepted}, {call_s:.3f} s for {new} "
              f"tokens x {batch} rows ({batch * (new - 1) / call_s:.1f} "
              f"tok/s with the prefill), departures from vanilla greedy "
              f"{div}; K5 {got['kernel_launches']} launches (tile "
              f"{got['tile_launches']}, split {got['decode_launches']}), "
              f"{got['gen_host_fetches']} host fetches, "
              f"{got['gen_graph_replays']} replays"
              + (f"; short rounds (token, accepted, rejecting rows, their "
                 f"dense margins) {spec['short_rounds']}"
                 if "short_rounds" in spec else ""), flush=True)
    del draft
    res["counts"] = counts2
    return res


def generate_spec_f32(cfg, smi, dev=None, batch=GEN_BATCH, prompt=GEN_PROMPT,
                      new=GEN_NEW, k=GEN_SPEC_K):
    """Speculative decoding with a self-draft over LLaMA-2-7B in float32
    at full width and depth, where the draft's single-token steps and the
    verify's S=k+1 forward differ only by float32 summation order: the
    tokens must be vanilla greedy's and the rounds ceil((new - 1) / (k +
    1)), a departure or a row's rejection allowed only at a tie within
    F32_TIE of the dense logits (K5's split form for every token: float32
    queries)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    prompts = gen_prompts(np.random.default_rng(12), batch, prompt,
                          cfg.vocab_size)
    ids = torch.as_tensor(np.stack(prompts), device=model.device)
    greedy = model.generate(ids, new)
    _gen_reset()
    t0 = time.perf_counter()
    out = model.generate(ids, new, draft_model=model, speculative_k=k)
    call_s = time.perf_counter() - t0
    prog = gen_program(model)
    rounds, accepted = model._last_spec_rounds, prog.accepted
    fw = [(L, prompt, 2, False), (L, k + 1, rounds, False),
          (L, 1, (k + 1) * rounds, False)]
    gen_check_counts("speculative self-draft float32", gen_expected(
        fw, on_card, rounds + 1, 1 if on_card else 0),
        rounds if on_card else 0)
    rounds_full = -(-(new - 1) // (k + 1))
    div = first_divergence(out.numpy(), greedy.numpy())
    ties = []
    if any(j is not None for j in div):
        mg = dense_margins(model, prompts, greedy.numpy())
        for r, j in enumerate(div):
            if j is not None and float(mg[r][j]) > F32_TIE:
                raise AssertionError(
                    f"generate speculative float32 row {r}: departs from "
                    f"vanilla greedy at token {j}, dense margin "
                    f"{float(mg[r][j])} > {F32_TIE}")
            if j is not None:
                ties.append(("diverge", r, j))
    if rounds != rounds_full:
        ties += [("short round", *t_) for t_ in short_round_ties(
            prog, dense_margins(model, prompts, out.numpy()), k, new,
            F32_TIE, "self-draft float32")]
    res = dict(rounds=rounds, rounds_full=rounds_full, accepted=accepted,
               call_s=call_s, diverge=div, ties=ties,
               peak_mem_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if on_card else None))
    print(f"generate speculative self-draft float32 [{smi}] (k {k}): "
          f"{rounds} rounds (full acceptance {rounds_full}), accepted "
          f"{accepted}; tokens equal to vanilla greedy: "
          f"{all(j is None for j in div)} (ties {ties}); {call_s:.3f} s",
          flush=True)
    return res


def generate_other(cfg, smi, label, dev=None, shape=GEN_MISTRAL):
    """Greedy generate() over one more model (Mistral-7B past its window,
    GPT-3 1.3B): exact counts, the dense checks, the readings."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    b, s, new = shape
    gpt = not hasattr(cfg, "rope_theta")
    model = (GPTForCausalLM if gpt else LlamaForCausalLM)(cfg, device=dev,
                                                          seed=0)
    model.eval()
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(11)
    prompts = gen_prompts(rng, b, s, cfg.vocab_size)
    ids = torch.as_tensor(np.stack(prompts), device=model.device)
    tiled = cfg.dtype == "bfloat16"
    fw = [(L, s, 1, tiled), (L, 1, new - 1, tiled)]
    res = {}
    for i in range(2):
        _gen_reset()
        out = model.generate(ids, new)
        got = gen_check_counts(f"{label} greedy", gen_expected(
            fw, on_card, 1, (1 - i) if on_card else 0),
            (new - 1) if on_card else 0)
    res["counts"] = got
    caches = model._init_caches(b, s + new)
    with torch.inference_mode():
        first = model._forward_cached(ids, caches, 0)[0][:, -1].float()
    del caches
    res["dense"], _ = gen_dense_check(model, prompts, out.numpy(), MARGIN,
                                      f"{label} greedy", first)
    res["timed"], _ = gen_timed(model, ids, smi, f"{label} greedy", on_card,
                                max_new_tokens=new)
    print(f"generate {label}: counts ok {got}", flush=True)
    return res


def generate_phase(smi, dev=None, profile_steps=0):
    """The ``generate`` phase: K5 through ``cached_attention`` at
    generate's shapes against its plain version, then LLaMA-2-7B,
    Mistral-7B and GPT-3 1.3B at full width and depth, bf16, random
    weights."""
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig
    res = {"k5": gen_kernel_checks(dev or "cuda")}
    res["llama"] = generate_llama(LlamaConfig.llama2_7b(
        dtype="bfloat16", use_flash_attention=False), smi, dev,
        profile_steps)
    gc.collect()
    res["spec_f32"] = generate_spec_f32(LlamaConfig.llama2_7b(
        dtype="float32", use_flash_attention=False), smi, dev)
    gc.collect()
    res["mistral"] = generate_other(LlamaConfig.mistral_7b(
        dtype="bfloat16", use_flash_attention=False), smi, "mistral_7b", dev,
        GEN_MISTRAL)
    gc.collect()
    res["gpt"] = generate_other(GPTConfig.gpt3_1_3b(
        dtype="bfloat16", hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0), smi, "gpt3_1_3b", dev, GEN_GPT)
    return res


# -- weight-only quantization: K7 and the quantized paths ---------------------

# K7 at the main path's (k, n): LLaMA-2-7B's q/k/v/o, gate/up and down,
# Mistral-7B's k/v (n 1024) and GPT-3 1.3B's fused qkv with its bias
K7_SHAPES = (("llama2_7b q/k/v/o", 4096, 4096, False),
             ("llama2_7b gate/up", 4096, 11008, False),
             ("llama2_7b down", 11008, 4096, False),
             ("mistral_7b k/v", 4096, 1024, False),
             ("gpt3_1_3b qkv", 2048, 6144, True),
             ("k % 64 = 32 (bf16 decode on CUDA cores)", 4128, 1024, False))
# group sizes where the shape's k is not a multiple of 64 or 128 (24: not
# a multiple of 16 either, so each element looks its scale up)
K7_GROUP_FOR = {(4128, 64): 24, (4128, 128): 96}
# rows: decode 1 and 8, odd 3 and 17, the verify round's 40, a prefill
# chunk's 256, a ragged step's 264 and a long prefill's 4096
K7_MS = (1, 3, 8, 17, 40, 256, 264, 4096)
K7_F32_MS = (1, 3, 40, 264)
K7_ARMS = (("weight_only_int8", -1), ("weight_only_int4", -1),
           ("weight_only_int8", 64), ("weight_only_int4", 128))
K7_TIMED_MS = (1, 8, 40, 256)
K7_ROW = ("llama2_7b gate/up", 8)   # the JSON rows' shape and rows
K7_TILE_ROW = ("llama2_7b gate/up", 256)
A8_SX = 3.25                          # an activation absmax (A8 cases)
INT8_PEAK_OPS = 1979e12
QUANT_NEW = 32
QUANT_COMBO_LAYERS = 8
QUANT_SHARED = 256                    # the combo run's shared prefix
QUANT_GEN = (8, 512, 128)             # LLaMA-2-7B greedy, int8
QUANT_GEN_GPT = (8, 128, 32)          # GPT-3 1.3B greedy, int8 (its bias)
TRUNK_RATIO = {"int8": 0.51, "int4": 0.26}


def llama_linears(cfg):
    """The (k, n) of a LLaMA layer's seven products."""
    h, m = cfg.hidden_size, cfg.intermediate_size
    kv = (cfg.num_key_value_heads or cfg.num_attention_heads) * (
        h // cfg.num_attention_heads)
    return [(h, h), (h, kv), (h, kv), (h, h), (h, m), (h, m), (m, h)]


def gpt_linears(cfg):
    """The (k, n) of a GPT block's four biased products."""
    h, m = cfg.hidden_size, cfg.intermediate_size
    return [(h, 3 * h), (h, h), (h, m), (m, h)]


def k7_expected(linears, forwards, on_card, layers):
    """K7's counts over ``forwards`` = [(rows a forward, forwards)]: one
    call a product, layer and forward, through the form K7's plan picks
    for its shape (bf16), the tile form's second kernel where it splits
    K; on the CPU the plain version instead."""
    import torch
    from paddle_tpu_torch.ops import weight_only_kernel as WK
    want = dict.fromkeys(WK.stats, 0)
    for m, times in forwards:
        for k, n in linears:
            c = layers * times
            if not on_card:
                want["plain_calls"] += c
                continue
            form, _, splits = WK.plan(m, n, k, torch.bfloat16)
            want["kernel_launches"] += c
            want["tile_launches" if form else "decode_launches"] += c
            want["finish_launches"] += c * (form == 1 and splits > 1)
    return want


def trunk_weight_bytes(model):
    """Bytes of every Linear of the trunk (``lm_head`` apart), weights or
    codes and scales, and biases."""
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear
    total = 0
    for name, mod in model.named_modules():
        if "lm_head" in name:
            continue
        if isinstance(mod, WeightOnlyLinear):
            ts = [mod.qweight, mod.weight_scale, mod.bias]
        elif type(mod).__name__ == "Linear":
            ts = [mod.weight, mod.bias]
        else:
            continue
        total += sum(t.numel() * t.element_size() for t in ts
                     if t is not None)
    return total


def first_cosines(f32, prompts, first_logits, rows):
    """Cosine of each of ``rows``' first-token logits with the last
    prompt token's logits of a dense forward of ``f32``."""
    import torch
    out = []
    for i in rows:
        dense = dense_logits(f32, prompts[i])[-1]
        out.append(torch.nn.functional.cosine_similarity(
            first_logits[i].float(), dense, dim=0).item())
    return out


def quant_twin(model):
    """A float32 model of a weight-only model's weights: each
    WeightOnlyLinear a float32 Linear holding the weights K7 multiplies
    by (its codes dequantized in the model's dtype, the scale and then
    each weight rounded there, as the JAX package's), every other tensor
    widened. Its dense forward (float32 attention) is the quantized
    paths' reference."""
    import copy
    import torch
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.quant import WeightOnlyLinear
    from paddle_tpu_torch.ops.weight_only_kernel import dequantize
    # generate's programs hold CUDA graphs, which do not copy
    programs = model.__dict__.pop("_gen_cache", None)
    try:
        twin = copy.deepcopy(model)
    finally:
        if programs is not None:
            model._gen_cache = programs
    dtype = next(model.parameters()).dtype
    for mod in list(twin.modules()):
        for name, sub in list(mod.named_children()):
            if not isinstance(sub, WeightOnlyLinear):
                continue
            lin = Linear(sub.in_features, sub.out_features,
                         bias=sub.bias is not None, device="meta")
            w = dequantize(sub.qweight, sub.weight_scale,
                           sub.weight_dtype == "int4", dtype)
            lin.weight = torch.nn.Parameter(w.float(), requires_grad=False)
            if sub.bias is not None:
                lin.bias = torch.nn.Parameter(sub.bias.detach().float(),
                                              requires_grad=False)
            setattr(mod, name, lin)
            del sub, w
    return twin.float()


def k7_case(k, n, m, algo, group, dtype, bias, seed, dev):
    """Random weights N(0, 0.02) quantized by ``weight_quantize`` on the
    card, x N(0, 1) in ``dtype``, a bias N(0, 0.02) in ``dtype``."""
    import torch
    from paddle_tpu_torch.nn.quant import weight_quantize
    g = torch.Generator(device=dev).manual_seed(seed)
    w = (torch.randn(n, k, generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    codes, scale = weight_quantize(w, algo=algo, group_size=group)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    b = ((torch.randn(n, generator=g, device=dev) * 0.02).to(dtype)
         if bias else None)
    return dict(w=w, codes=codes, scale=scale, x=x, b=b,
                int4=algo.endswith("int4"))


def k7_ratio(got, want, bias, dtype):
    """The largest |got - want| / tol over the elements (pass <= 1). bf16:
    the sums differ only in order, so the roundings to bf16 may land one
    ulp apart (an ulp is at most 2^-7 of the value): tol = 2^-7 |want| +
    2^-10 RMS(want); with a bias, the sum's rounding and the bias add's
    each: tol = 2^-7 (2 |want| + |bias|) + 2^-10 RMS(want). float32: tol
    = 1e-5 |want| + 1e-4 RMS(want), the sum's order over k <= 11008."""
    import torch
    g, w = got.float(), want.float()
    rms = w.pow(2).mean().sqrt()
    if dtype == torch.bfloat16:
        if bias is None:
            tol = 2 ** -7 * w.abs() + 2 ** -10 * rms
        else:
            tol = (2 ** -7 * (2 * w.abs() + bias.float().abs())
                   + 2 ** -10 * rms)
    else:
        tol = 1e-5 * w.abs() + 1e-4 * rms
    return ((g - w).abs() / tol).max().item()


def k7_faults(dev):
    """The plain outputs as a K7 with one fault would give them, held to
    the same check: int4 nibbles swapped, a group's scale read from the
    next group's column, the last k column dropped (int8 and int4)."""
    import torch
    from paddle_tpu_torch.ops import weight_only_kernel as WK
    out = []
    for algo, group in (("weight_only_int4", 128), ("weight_only_int8", 64)):
        c = k7_case(4096, 4096, 8, algo, group, torch.bfloat16, False, 41,
                    dev)
        args = (c["x"], c["codes"], c["scale"], None)
        want = WK.weight_only_matmul_plain(*args, int4=c["int4"])
        q = c["codes"]
        if c["int4"]:
            swapped = ((q.to(torch.int32) & 0xF) << 4) | (
                (q.to(torch.int32) >> 4) & 0xF)
            swapped = torch.where(swapped >= 128, swapped - 256,
                                  swapped).to(torch.int8)
            out.append(("int4 nibbles swapped", WK.weight_only_matmul_plain(
                c["x"], swapped, c["scale"], int4=True), want, None))
        out.append((f"{algo[-4:]} g{group}: a group's scale from the next "
                    "column", WK.weight_only_matmul_plain(
                        c["x"], q, torch.roll(c["scale"], 1, dims=1)
                        .contiguous(), int4=c["int4"]), want, None))
        dropped = q.clone()
        if c["int4"]:
            dropped[:, -1] = dropped[:, -1] & 0x0F     # k - 1: high nibble
        else:
            dropped[:, -1] = 0
        out.append((f"{algo[-4:]} g{group}: the last k column dropped",
                    WK.weight_only_matmul_plain(c["x"], dropped, c["scale"],
                                                int4=c["int4"]), want, None))
    return out


def k7_work(k, n, m, int4, groups, itemsize, bias):
    """(bytes, operations) one call needs: x, codes, scales, bias read and
    y written once; 2 m n k operations."""
    nbytes = (m * k * itemsize + n * k // (2 if int4 else 1)
              + n * groups * 4 + m * n * itemsize
              + (n * itemsize if bias else 0))
    return nbytes, 2 * m * n * k


def k7_checks(dev="cuda"):
    """K7 against its plain version in every arm and form (both dtypes,
    int8 / int4, per-channel and grouped scales, with and without bias,
    at K7_MS rows; float32 at K7_F32_MS), the planted faults rejected,
    and A8 equal bit for bit. Returns (worst ratio, max abs err, A8
    readings)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import weight_only_kernel as WK

    worst, max_err, seed = 0.0, 0.0, 0
    for name, k, n, bias in K7_SHAPES:
        for algo, group in K7_ARMS:
            for dtype, ms in ((torch.bfloat16, K7_MS),
                              (torch.float32, K7_F32_MS)):
                for m in ms:
                    seed += 1
                    c = k7_case(k, n, m, algo,
                                K7_GROUP_FOR.get((k, group), group), dtype,
                                bias, seed, dev)
                    args = (c["x"], c["codes"], c["scale"], c["b"])
                    got = WK.weight_only_matmul_cuda(*args, int4=c["int4"])
                    want = WK.weight_only_matmul_plain(*args,
                                                       int4=c["int4"])
                    torch.cuda.synchronize()
                    r = k7_ratio(got, want, c["b"], dtype)
                    err = (got.float() - want.float()).abs().max().item()
                    if not (r <= 1.0 and torch.isfinite(got).all()):
                        raise AssertionError(
                            f"K7 {name} {algo} g{group} {dtype} M {m}: "
                            f"ratio {r} > 1 (max abs err {err})")
                    worst, max_err = max(worst, r), max(max_err, err)
        print(f"K7 {name} (k {k}, n {n}{', bias' if bias else ''}): every "
              f"arm within tolerance, worst ratio so far {worst:.3f}",
              flush=True)
    for what, got, want, b in k7_faults(dev):
        r = k7_ratio(got, want, b, torch.bfloat16)
        if r <= 1.0:
            raise AssertionError(f"K7 planted fault passed the check: "
                                 f"{what} (ratio {r})")
        print(f"K7 planted fault rejected: {what} (ratio {r:.1f})",
              flush=True)
    a8 = []
    for out_dtype in (torch.bfloat16, torch.float32):
        for m in (1, 3, 8, 40, 264):
            g = torch.Generator(device=dev).manual_seed(100 + m)
            k, n = 4096, 11008
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            codes = torch.randint(-127, 128, (n, k), generator=g,
                                  device=dev, dtype=torch.int8)
            scale = torch.rand(n, generator=g, device=dev) * 0.1 + 1e-3
            sx = np.float32(A8_SX) / np.float32(127.0)
            got = WK.int8_matmul_cuda(x, codes, scale, sx, out_dtype)
            want = WK.int8_matmul_plain(x, codes, scale, sx, out_dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"K7 A8 M {m} {out_dtype}: not bit-equal (max diff "
                    f"{(got.float() - want.float()).abs().max().item()})")
            bad = codes.clone()
            bad[0, :64] = -bad[0, :64]      # one row's first codes negated
            if torch.equal(got, WK.int8_matmul_plain(x, bad, scale, sx,
                                                     out_dtype)):
                raise AssertionError("K7 A8: changed codes went unseen")
            a8.append(dict(m=m, out_dtype=str(out_dtype)))
    print("K7 A8 arm: bit-equal to its plain version at M 1, 3, 8, 40, 264 "
          "(bf16 and float32 out); changed codes rejected", flush=True)
    return worst, max_err, a8


def k7_timings(smi, dev="cuda"):
    """K7 at the timed shapes: its time from CUDA-graph replays beside its
    plain version's, cuBLAS bf16 on the unquantized weight (what the bf16
    engine runs; never called on the quantized path) and the bound; A8 at
    the row shape beside its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import weight_only_kernel as WK

    out = {}
    for name, k, n, bias in K7_SHAPES[:-1]:
        for algo in ("weight_only_int8", "weight_only_int4"):
            for m in K7_TIMED_MS:
                c = k7_case(k, n, m, algo, -1, torch.bfloat16, bias, 7, dev)
                args = (c["x"], c["codes"], c["scale"], c["b"])
                wb = c["w"]
                ms = graph_ms(lambda: WK.weight_only_matmul_cuda(
                    *args, int4=c["int4"]), 20)
                plain = graph_ms(lambda: WK.weight_only_matmul_plain(
                    *args, int4=c["int4"]), 5)
                lib = graph_ms(lambda: F.linear(c["x"], wb, c["b"]), 20)
                nb, ops = k7_work(k, n, m, c["int4"], 1, 2, bias)
                b_ms, b_by = bound(nb, ops)
                form = WK.plan(m, n, k, torch.bfloat16)
                key = f"{name} {algo[-4:]} M {m}"
                out[key] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                bound_ms=b_ms, bound_by=b_by,
                                form="tile" if form[0] else "decode",
                                splits=form[2])
                print(f"K7 {key} [{smi}]: {ms:.4f} ms ({out[key]['form']}"
                      f" form) | bound {b_ms:.4f} ms ({b_by}) | plain "
                      f"{plain:.4f} | cuBLAS bf16 unquantized {lib:.4f}",
                      flush=True)
    k, n = 4096, 11008
    m = K7_ROW[1]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    codes = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=dev) * 0.1 + 1e-3
    sx = np.float32(A8_SX) / np.float32(127.0)
    xb = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    wb = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
    ms = graph_ms(lambda: WK.int8_matmul_cuda(x, codes, scale, sx,
                                              torch.bfloat16), 20)
    # the plain version builds its constants on the host: not capturable
    plain = cuda_ms(lambda: WK.int8_matmul_plain(x, codes, scale, sx,
                                                 torch.bfloat16), 3)
    lib = graph_ms(lambda: F.linear(xb, wb), 20)
    nb = m * k + n * k + n * 4 + m * n * 2
    b_ms, b_by = bound(nb, 2 * m * n * k, INT8_PEAK_OPS)
    out["a8"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                     bound_by=b_by)
    print(f"K7 A8 llama2_7b gate/up M {m} [{smi}]: {ms:.4f} ms | bound "
          f"{b_ms:.4f} ms ({b_by}) | plain {plain:.4f} | cuBLAS bf16 "
          f"{lib:.4f}", flush=True)
    return out


def ptq_drive(dev="cuda"):
    """PTQ over LLaMA-2-7B's MLP width (4096 -> 11008 -> 4096, bf16):
    calibrate on 4 batches, convert, one batch of 8 tokens through K7's
    A8 arm (2 launches, no plain call); the output within the int8
    grid's error of the float model's. Returns K7's counts."""
    import torch
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.ops import weight_only_kernel as WK
    from paddle_tpu_torch.quantization import PTQ, QuantizedInferenceLinear
    torch.manual_seed(0)
    net = torch.nn.Sequential(Linear(4096, 11008), torch.nn.ReLU(),
                              Linear(11008, 4096)).to(dev, torch.bfloat16)
    ptq = PTQ()
    ptq.quantize(net)
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randn(8, 4096, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(5)]
    with torch.inference_mode():
        for b in batches[:4]:
            net(b)
        ref = net(batches[4]).float()
    ptq.convert(net)
    if not all(isinstance(net[i], QuantizedInferenceLinear) for i in (0, 2)):
        raise AssertionError("PTQ convert left a Linear")
    WK.reset_stats()
    with torch.inference_mode():
        got = net(batches[4]).float()
    counts = dict(WK.stats)
    if counts["a8_launches"] != 2 or counts["plain_calls"]:
        raise AssertionError(f"PTQ drive: K7 counts {counts}")
    rel = ((got - ref).norm() / ref.norm()).item()
    if not rel < 0.05:
        raise AssertionError(f"PTQ drive: relative error {rel} against the "
                             "float model")
    print(f"PTQ drive: 2 A8 launches, no plain call; relative error "
          f"{rel:.4f} against the unquantized MLP", flush=True)
    return dict(counts=counts, rel_err=rel)


def quant_combo(smi, dev=None, cfg=None, draft_layers=SPEC_DRAFT_LAYERS,
                shared=QUANT_SHARED, num_pages=KV_POOL_PAGES, new=QUANT_NEW):
    """One int8 engine with ``ragged=True``, ``cache_dtype="int8"``, the
    prefix cache and a ``draft_layers``-layer draft (not converted),
    against the bucketed int8 engine with the int8 cache, over prompts
    that share a ``shared``-token prefix, all greedy: streams equal but
    at a dense tie; K7's launches what each class's dispatches make (the
    draft's classes none), no plain call; prefix hits."""
    import numpy as np
    import torch
    import dataclasses
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import weight_only_kernel as WK
    from paddle_tpu_torch.serving import ServingEngine

    on_card = torch.device(dev or "cuda").type == "cuda"
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=QUANT_COMBO_LAYERS,
                                       dtype="bfloat16",
                                       use_flash_attention=False)
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    model.eval()
    draft = LlamaForCausalLM(dataclasses.replace(
        cfg, num_hidden_layers=draft_layers), device=dev, seed=1)
    draft.eval()
    rng = np.random.default_rng(12)
    head = rng.integers(1, cfg.vocab_size, shared).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        1, cfg.vocab_size, n).astype(np.int32)]) for n in PROMPT_LENS]
    streams, out = {}, {}
    for label, kw in (("bucketed", {}),
                      ("ragged+prefix+draft", dict(
                          ragged=True, prefix_cache=True, draft_model=draft,
                          speculative_k=SPEC_K))):
        eng = ServingEngine(model, page_size=PAGE_SIZE, num_pages=num_pages,
                            max_batch=8, prefill_chunk=256, device=dev,
                            cache_dtype="int8", weight_quant="int8", **kw)
        warm_up(eng, cfg.vocab_size)
        before = {key: sc.dispatches for key, sc in eng._classes.items()}
        WK.reset_stats()
        rids = [eng.add_request(p, max_new_tokens=new, seed=1000 + i)
                for i, p in enumerate(prompts)]
        res = eng.run()
        streams[label] = [res[r]["tokens"] for r in rids]
        counts = dict(WK.stats)
        per = 7 * L if on_card else 0
        want = 0
        for key, sc in eng._classes.items():
            mine = 0 if key[0].startswith("draft") else per
            if on_card and sc.graph is not None and \
                    sc.wo_launches["kernel_launches"] != mine:
                raise AssertionError(f"the graph of {key} captured K7 "
                                     f"{sc.wo_launches}, want {mine} calls")
            want += mine * (sc.dispatches - before.get(key, 0))
        if counts["kernel_launches"] != want or (
                on_card and counts["plain_calls"]):
            raise AssertionError(f"quant {label}: K7 counts {counts}, want "
                                 f"{want} calls and no plain call")
        m = eng.metrics
        out[label] = dict(k7_counts=counts,
                          prefix_hit_pages=m.prefix_hit_pages.value,
                          spec_rounds=m.spec_rounds.value)
        print(f"quant combo {label}: {len(rids)} requests, K7 {counts}; "
              f"prefix hit pages {m.prefix_hit_pages.value}, spec rounds "
              f"{m.spec_rounds.value}", flush=True)
        del eng
    if out["ragged+prefix+draft"]["prefix_hit_pages"] <= 0:
        raise AssertionError("quant combo: the prefix cache never hit")
    twin = quant_twin(model)
    reqs = [dict(seed=1000 + i) for i in range(len(prompts))]
    out["departures"] = departures(twin, prompts, streams["bucketed"],
                                   streams["ragged+prefix+draft"], reqs,
                                   MARGIN, "quant combo")
    print(f"quant combo: {len(prompts) - len(out['departures'])} of "
          f"{len(prompts)} streams equal, the others departing at a dense "
          f"tie (request, token, margin): {out['departures']}", flush=True)
    return out


def quant_generate(cfg, smi, label, shape, dev=None):
    """Greedy generate() over a model converted to int8 (``lm_head``
    apart): K5's and K7's counts exact (K7: its products, a layer and
    forward, the prefill through the tile form, each decode step the
    decode form), every decode step a graph replay; the dense checks on
    its float32 twin; the readings."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM
    from paddle_tpu_torch.nn.quant import convert_to_weight_only
    from paddle_tpu_torch.ops import weight_only_kernel as WK

    on_card = torch.device(dev or "cuda").type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    b, s, new = shape
    gpt = not hasattr(cfg, "rope_theta")
    model = (GPTForCausalLM if gpt else LlamaForCausalLM)(cfg, device=dev,
                                                          seed=0)
    model.eval()
    convert_to_weight_only(model, exclude=("lm_head",))
    L = cfg.num_hidden_layers
    linears = gpt_linears(cfg) if gpt else llama_linears(cfg)
    rng = np.random.default_rng(13)
    prompts = gen_prompts(rng, b, s, cfg.vocab_size)
    ids = torch.as_tensor(np.stack(prompts), device=model.device)
    fw = [(L, s, 1, True), (L, 1, new - 1, True)]
    k7_want = k7_expected(linears, [(b * s, 1), (b, new - 1)], on_card, L)
    for i in range(2):
        _gen_reset()
        WK.reset_stats()
        out = model.generate(ids, new)
        gen_check_counts(f"{label} greedy", gen_expected(
            fw, on_card, 1, (1 - i) if on_card else 0),
            (new - 1) if on_card else 0)
        if dict(WK.stats) != k7_want:
            raise AssertionError(f"generate {label}: K7 counts "
                                 f"{dict(WK.stats)}, want {k7_want}")
    res = {"k7_counts": dict(WK.stats)}
    caches = model._init_caches(b, s + new)
    with torch.inference_mode():
        first = model._forward_cached(ids, caches, 0)[0][:, -1].float()
    del caches
    twin = quant_twin(model)
    res["dense"], _ = gen_dense_check(twin, prompts, out.numpy(), MARGIN,
                                      f"{label} greedy", first,
                                      cos_min=COSINE_MIN_F32)
    del twin
    res["timed"], _ = gen_timed(model, ids, smi, f"{label} greedy", on_card,
                                max_new_tokens=new)
    print(f"generate {label}: K7 counts ok {res['k7_counts']}", flush=True)
    return res


def quant_phase(smi, dev=None, serve=None):
    """The ``quant`` phase: K7 against its plain version and timed, a PTQ
    drive through its A8 arm, LLaMA-2-7B served with int8 and int4
    weights at full width and depth (the serve phase's requests), the
    ragged / int8-cache / prefix / draft engine at 8 layers, and
    generate() over int8 LLaMA-2-7B and GPT-3 1.3B."""
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig
    worst, err, a8 = k7_checks(dev or "cuda")
    res = {"k7": dict(worst_ratio=worst, max_abs_err=err, a8=a8),
           "k7_timed": k7_timings(smi, dev or "cuda"),
           "ptq": ptq_drive(dev or "cuda")}
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16", use_flash_attention=False)
    for wq in ("int8", "int4"):
        gc.collect()
        r = engine_phase(cfg, smi, dev, label=f"llama2_7b {wq}",
                         weight_quant=wq)
        ratio = r["trunk_bytes_after"] / r["trunk_bytes_before"]
        if not ratio <= TRUNK_RATIO[wq]:
            raise AssertionError(f"{wq}: trunk bytes {ratio:.4f}x of bf16's "
                                 f"(want <= {TRUNK_RATIO[wq]})")
        res[wq] = r
    if serve:
        for key in ("decode_tok_s", "decode_step_p50_s", "ttft_p50_s",
                    "peak_mem_gib"):
            print(f"quant vs bf16 serve [{smi}]: {key} bf16 {serve[key]} | "
                  f"int8 {res['int8'][key]} | int4 {res['int4'][key]}",
                  flush=True)
    gc.collect()
    res["combo"] = quant_combo(smi, dev)
    gc.collect()
    res["gen_llama"] = quant_generate(cfg, smi, "llama2_7b int8", QUANT_GEN,
                                      dev)
    gc.collect()
    res["gen_gpt"] = quant_generate(GPTConfig.gpt3_1_3b(
        dtype="bfloat16", hidden_dropout_prob=0.0,
        attention_dropout_prob=0.0), smi, "gpt3_1_3b int8", QUANT_GEN_GPT,
        dev)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", metavar="PATH",
                    help="also write every number of the run to PATH as "
                         "JSON")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS training steps and "
                         "STEPS decode steps with torch.profiler and print "
                         "where the time goes")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         f"{','.join(PHASES)} (default: all)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        ap.error(f"--phases takes {','.join(PHASES)}")
    if "full_attn" in phases and "fit" not in phases:
        ap.error("full_attn holds its losses against fit's: add fit")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.cuda_build import build
    from paddle_tpu_torch.ops import KERNEL_LIBRARIES
    from paddle_tpu_torch.serving import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    build_s = build([A.KERNEL_LIBRARY, *KERNEL_LIBRARIES])
    print(f"kernels built from source in {build_s:.1f} s", flush=True)
    from paddle_tpu_torch.ops import fa_kernel as FK
    hgmma = hgmma_counts(FK.KERNEL_LIBRARY.path)
    if hgmma is None:
        print("sass: no cuobjdump in the toolkit; HGMMA not counted",
              flush=True)
    else:
        print("sass: HGMMA instructions (every arm and head_dim): "
              + ", ".join(f"{hgmma[k]} in {k} ({v})"
                          for k, v in WGMMA_KERNELS.items())
              + f", {hgmma['other']} in the library's other kernels",
              flush=True)
        none = [k for k in WGMMA_KERNELS if hgmma[k] == 0]
        if none:
            raise AssertionError(f"no HGMMA in the SASS of {none}")

    from paddle_tpu_torch.models import GPTConfig, LlamaConfig
    train_cfg = LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS,
                                      dtype="bfloat16",
                                      fuse_linear_cross_entropy=True)
    mistral_cfg = LlamaConfig.mistral_7b(num_hidden_layers=TRAIN_LAYERS,
                                         dtype="bfloat16",
                                         fuse_linear_cross_entropy=True)
    res = {"card": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "build_s": build_s,
           "hgmma": hgmma, "phase_s": {}}

    from paddle_tpu_torch.ops import flash_attention as FA
    res["dense_after"] = {}

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        res["phase_s"][name] = time.perf_counter() - t0
        print(f"phase {name}: {res['phase_s'][name]:.1f} s", flush=True)
        if name in DENSE_FREE:
            # the dense route's count since the start of the run
            res["dense_after"][name] = FA.stats["dense"]
            if FA.stats["dense"]:
                raise AssertionError(f"phase {name}: flash attention took "
                                     f"the dense route {FA.stats['dense']} "
                                     "times")
        return out

    if "kernels" in phases:
        res["k5"] = phase("kernels K5", kernel_phase)
        res["fa"] = phase("kernels K1-K3", fa_phase)
        res["adamw"] = phase("kernel K4", adamw_phase, train_cfg)
    if "masked" in phases:
        res["masked"] = phase("kernels K6 and the masked K2/K3",
                              masked_fa_phase)
    if "dropseg" in phases:
        res["dropseg"] = phase("the segment and dropout arms",
                               dropseg_phase)
    if "train" in phases:
        res["train"] = phase("train", train_phase, train_cfg, smi,
                             profile_steps=args.profile)
        res["path"] = phase("kernel path vs plain path", path_compare_phase,
                            LlamaConfig.llama2_7b(
                                num_hidden_layers=2, dtype="bfloat16",
                                fuse_linear_cross_entropy=True))
    if "mistral" in phases:
        res["mistral"] = phase("mistral", train_phase, mistral_cfg, smi,
                               profile_steps=args.profile,
                               batch=MISTRAL_BATCH, seq=MISTRAL_SEQ,
                               label="mistral_7b")
    if "packed" in phases:
        res["packed"] = phase("packed", packed_phase, mistral_cfg, smi)
        # float32, so that the sums hold to DOC_NLL_TOL: bf16 rounding
        # alone moves a document's summed NLL by ~0.3
        res["documents"] = phase(
            "packed documents vs alone", document_phase,
            LlamaConfig.mistral_7b(num_hidden_layers=2, dtype="float32"))
    if "mistral_path" in phases:
        # the window cut to 1024 at S 4096: the length at which the plain
        # attention of the comparison fits
        res["mistral_path"] = phase(
            "mistral kernel path vs plain path", path_compare_phase,
            LlamaConfig.mistral_7b(num_hidden_layers=2, dtype="bfloat16",
                                   fuse_linear_cross_entropy=True,
                                   sliding_window=MASKED_WINDOW),
            batch=1, seq=MASKED_S)
    if "gpt" in phases:
        res["gpt"] = phase("gpt", gpt_phase, GPTConfig.gpt3_1_3b(
            dtype="bfloat16"), smi, profile_steps=args.profile)
    if "gpt_path" in phases:
        res["gpt_path"] = phase(
            "gpt kernel path vs plain path", path_compare_phase,
            GPTConfig.gpt3_1_3b(num_hidden_layers=2, dtype="bfloat16"),
            batch=GPT_BATCH, seq=GPT_SEQ, gpt=True)
    if "fit" in phases:
        res["fit"] = phase("fit", fit_phase, LlamaConfig.llama2_7b(
            num_hidden_layers=FIT_LAYERS, recompute=True,
            fuse_linear_cross_entropy=True), smi)
        res["resume"] = phase("fit resume", resume_phase,
                              LlamaConfig.llama2_7b(
                                  num_hidden_layers=2,
                                  fuse_linear_cross_entropy=True,
                                  **RESUME_WIDTH))
        res["recompute"] = phase(
            "recompute vs none", recompute_equal_phase,
            LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="bfloat16",
                                  fuse_linear_cross_entropy=True),
            GPTConfig.gpt3_1_3b(num_hidden_layers=2, dtype="bfloat16"))
    if "full_attn" in phases:
        res["full_attn"] = phase("full_attn", full_attn_phase,
                                 LlamaConfig.llama2_7b(
                                     num_hidden_layers=FIT_LAYERS,
                                     recompute=True,
                                     recompute_granularity="full_attn",
                                     fuse_linear_cross_entropy=True),
                                 smi, res["fit"])
    if "offload" in phases:
        res["offload"] = phase("offload", offload_phase, smi)
    if "optimizers" in phases:
        res["optimizers"] = phase("optimizers", optimizers_phase, smi)
    if "workers" in phases:
        res["workers"] = phase("workers", workers_phase, smi)
    if "serve" in phases:
        # the dense reference forward of the engine check is plain float32
        # attention, so K5 is held against a plain reference, not K1
        res["engine"] = phase("serve", engine_phase, LlamaConfig.llama2_7b(
            dtype="bfloat16", use_flash_attention=False), smi,
            profile_steps=args.profile)
    if "ragged" in phases:
        # the serve phase's model is gone (phase() collects it): one 7B
        # model and its pool at a time
        res["ragged"] = phase(
            "ragged", engine_phase, LlamaConfig.mistral_7b(
                dtype="bfloat16", use_flash_attention=False), smi,
            profile_steps=args.profile, label="mistral_7b", ragged=True,
            prompt_lens=RAGGED_PROMPT_LENS, sampled=RAGGED_SAMPLED,
            num_pages=RAGGED_POOL_PAGES, max_seq_len=RAGGED_MAX_SEQ)
    if "spec" in phases:
        res["spec"] = phase("spec", spec_phase, smi,
                            profile_steps=args.profile)
    if "prefix" in phases:
        res["prefix"] = phase("prefix", prefix_phase, smi)
    if "generate" in phases:
        res["generate"] = phase("generate", generate_phase, smi,
                                profile_steps=args.profile)
    if res["dense_after"]:
        print(f"dense route: 0 calls after each of "
              f"{', '.join(res['dense_after'])}", flush=True)
    if "quant" in phases:
        res["quant"] = phase("quant", quant_phase, smi,
                             serve=res.get("engine"))
    if "attn_cases" in phases:
        res["attn_cases"] = phase("attn_cases", attn_cases_phase)

    kernels = kernel_rows(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(res, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    if set(phases) != set(PHASES):
        print(f"chip_smoke: ran only {args.phases}; no ok line", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = ("kernels", "masked", "dropseg", "train", "mistral", "packed",
          "mistral_path", "gpt", "gpt_path", "fit", "full_attn", "offload",
          "optimizers", "workers", "serve", "ragged", "spec", "prefix",
          "generate", "quant", "attn_cases")
# the phases of the main paths (training, serving, generate): none of them
# may take flash attention's dense route
DENSE_FREE = ("train", "mistral", "gpt", "fit", "full_attn", "offload",
              "serve", "ragged", "spec", "prefix", "generate", "quant")


def kernel_rows(res):
    """The ``kernels`` JSON rows: K5, K1, K2, K3, K6 and the masked arms
    of K2/K3 (launches from the Mistral run), K6 on the packed documents
    + window (launches from the packed run), the segment + dropout arms
    of K1-K3 (launches from the GPT run), their segment arms alone and
    K6's (launches from the ``flash_attn_unpadded`` drive), K4, each with
    its launches on its path's counted run and this run's
    measurements (K1-K3 also with their launches in the ``full_attn``
    fit run); K4 also with the clip factor (launches from the fit
    run) and with the clip, L1 and float32 grads (the resume run)."""
    rows = []
    k5 = res.get("k5")
    if k5:
        # the row's numbers are the decode form's (split + combine) at the
        # engine's decode shape; prefill_* the tile form's at its prefill
        # chunk; shapes every timed shape, GQA 32:8 too
        worst_err, timings = k5
        t, pf = timings["decode"], timings["prefill"]
        engine = res.get("engine", {})
        rows.append(dict(
            name="ragged_paged_attention", route="cuda",
            source="paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
            replaces="paddle_tpu/serving/attention.py:289",
            launches=engine.get("launches"),
            form_launches=engine.get("form_launches"),
            max_abs_err=worst_err, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], prefill_ms=pf["ms"],
            prefill_plain_ms=pf["plain_ms"], prefill_bound_ms=pf["bound_ms"],
            prefill_bound_by=pf["bound_by"],
            prefill_library_ms=pf["library_ms"], shapes=timings))
        # the ragged step's token-packed call (Mistral's GQA and window,
        # both forms over the step's plan): launches from the ragged run
        rg, ragged = timings["ragged_gqa"], res.get("ragged", {})
        rows.append(dict(
            name="ragged_paged_attention_packed_gqa_window", route="cuda",
            source="paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
            replaces="paddle_tpu/serving/attention.py:289",
            launches=ragged.get("launches"),
            form_launches=ragged.get("form_launches"),
            max_abs_err=worst_err, ms=rg["ms"], plain_ms=rg["plain_ms"],
            bound_ms=rg["bound_ms"], bound_by=rg["bound_by"],
            library_ms=rg["library_ms"]))
    if k5:
        # the engine's speculative verify step ([8, k+1], the tile form):
        # launches from the self-draft run's verify replays
        t = timings["verify"]
        rows.append(dict(
            name="ragged_paged_attention_engine_verify", route="cuda",
            source="paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
            replaces="paddle_tpu/serving/attention.py:289",
            launches=res.get("spec", {}).get("self", {}).get(
                "verify_launches"),
            max_abs_err=worst_err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}))
    if k5:
        # a prefix hit's first chunk (the tile form over cached context):
        # launches from the prefix phase's cache-on run (every chunk's)
        t = timings["prefix_hit"]
        rows.append(dict(
            name="ragged_paged_attention_prefix_hit_chunk", route="cuda",
            source="paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
            replaces="paddle_tpu/serving/attention.py:289",
            launches=res.get("prefix", {}).get("hot", {}).get(
                "tile_launches"),
            max_abs_err=worst_err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}))
    gen = res.get("generate")
    if gen:
        # cached_attention's K5 call at generate's LLaMA-2-7B decode shape:
        # launches from the greedy call's counted run (its prefill through
        # the tile form, its decode steps through the split form)
        worst_err, _, t = gen["k5"]
        counts = gen["llama"]["counts"]
        rows.append(dict(
            name="ragged_paged_attention_generate_decode", route="cuda",
            source="paddle_tpu_torch/serving/csrc/ragged_paged_attention.cu",
            replaces="paddle_tpu/serving/attention.py:289",
            launches=counts["kernel_launches"],
            form_launches={k: counts[k] for k in (
                "tile_launches", "decode_launches", "combine_launches")},
            max_abs_err=worst_err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}))
    launches = res.get("train", {}).get("launches", {})
    full_attn = res.get("full_attn", {}).get("launches", {})
    # the bf16 kernels at head_dim 64 and 128
    fwd_src = "paddle_tpu_torch/ops/csrc/fa_fwd_sm90.cuh"
    src_of = {"fwd": fwd_src, "stream": fwd_src,
              "dq": "paddle_tpu_torch/ops/csrc/fa_bwd_sm90.cuh",
              "dkv": "paddle_tpu_torch/ops/csrc/fa_bwd_sm90.cuh"}
    for key, name, replaces, count in (
            ("fwd", "flash_attention_fwd",
             "paddle_tpu/ops/pallas/_fa_kernel.py:540", "fwd_launches"),
            ("dq", "flash_attention_bwd_dq",
             "paddle_tpu/ops/pallas/_fa_kernel.py:811", "dq_launches"),
            ("dkv", "flash_attention_bwd_dkv",
             "paddle_tpu/ops/pallas/_fa_kernel.py:862", "dkv_launches")):
        if "fa" in res:
            rows.append(dict(name=name, route="cuda", source=src_of[key],
                             replaces=replaces,
                             launches=launches.get(count),
                             full_attn_launches=full_attn.get(count),
                             **_row_numbers(res["fa"][key])))
    mistral = res.get("mistral", {}).get("launches", {})
    for key, name, replaces, count in (
            ("stream", "flash_attention_fwd_stream",
             "paddle_tpu/ops/pallas/_fa_kernel.py:257", "stream_fwd_launches"),
            ("dq", "flash_attention_bwd_dq_masked",
             "paddle_tpu/ops/pallas/_fa_kernel.py:811", "dq_launches"),
            ("dkv", "flash_attention_bwd_dkv_masked",
             "paddle_tpu/ops/pallas/_fa_kernel.py:862", "dkv_launches")):
        if "masked" in res:
            rows.append(dict(name=name, route="cuda", source=src_of[key],
                             replaces=replaces,
                             launches=mistral.get(count),
                             **_row_numbers(res["masked"][key])))
    if "masked" in res:
        # K6 on the packed documents folded into the window: launches from
        # the packed run
        rows.append(dict(name="flash_attention_fwd_stream_packed",
                         route="cuda", source=src_of["stream"],
                         replaces="paddle_tpu/ops/pallas/_fa_kernel.py:257",
                         launches=res.get("packed", {}).get(
                             "launches", {}).get("stream_fwd_launches"),
                         **_row_numbers(res["masked"]["stream_packed"])))
    gpt = res.get("gpt", {}).get("launches", {})
    unpadded = res.get("dropseg", {}).get("checks", {}).get("unpadded", {})
    for key, name, replaces, count, runs in (
            ("seg_dropout_fwd", "flash_attention_fwd_seg_dropout",
             "paddle_tpu/ops/pallas/_fa_kernel.py:540", "fwd_launches", gpt),
            ("seg_dropout_dq", "flash_attention_bwd_dq_seg_dropout",
             "paddle_tpu/ops/pallas/_fa_kernel.py:811", "dq_launches", gpt),
            ("seg_dropout_dkv", "flash_attention_bwd_dkv_seg_dropout",
             "paddle_tpu/ops/pallas/_fa_kernel.py:862", "dkv_launches", gpt),
            ("seg_fwd", "flash_attention_fwd_seg",
             "paddle_tpu/ops/pallas/_fa_kernel.py:540", "fwd_launches",
             unpadded),
            ("seg_dq", "flash_attention_bwd_dq_seg",
             "paddle_tpu/ops/pallas/_fa_kernel.py:811", "dq_launches",
             unpadded),
            ("seg_dkv", "flash_attention_bwd_dkv_seg",
             "paddle_tpu/ops/pallas/_fa_kernel.py:862", "dkv_launches",
             unpadded),
            ("seg_stream", "flash_attention_fwd_stream_seg",
             "paddle_tpu/ops/pallas/_fa_kernel.py:257",
             "stream_fwd_launches", unpadded)):
        if "dropseg" in res:
            rows.append(dict(name=name, route="cuda",
                             source=src_of[key.rsplit("_", 1)[-1]],
                             replaces=replaces, launches=runs.get(count),
                             **_row_numbers(res["dropseg"][key])))
    if "adamw" in res:
        # bare (launches from the train run), with the clip factor (the
        # fit run), with the clip, L1 and float32 grads (the resume run)
        arms = res["adamw"]["arms"]
        for name, numbers, count in (
                ("adamw_multi_tensor", res["adamw"], launches),
                ("adamw_multi_tensor_clip", arms["clip"],
                 res.get("fit", {}).get("launches", {})),
                ("adamw_multi_tensor_clip_l1_f32_grad",
                 arms["clip_l1_f32_grad"],
                 res.get("resume", {}).get("launches", {}))):
            rows.append(dict(
                name=name, route="cuda",
                source="paddle_tpu_torch/ops/csrc/adamw.cu",
                replaces="paddle_tpu/ops/pallas/_adamw_kernel.py:114",
                launches=count.get("adamw_kernel_launches"),
                **_row_numbers(numbers)))
    q = res.get("quant")
    if q:
        # K7, which replaces XLA's fusion of the dequantization into the
        # dot (no Pallas kernel): its decode form at LLaMA-2-7B's gate/up
        # shape and 8 rows (launches from the int8 and int4 serve runs),
        # its tile form at a prefill chunk's 256 rows, its A8 arm
        # (launches from the PTQ drive)
        src = "paddle_tpu_torch/ops/csrc/weight_only_gemm.cu"
        err = q["k7"]["max_abs_err"]
        shape, m = K7_ROW
        tshape, tm = K7_TILE_ROW
        for name, key, launches in (
                ("weight_only_gemm_int8_decode", f"{shape} int8 M {m}",
                 q["int8"]["k7_counts"]["decode_launches"]),
                ("weight_only_gemm_int4_decode", f"{shape} int4 M {m}",
                 q["int4"]["k7_counts"]["decode_launches"]),
                ("weight_only_gemm_int8_tile", f"{tshape} int8 M {tm}",
                 q["int8"]["k7_counts"]["tile_launches"])):
            rows.append(dict(
                name=name, route="cuda", source=src,
                replaces="paddle_tpu/nn/quant/__init__.py:140 (XLA fusion, "
                         "no Pallas kernel)",
                launches=launches, max_abs_err=err,
                **{k: q["k7_timed"][key][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}))
        rows.append(dict(
            name="weight_only_gemm_a8", route="cuda", source=src,
            replaces="paddle_tpu/quantization/ptq.py:60 (XLA fusion, no "
                     "Pallas kernel)",
            launches=q["ptq"]["counts"]["a8_launches"], max_abs_err=0.0,
            **{k: q["k7_timed"]["a8"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))
    return rows


def _row_numbers(t):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {k: t[k] for k in keys}


if __name__ == "__main__":
    sys.exit(main())
