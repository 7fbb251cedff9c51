"""Fused sampling for the serving step (counterpart:
``paddle_tpu/serving/sampling.py::fused_sample``).

Filter semantics match the JAX package: ``top_k <= 0`` or ``>= V``
disables top-k; ``top_p <= 0`` or ``>= 1`` disables top-p; both
thresholds KEEP ties; top-p is applied after top-k on the already
filtered distribution and always keeps at least the most probable token.

Categorical sampling is Gumbel-max over the filtered,
temperature-scaled logits, and a greedy lane is the same argmax with no
noise. The noise of lane ``i`` comes from a ``torch.Generator`` seeded
with ``(seeds[i], steps[i])``, where ``step`` is the request's token
index, so token ``t`` of a request is a pure function of ``(weights,
history, seed, t)`` and a preempted request recomputes the same stream.
PyTorch cannot reproduce JAX's threefry bits, and its CPU and CUDA
generators differ too: a sampled stream is reproducible within the port
on one device type only. Greedy lanes match the JAX package token for
token.
"""
from __future__ import annotations

import torch

__all__ = ["fused_sample"]


def _lane_noise(seeds, steps, vocab, device):
    """Standard Gumbel noise ``[B, V]``, one generator per lane keyed on
    ``(seed, step)``."""
    rows = []
    for seed, step in zip(seeds.tolist(), steps.tolist()):
        g = torch.Generator(device=device)
        g.manual_seed(((int(seed) & 0x7FFFFFFF) << 32)
                      | (int(step) & 0xFFFFFFFF))
        u = torch.rand(vocab, generator=g, device=device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows)


def _filter_top_k(scaled, top_k):
    """Per-lane top-k mask (k<=0 disables; ties kept)."""
    v = scaled.shape[1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.long().clamp(1, v)
    kth = srt.gather(1, (k - 1)[:, None])                    # [B, 1]
    disabled = (top_k[:, None] <= 0) | (top_k[:, None] >= v)
    return disabled | (scaled >= kth)


def _filter_top_p(filtered, top_p):
    """Per-lane nucleus mask on the (already top-k-filtered) logits:
    keep the smallest set of tokens whose cumulative probability
    reaches top_p (the crossing token included; ties kept)."""
    srt = torch.sort(filtered, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]   # exclusive cumsum < p
    thr = torch.where(keep_sorted, srt,
                      torch.full_like(srt, float("inf"))).amin(dim=-1)
    disabled = (top_p[:, None] <= 0.0) | (top_p[:, None] >= 1.0)
    return disabled | (filtered >= thr[:, None])


def fused_sample(logits, do_sample, temperature, top_k, top_p, seeds,
                 steps, *, sample_capable=True):
    """Sample one token per lane.

    logits [B, V] float; do_sample bool [B]; temperature float32 [B];
    top_k int32 [B]; top_p float32 [B]; seeds/steps int32 [B], all on
    the logits' device. ``sample_capable=False`` (no lane samples) skips
    the filters and the noise.

    Returns ``(tokens int32 [B], logprobs float32 [B])`` — the logprob
    is the chosen token's log-probability under the distribution it was
    drawn from (post-filter, post-temperature for sampled lanes; the raw
    softmax for greedy lanes).
    """
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)
    if not sample_capable:
        lp = torch.log_softmax(lg, dim=-1)
        return (greedy.to(torch.int32),
                lp.gather(1, greedy[:, None])[:, 0])
    neg_inf = torch.full_like(lg, float("-inf"))
    scaled = lg / torch.clamp(temperature.float(), min=1e-6)[:, None]
    keep = _filter_top_k(scaled, top_k)
    filtered = torch.where(keep, scaled, neg_inf)
    keep = keep & _filter_top_p(filtered, top_p)
    final = torch.where(keep, scaled, neg_inf)
    gumbel = _lane_noise(seeds, steps, lg.shape[1], lg.device)
    sampled = torch.argmax(final + gumbel, dim=-1)
    tok = torch.where(do_sample, sampled, greedy)
    dist = torch.where(do_sample[:, None], final, lg)
    lp = torch.log_softmax(dist, dim=-1)
    return tok.to(torch.int32), lp.gather(1, tok[:, None])[:, 0]
