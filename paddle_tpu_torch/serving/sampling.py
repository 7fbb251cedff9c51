"""Fused sampling for the serving step (counterpart:
``paddle_tpu/serving/sampling.py::fused_sample``).

Filter semantics match the JAX package: ``top_k <= 0`` or ``>= V``
disables top-k; ``top_p <= 0`` or ``>= 1`` disables top-p; both
thresholds KEEP ties; top-p is applied after top-k on the already
filtered distribution and always keeps at least the most probable token.

Categorical sampling is Gumbel-max over the filtered,
temperature-scaled logits, and a greedy lane is the same argmax with no
noise. The noise is counter-keyed, computed on the device with tensor
ops and no host read (so the step can run as a CUDA graph): the noise of
vocabulary entry ``v`` of a lane is a pure function of ``(seed, step,
v)`` (:func:`lane_noise`), where ``step`` is the request's token index.
Token ``t`` of a request is therefore a pure function of ``(weights,
history, seed, t)``, whatever lane or batch it rides in: a preempted
request recomputes the same stream, and the ragged and bucketed steps
draw the same one. PyTorch cannot reproduce JAX's threefry bits, so a
sampled stream is reproducible within the port only. Greedy lanes match
the JAX package token for token.
"""
from __future__ import annotations

import torch

from ..ops.fa_kernel import _mul32

__all__ = ["fused_sample", "lane_noise", "lane_uniform"]

_M32 = 0xFFFFFFFF


def _fmix32(x):
    """murmur3's 32-bit finaliser on int64 ``x`` in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def lane_uniform(seeds, steps, n):
    """Uniforms ``[B, n]`` float32 in (0, 1) on ``seeds``' device, a pure
    function of each lane's ``(seed, step)`` and the column. Lane ``i``'s
    key is ``fmix32(fmix32(seed * 0x9E3779B1) ^ step * 0x85EBCA77)``;
    column ``v`` hashes ``key ^ v * 0xC2B2AE3D`` with two rounds of fmix32
    (the counter hash of ``ops/fa_kernel.keep_scale``) and takes the top
    24 bits as ``u = (bits + 0.5) / 2**24``."""
    seed = seeds.to(torch.int64) & _M32
    step = steps.to(torch.int64) & _M32
    key = _fmix32(_fmix32(_mul32(seed, 0x9E3779B1)) ^ _mul32(step,
                                                             0x85EBCA77))
    col = _mul32(torch.arange(n, dtype=torch.int64, device=seeds.device),
                 0xC2B2AE3D)
    x = _fmix32(_fmix32(key[:, None] ^ col[None, :]))
    return ((x >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def lane_noise(seeds, steps, vocab):
    """Standard Gumbel noise ``[B, V]`` float32 on ``seeds``' device:
    ``-log(-log(u))`` of :func:`lane_uniform`'s ``u``. Each row depends on
    its own ``(seed, step)`` alone."""
    return -torch.log(-torch.log(lane_uniform(seeds, steps, vocab)))


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
    gumbel = lane_noise(seeds, steps, lg.shape[1])
    sampled = torch.argmax(final + gumbel, dim=-1)
    tok = torch.where(do_sample, sampled, greedy)
    dist = torch.where(do_sample[:, None], final, lg)
    lp = torch.log_softmax(dist, dim=-1)
    return tok.to(torch.int32), lp.gather(1, tok[:, None])[:, 0]
