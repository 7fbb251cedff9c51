"""Paged attention: attend query tokens over K/V read through a page
table (counterpart: ``paddle_tpu/serving/attention.py``).

Two entries with the JAX package's signatures and layouts:

- :func:`paged_attention` — rectangular ``q [B, S, H, D]``, one
  page-table row per batch row;
- :func:`ragged_paged_attention` — token-packed ``q [T, H, D]`` from L
  lanes, each with its own ``(query_len, context_len, q_offset)``;
  padding tokens past ``sum(query_lens)`` attend position 0 of the last
  lane (finite garbage the caller discards).

Pages are ``[NP, PS, KV, D]`` (bf16/f32), or ``(codes int8 [NP, PS, KV,
D], scales f32 [NP, PS, KV])`` tuples for the int8 cache. Both entries
reduce to one token-level function of ``(q, pages, page_table,
context_lens, positions, token_lane)``:

- on CUDA tensors, :func:`ragged_paged_attention_cuda` launches the
  hand-written Hopper kernel (``csrc/ragged_paged_attention.cu``, the
  port of the TPU kernel ``_ragged_attention_kernel``) or raises;
- on CPU tensors, :func:`ragged_paged_attention_plain`, the plain
  PyTorch version of the same function (the JAX package's gather
  reference, one lane at a time).

``stats`` counts kernel launches and plain-version calls, so a run can
show which one its main path went through.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import KernelLibrary

__all__ = ["paged_attention", "paged_attention_ref",
           "ragged_paged_attention", "ragged_paged_attention_cuda",
           "ragged_paged_attention_plain", "quantize_q8", "stats",
           "reset_stats", "KERNEL_LIBRARY"]

# launches of the CUDA kernel / calls of the plain version
stats = {"kernel_launches": 0, "plain_calls": 0}


def reset_stats():
    for key in stats:
        stats[key] = 0


def quantize_q8(x):
    """Per-(slot, kv-head) absmax int8 quantization: ``[..., KV, D]`` →
    ``(codes int8 [..., KV, D], scales f32 [..., KV])``. Pure rounding,
    so recomputing a page reproduces it bit for bit."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    codes = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return codes.to(torch.int8), s


def _check_spmd(spmd):
    if spmd:
        raise NotImplementedError(
            "spmd=True (tensor-parallel step) is not ported to "
            "paddle_tpu_torch yet")


def paged_attention(q, k_pages, v_pages, page_table, context_lens,
                    q_offsets, *, scale, window=None, spmd=False):
    """q [B,S,H,D]; pages [NP,PS,KV,D] (or int8 tuples); page_table [B,P]
    int32 (pad = scratch page 0); context_lens [B] int32 — valid K
    tokens per row INCLUDING any just scattered; q_offsets [B] int32 —
    absolute position of each row's first query. Returns [B,S,H,D] in
    q.dtype."""
    _check_spmd(spmd)
    return _rectangular(_attend, q, k_pages, v_pages, page_table,
                        context_lens, q_offsets, scale=scale, window=window)


def _rectangular(fn, q, k_pages, v_pages, page_table, context_lens,
                 q_offsets, *, scale, window):
    """Run token-level ``fn`` on the rectangular surface: row b is a lane
    of query_len S whose tokens sit at q_offsets[b] + [0, S)."""
    b, s, nh, d = q.shape
    dev = q.device
    lane = torch.arange(b, dtype=torch.int32,
                        device=dev).repeat_interleave(s)
    pos = (q_offsets.to(torch.int32)[:, None]
           + torch.arange(s, dtype=torch.int32, device=dev)[None, :])
    out = fn(q.reshape(b * s, nh, d), k_pages, v_pages, page_table,
             context_lens, pos.reshape(-1), lane, scale=scale,
             window=window)
    return out.reshape(b, s, nh, d)


def _token_lanes(query_lens, q_offsets, t):
    """Map packed query index -> (lane, absolute position), both int32.
    Padding tokens (index >= sum(query_lens)) go to the last lane at
    position 0."""
    ql = query_lens.to(torch.int64)
    ends = torch.cumsum(ql, dim=0)
    tok = torch.arange(t, dtype=torch.int64, device=ql.device)
    lane = torch.searchsorted(ends, tok, right=True)
    lane = torch.clamp(lane, max=ql.shape[0] - 1)
    pos = q_offsets.to(torch.int64)[lane] + tok - (ends - ql)[lane]
    pos = torch.where(tok < ends[-1], pos, torch.zeros_like(pos))
    return lane.to(torch.int32), pos.to(torch.int32)


def ragged_paged_attention(q, k_pages, v_pages, page_table,
                           context_lens, query_lens, q_offsets, *,
                           scale, window=None, spmd=False):
    """q [T,H,D] lane-major packed query tokens (trailing padding up to
    T); page_table [L,P] int32 per lane; context_lens [L] int32 (>= 1 even
    for padded lanes); query_lens [L] int32 (0 for padded lanes);
    q_offsets [L] int32. Returns [T,H,D] in q.dtype; padding rows are
    garbage but finite."""
    _check_spmd(spmd)
    lane, pos = _token_lanes(query_lens, q_offsets, q.shape[0])
    return _attend(q, k_pages, v_pages, page_table, context_lens, pos,
                   lane, scale=scale, window=window)


def paged_attention_ref(q, k_pages, v_pages, page_table, context_lens,
                        q_offsets, *, scale, window=None):
    """The plain version at the rectangular [B,S] surface, on any
    device (the comparison side of the kernel's checks)."""
    return _rectangular(ragged_paged_attention_plain, q, k_pages, v_pages,
                        page_table, context_lens, q_offsets, scale=scale,
                        window=window)


def _attend(q, k_pages, v_pages, page_table, context_lens, positions,
            token_lane, *, scale, window):
    fn = (ragged_paged_attention_cuda if q.is_cuda
          else ragged_paged_attention_plain)
    return fn(q, k_pages, v_pages, page_table, context_lens, positions,
              token_lane, scale=scale, window=window)


def ragged_paged_attention_plain(q, k_pages, v_pages, page_table,
                                 context_lens, positions, token_lane, *,
                                 scale, window=None):
    """Plain PyTorch version of the kernel: token ``t`` attends its lane
    ``token_lane[t]``'s pages at absolute position ``positions[t]``.
    Each lane's pages are gathered once into a contiguous float32 view
    and scored like the JAX package's gather reference (int8: scores on
    the codes, K scales folded in after the dot, V scales into the
    probabilities). A row with no visible key comes out 0, as in the
    kernel."""
    stats["plain_calls"] += 1
    t, nh, d = q.shape
    quant = isinstance(k_pages, tuple)
    _, ps, nkv, _ = (k_pages[0] if quant else k_pages).shape
    n_keys = page_table.shape[1] * ps
    g = nh // nkv
    kpos = torch.arange(n_keys, device=q.device)
    out = torch.zeros(t, nh, d, dtype=torch.float32, device=q.device)
    for ln in torch.unique(token_lane).tolist():
        idx = (token_lane == ln).nonzero()[:, 0]
        rows = page_table[ln].long()
        qg = q[idx].reshape(-1, nkv, g, d).float()

        def gather(pages):
            return pages[rows].reshape(n_keys, *pages.shape[2:])

        if quant:
            (kq, ks), (vq, vs) = k_pages, v_pages
            sc = torch.einsum("skgd,tkd->kgst", qg,
                              gather(kq).float()) * scale
            sc = sc * gather(ks).T[:, None, None, :]
        else:
            sc = torch.einsum("skgd,tkd->kgst", qg,
                              gather(k_pages).float()) * scale
        qpos = positions[idx].long()[:, None]
        mask = (kpos[None, :] <= qpos) & (kpos[None, :]
                                          < context_lens[ln])
        if window:  # 0/None both disable
            mask = mask & (kpos[None, :] > qpos - int(window))
        sc = sc.masked_fill(~mask[None, None], float("-inf"))
        pr = torch.softmax(sc, dim=-1).nan_to_num(0.0)
        if quant:
            pr = pr * gather(vs).T[:, None, None, :]
            vg = gather(vq).float()
        else:
            vg = gather(v_pages).float()
        out[idx] = torch.einsum("kgst,tkd->skgd", pr, vg).reshape(
            -1, nh, d)
    return out.to(q.dtype)


# -- the CUDA kernel ---------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "ragged_paged_attention.cu",
    {"ragged_paged_attention": ([_P] * 10 + [_I] * 7
                                + [ctypes.c_float, _I, _I, _P], _I)})
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128, 256)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"ragged_paged_attention_cuda: {msg}")


def _check_tensor(name, x, device, dtypes, ndim):
    _require(isinstance(x, torch.Tensor), f"{name} is not a tensor")
    _require(x.device == device,
             f"{name} on {x.device}, q on {device}")
    _require(x.dtype in dtypes, f"{name} dtype {x.dtype} not in {dtypes}")
    _require(x.dim() == ndim, f"{name} has {x.dim()} dims, want {ndim}")
    _require(x.is_contiguous(), f"{name} is not contiguous")


def ragged_paged_attention_cuda(q, k_pages, v_pages, page_table,
                                context_lens, positions, token_lane, *,
                                scale, window=None):
    """Launch the Hopper kernel on ``torch.cuda.current_stream()``.

    q [T,H,D] bf16/f32 on a CUDA device; pages [NP,PS,KV,D] bf16/f32 or
    int8 ``(codes, scales [NP,PS,KV] f32)`` tuples; page_table [L,P],
    context_lens [L], positions [T], token_lane [T], all int32. D must be
    64, 128 or 256 and H/KV at most 32. Page-table entries must lie in
    [0, NP), as the allocator guarantees. Raises on anything else, and
    if the launch fails."""
    dev = q.device
    _require(dev.type == "cuda", f"q lies on {dev}; the kernel needs CUDA")
    _check_tensor("q", q, dev, tuple(_Q_CODES), 3)
    t, nh, d = q.shape
    quant = isinstance(k_pages, tuple)
    _require(quant == isinstance(v_pages, tuple),
             "k_pages and v_pages must both be int8 tuples or both not")
    if quant:
        (kp, ks), (vp, vs) = k_pages, v_pages
        for name, x in (("k_pages", kp), ("v_pages", vp)):
            _check_tensor(name, x, dev, (torch.int8,), 4)
        for name, x in (("k_scales", ks), ("v_scales", vs)):
            _check_tensor(name, x, dev, (torch.float32,), 3)
            _require(x.shape == kp.shape[:3], f"{name} shape {x.shape}")
    else:
        kp, vp, ks, vs = k_pages, v_pages, None, None
        for name, x in (("k_pages", kp), ("v_pages", vp)):
            _check_tensor(name, x, dev, (torch.float32, torch.bfloat16), 4)
    _require(vp.shape == kp.shape and vp.dtype == kp.dtype,
             "k_pages and v_pages differ in shape or dtype")
    _require(kp.data_ptr() % 16 == 0 and vp.data_ptr() % 16 == 0,
             "page pools must be 16-byte aligned (the kernel copies "
             "16-byte vectors)")
    _, ps, nkv, dk = kp.shape
    _require(dk == d, f"page head_dim {dk} != q head_dim {d}")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    _require(nh % nkv == 0 and nh // nkv <= 32,
             f"{nh} query heads over {nkv} kv heads")
    _check_tensor("page_table", page_table, dev, (torch.int32,), 2)
    nl = page_table.shape[0]
    _check_tensor("context_lens", context_lens, dev, (torch.int32,), 1)
    _require(context_lens.shape[0] == nl, "context_lens is not [L]")
    for name, x in (("positions", positions), ("token_lane", token_lane)):
        _check_tensor(name, x, dev, (torch.int32,), 1)
        _require(x.shape[0] == t, f"{name} is not [T]")
    win = int(window) if window else 0
    _require(win >= 0, f"window {window}")
    out = torch.empty_like(q)
    lib = KERNEL_LIBRARY.lib()
    with torch.cuda.device(dev):
        rc = lib.ragged_paged_attention(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            ks.data_ptr() if quant else None,
            vs.data_ptr() if quant else None,
            page_table.data_ptr(), context_lens.data_ptr(),
            positions.data_ptr(), token_lane.data_ptr(), out.data_ptr(),
            t, nh, nkv, d, ps, page_table.shape[1], win, float(scale),
            _Q_CODES[q.dtype], _KV_CODES[kp.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention kernel launch failed: cudaError {rc}")
    stats["kernel_launches"] += 1
    return out
