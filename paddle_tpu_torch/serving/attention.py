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
context_lens, positions, token_lane)``: each builds a :class:`Plan` (each
token's lane and position, and how the kernel's forms split the tokens;
:func:`paged_plan`, :func:`ragged_plan`) and calls
:func:`planned_attention`, which the serving step calls in every layer
with a plan it builds once a step:

- on CUDA tensors, :func:`ragged_paged_attention_cuda` launches the
  hand-written Hopper kernels (``csrc/ragged_paged_attention.cu``, the
  port of the TPU kernel ``_ragged_attention_kernel``) or raises;
- on CPU tensors, :func:`ragged_paged_attention_plain`, the plain
  PyTorch version of the same function (the JAX package's gather
  reference, one lane at a time).

The CUDA kernel comes in two forms, picked from shapes alone (the host
never reads a length): the split form (decode tokens: one block per
token, kv head and split of ``SPLIT_KEYS`` live keys, then a combine
kernel over the splits' partials) and the tile form (runs of >= 2
tokens of one lane: ``tile_tokens`` tokens times the GQA group as the 64
rows of a tensor-core tile). On the rectangular surface a row of S = 1
takes the split form and S >= 2 the tile form; on the token-packed
entry :func:`tile_plan` builds the tile table on the device and both
forms launch, each block serving only the tokens of its form.
:func:`split_partials_plain` and :func:`combine_splits_plain` are the
split form's two passes in plain PyTorch.

``stats`` counts wrapper calls that launched (``kernel_launches``, one
per attention call), each form's launches (``decode_launches``,
``tile_launches``, ``combine_launches``) and plain-version calls, so a
run can show which path it went through.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from ..cuda_build import KernelLibrary

__all__ = ["paged_attention", "paged_attention_ref",
           "ragged_paged_attention", "ragged_paged_attention_cuda",
           "Plan", "paged_plan", "ragged_plan", "planned_attention",
           "ragged_paged_attention_plain", "split_partials_plain",
           "combine_splits_plain", "split_count", "tile_tokens",
           "tile_capable", "tile_plan", "quantize_q8", "stats",
           "reset_stats", "KERNEL_LIBRARY", "SPLIT_KEYS"]

# calls that launched the CUDA kernels, each form's launches, calls of the
# plain version
stats = {"kernel_launches": 0, "decode_launches": 0, "tile_launches": 0,
         "combine_launches": 0, "plain_calls": 0}

SPLIT_KEYS = 256  # live keys a split of the decode form covers
TILE_ROWS = 64    # rows (tokens x GQA group) of a tile of the prefill form


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
    b, s, nh, d = q.shape
    return planned_attention(
        q.reshape(b * s, nh, d), k_pages, v_pages, page_table,
        context_lens, paged_plan(q_offsets, s), scale=scale,
        window=window).reshape(b, s, nh, d)


class Plan(NamedTuple):
    """Where a call's packed query tokens sit, built once for every
    layer of a step: each token's lane and absolute position (int32
    ``[T]``); ``rows`` = S on the rectangular ``[B, S]`` surface (token t
    of lane t // S), else None; and for the token-packed entry the tile
    form's plan from :func:`tile_plan`, ``(split_tok, tiles)``, or
    None."""
    token_lane: torch.Tensor
    positions: torch.Tensor
    rows: int | None = None
    tiles: tuple | None = None


def paged_plan(q_offsets, s):
    """The plan of the rectangular surface: row b is a lane of query_len
    S whose tokens sit at q_offsets[b] + [0, S). The kernel dispatch is
    told S, so it picks its form from the shape alone."""
    b = q_offsets.shape[0]
    dev = q_offsets.device
    lane = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(s)
    pos = (q_offsets.to(torch.int32)[:, None]
           + torch.arange(s, dtype=torch.int32, device=dev)[None, :])
    return Plan(lane, pos.reshape(-1), rows=s)


def ragged_plan(query_lens, q_offsets, t, group):
    """The plan of the token-packed entry for ``t`` tokens of ``L =
    len(query_lens)`` lanes and a GQA group of ``group`` query heads:
    each token's (lane, position) (padding tokens past
    ``sum(query_lens)`` go to the last lane at position 0) and the tile
    form's plan, all on the device with no host read."""
    lane, pos = _token_lanes(query_lens, q_offsets, t)
    return Plan(lane, pos, tiles=tile_plan(lane, tile_tokens(group),
                                           query_lens.shape[0]))


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
    nkv = (k_pages[0] if isinstance(k_pages, tuple) else k_pages).shape[2]
    plan = ragged_plan(query_lens, q_offsets, q.shape[0], q.shape[1] // nkv)
    return planned_attention(q, k_pages, v_pages, page_table, context_lens,
                             plan, scale=scale, window=window)


def paged_attention_ref(q, k_pages, v_pages, page_table, context_lens,
                        q_offsets, *, scale, window=None):
    """The plain version at the rectangular [B,S] surface, on any
    device (the comparison side of the kernel's checks)."""
    b, s, nh, d = q.shape
    plan = paged_plan(q_offsets, s)
    return ragged_paged_attention_plain(
        q.reshape(b * s, nh, d), k_pages, v_pages, page_table,
        context_lens, plan.positions, plan.token_lane, scale=scale,
        window=window).reshape(b, s, nh, d)


def planned_attention(q, k_pages, v_pages, page_table, context_lens, plan,
                      *, scale, window=None):
    """Attend the packed tokens ``q [T,H,D]`` placed by ``plan``
    (:func:`paged_plan`, :func:`ragged_plan`): the CUDA kernels on CUDA
    tensors, the plain version on CPU tensors. The serving step builds
    its plan once and calls this in every layer."""
    if not q.is_cuda:
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, page_table, context_lens, plan.positions,
            plan.token_lane, scale=scale, window=window)
    return ragged_paged_attention_cuda(
        q, k_pages, v_pages, page_table, context_lens, plan.positions,
        plan.token_lane, scale=scale, window=window, rows=plan.rows,
        tiles=plan.tiles)


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


# -- the split form's two passes, plain ------------------------------------

_LOG2E = 1.4426950408889634


def _live_keys(positions, context_lens, token_lane, max_keys, window):
    """Each token's live keys ``[kstart, kend)`` (int64 ``[T]`` each): at
    most its position, below its lane's context and the page table's
    width, and inside the window."""
    pos = positions.long()
    kend = torch.minimum(torch.minimum(pos + 1, context_lens.long()[
        token_lane.long()]), torch.full_like(pos, max_keys))
    kstart = (torch.clamp(pos - int(window) + 1, min=0) if window
              else torch.zeros_like(pos))
    return kstart, kend


def split_count(max_keys, window=None, split_keys=SPLIT_KEYS):
    """The split form's static number of splits: enough spans of
    ``split_keys`` for the most live keys a token can have (the page
    table's width in keys, or the window if that is smaller)."""
    n = min(max_keys, int(window)) if window else max_keys
    return max(1, -(-n // split_keys))


def split_partials_plain(q, k_pages, v_pages, page_table, context_lens,
                         positions, token_lane, *, scale, window=None,
                         split_keys=SPLIT_KEYS):
    """The split form's first pass in plain PyTorch: for every token t,
    query head h and split s over the live keys ``[kstart + s *
    split_keys, kstart + (s + 1) * split_keys)``, the partial ``(m, l,
    acc)`` in the kernel's units: ``m`` the largest score times log2(e)
    (-inf for an empty split), ``l = sum exp2(score * log2(e) - m)``,
    ``acc = sum exp2(...) * v`` (int8: the K scale on the score, the V
    scale on the probability). Returns float32 ``m, l [T, H, NS]`` and
    ``acc [T, H, NS, D]``."""
    t, nh, d = q.shape
    quant = isinstance(k_pages, tuple)
    _, ps, nkv, _ = (k_pages[0] if quant else k_pages).shape
    n_keys = page_table.shape[1] * ps
    ns = split_count(n_keys, window, split_keys)
    g = nh // nkv
    kstart, kend = _live_keys(positions, context_lens, token_lane, n_keys,
                              window)
    kpos = torch.arange(n_keys, device=q.device)
    m = torch.full((t, nh, ns), float("-inf"), device=q.device)
    l = torch.zeros(t, nh, ns, device=q.device)
    acc = torch.zeros(t, nh, ns, d, device=q.device)
    for tok in range(t):
        rows = page_table[int(token_lane[tok])].long()

        def gather(pages):
            return pages[rows].reshape(n_keys, *pages.shape[2:])
        qt = q[tok].float().reshape(nkv, g, d)
        if quant:  # scores on the codes, the K scale after the dot
            (kq, ks), (vq, vs) = k_pages, v_pages
            sc = torch.einsum("kgd,nkd->kgn", qt, gather(kq).float()) \
                * scale * gather(ks).T[:, None, :]
            vf, vsc = gather(vq).float(), gather(vs).T    # vsc [KV, n_keys]
        else:
            sc = torch.einsum("kgd,nkd->kgn", qt,
                              gather(k_pages).float()) * scale
            vf = gather(v_pages).float()
        x = sc * _LOG2E
        for s in range(ns):
            lo = int(kstart[tok]) + s * split_keys
            hi = min(lo + split_keys, int(kend[tok]))
            if lo >= hi:
                continue
            live = (kpos >= lo) & (kpos < hi)
            xs = x.masked_fill(~live, float("-inf"))
            ms = xs.amax(-1)                              # [KV, G]
            p = torch.exp2(xs - ms[..., None])
            pv = p * vsc[:, None, :] if quant else p
            m[tok, :, s] = ms.reshape(nh)
            l[tok, :, s] = p.sum(-1).reshape(nh)
            acc[tok, :, s] = torch.einsum("kgn,nkd->kgd", pv, vf).reshape(
                nh, d)
    return m, l, acc


def combine_splits_plain(m, l, acc, dtype=torch.float32):
    """The split form's second pass in plain PyTorch: each (token, head)'s
    partials weighted by ``exp2(m_s - max m)`` and summed, ``acc / max(l,
    1e-20)`` cast to ``dtype``; a row whose splits are all empty comes
    out 0."""
    mx = m.amax(-1, keepdim=True)
    w = torch.where(m == float("-inf"), torch.zeros_like(m),
                    torch.exp2(m - torch.where(torch.isfinite(mx), mx,
                                               torch.zeros_like(mx))))
    lt = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2) / torch.clamp(lt, min=1e-20)[..., None]
    return out.to(dtype)


# -- the tile form's plan ---------------------------------------------------

def tile_tokens(group):
    """Tokens a tile of the prefill form holds: the tile's 64 rows are
    tokens times the GQA group's query heads."""
    return max(1, TILE_ROWS // group)


def tile_capable(q_dtype, kv_dtype, head_dim):
    """Whether the tile form takes these operands: bf16 queries over bf16
    or int8 pages, head_dim 64 or 128."""
    return (q_dtype == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and head_dim in (64, 128))


def tile_plan(token_lane, tokens, n_lanes):
    """The token-packed call's plan, on ``token_lane``'s device with no
    host read: runs of consecutive tokens of one lane, cut every
    ``tokens`` tokens, are the tiles of the prefill form; a run of one
    token takes the split form. Returns ``(split_tok, tiles)``:
    ``split_tok`` int32 ``[T]``, 1 where the token takes the split form;
    ``tiles`` int32 ``[NT, 2]`` of (first token, tokens), ``NT = min(T,
    ceil(T / tokens) + n_lanes)`` (the most tiles lane-major tokens can
    form; unused slots hold 0 tokens). Tokens of a tile past that bound
    would take the split form."""
    t = token_lane.shape[0]
    dev = token_lane.device
    idx = torch.arange(t, device=dev)
    lane = token_lane.long()
    first = torch.ones(t, dtype=torch.bool, device=dev)
    first[1:] = lane[1:] != lane[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), 0).values
    run_id = torch.cumsum(first.long(), 0) - 1
    run_len = torch.zeros(t, dtype=torch.long, device=dev).scatter_add_(
        0, run_id, torch.ones_like(run_id))[run_id]
    off = idx - run_start
    opens = (off % tokens == 0) & (run_len >= 2)
    tile_id = torch.cumsum(opens.long(), 0) - 1
    n_tiles = min(t, -(-t // tokens) + n_lanes)
    in_tile = (run_len >= 2) & (tile_id < n_tiles)
    tiles = torch.zeros(n_tiles + 1, 2, dtype=torch.int32, device=dev)
    slot = torch.where(opens & (tile_id < n_tiles), tile_id, n_tiles)
    tiles[slot] = torch.stack(
        [idx, torch.clamp(run_len - off, max=tokens)], 1).to(torch.int32)
    return (~in_tile).to(torch.int32), tiles[:n_tiles].contiguous()


# -- the CUDA kernels --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "ragged_paged_attention.cu",
    {"rpa_split": ([_P] * 13 + [_I] * 9 + [_F, _I, _I, _P], _I),
     "rpa_combine": ([_P] * 5 + [_I] * 5 + [_P], _I),
     "rpa_tile": ([_P] * 10 + [_I] * 3 + [_P] + [_I] * 7 + [_F, _I, _P],
                  _I)})
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
                                scale, window=None, rows=None, tiles=None):
    """Launch the Hopper kernels on ``torch.cuda.current_stream()``.

    q [T,H,D] bf16/f32 on a CUDA device; pages [NP,PS,KV,D] bf16/f32 or
    int8 ``(codes, scales [NP,PS,KV] f32)`` tuples; page_table [L,P],
    context_lens [L], positions [T], token_lane [T], all int32. D must be
    64, 128 or 256 and H/KV at most 32. Page-table entries must lie in
    [0, NP), as the allocator guarantees. ``rows`` = S says the tokens
    are the rectangular [B, S] layout (token t of lane t // S): S = 1
    takes the split form alone, S >= 2 the tile form alone where it
    applies (:func:`tile_capable`). Without ``rows`` both forms launch
    over the tile form's plan ``tiles`` = ``(split_tok, tiles)`` of these
    tokens from :func:`tile_plan` (at the GQA group's
    :func:`tile_tokens`), built here on the device when not given.
    Raises on anything else, and if a launch fails."""
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
    _require(all(x.data_ptr() % 16 == 0 for x in (q, kp, vp)),
             "q and the page pools must be 16-byte aligned (the kernels "
             "copy 16-byte vectors)")
    _, ps, nkv, dk = kp.shape
    _require(dk == d, f"page head_dim {dk} != q head_dim {d}")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    _require(nh % nkv == 0 and nh // nkv <= 32,
             f"{nh} query heads over {nkv} kv heads")
    _check_tensor("page_table", page_table, dev, (torch.int32,), 2)
    nl, max_pages = page_table.shape
    _check_tensor("context_lens", context_lens, dev, (torch.int32,), 1)
    _require(context_lens.shape[0] == nl, "context_lens is not [L]")
    for name, x in (("positions", positions), ("token_lane", token_lane)):
        _check_tensor(name, x, dev, (torch.int32,), 1)
        _require(x.shape[0] == t, f"{name} is not [T]")
    win = int(window) if window else 0
    _require(win >= 0, f"window {window}")
    if rows is not None:
        _require(rows > 0 and t % rows == 0,
                 f"rows={rows} does not divide the {t} tokens")
    out = torch.empty_like(q)
    if t == 0:
        return out
    lib = KERNEL_LIBRARY.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
           ks.data_ptr() if quant else None,
           vs.data_ptr() if quant else None, page_table.data_ptr(),
           context_lens.data_ptr(), positions.data_ptr(),
           token_lane.data_ptr())
    g = nh // nkv
    tiled = (tile_capable(q.dtype, kp.dtype, d)
             and (t >= 2 if rows is None else rows >= 2))
    split_tok = None
    with torch.cuda.device(dev):
        if tiled:
            tt = tile_tokens(g)
            if rows is not None:
                tiles, n_tiles = None, (t // rows) * -(-rows // tt)
            else:
                split_tok, tiles = tiles or tile_plan(token_lane, tt, nl)
                n_tiles = tiles.shape[0]
            _raise_on(lib.rpa_tile(
                *ins, tiles.data_ptr() if tiles is not None else None,
                n_tiles, rows or 0, tt, out.data_ptr(), t, nh, nkv, d, ps,
                max_pages, win, float(scale), _KV_CODES[kp.dtype], stream),
                "rpa_tile")
            stats["tile_launches"] += 1
        if not tiled or rows is None:
            ns = split_count(max_pages * ps, win)
            part_m = torch.empty(t, nh, ns, dtype=torch.float32, device=dev)
            part_l = torch.empty_like(part_m)
            part_acc = torch.empty(t, nh, ns, d, dtype=torch.float32,
                                   device=dev)
            st = split_tok.data_ptr() if split_tok is not None else None
            _raise_on(lib.rpa_split(
                *ins, st, part_m.data_ptr(), part_l.data_ptr(),
                part_acc.data_ptr(), t, nh, nkv, d, ps, max_pages, win, ns,
                SPLIT_KEYS, float(scale), _Q_CODES[q.dtype],
                _KV_CODES[kp.dtype], stream), "rpa_split")
            stats["decode_launches"] += 1
            _raise_on(lib.rpa_combine(
                part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                st, out.data_ptr(), t, nh, d, ns, _Q_CODES[q.dtype],
                stream), "rpa_combine")
            stats["combine_launches"] += 1
    stats["kernel_launches"] += 1
    return out


def _raise_on(rc, which):
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention: {which} launch failed: cudaError {rc}")
