"""Flash-attention forward and backward: the hand-written kernels K1-K3
and K6 and their plain PyTorch versions (counterpart:
``paddle_tpu/ops/pallas/_fa_kernel.py``).

Layouts are the JAX package's: ``q, o, do [B, Sq, H, D]``, ``k, v [B,
Sk, HKV, D]`` (GQA: query head h reads kv head ``h // (H // HKV)``). The
log-sum-exp comes out as ``[B, H, Sq]`` float32 (the TPU kernel's
``[B*H, S, 128]`` lane layout is a TPU artefact: ``lse_l[:, :, 0]`` is
the same numbers). Masking is the TPU kernels' ``_masked_scores``
(:func:`masked_scores` here), in this order: causal with the diagonal
at ``Sk - Sq``; FlashMask bands (``fm_start``/``fm_end`` and optionally
``fm_start2``/``fm_end2``, each ``[B|1, H|1, Sk]`` int32: query rows
``[start_j, end_j)`` of key column j are masked); an additive float32
``mask [B|1, H|1, Sq, Sk]``; segment ids ``q_seg [B, Sq]`` / ``kv_seg
[B, Sk]`` (equal ids match, a negative id matches nothing). A row with no
live key gives out 0, lse -inf and zero gradients.

Dropout (``dropout_p`` in (0, 1) with an int ``seed``) is the TPU kernels'
counter hash ``_keep_scale`` (:func:`keep_scale` here, bit for bit): each
attention link of (flat query head ``b*H + h``, absolute row, absolute
column) is kept or not as a pure function of the seed, so the forward and
both backward passes draw the same mask. The forward's lse is undropped
and p V takes ``p * keep / (1 - p)``; dq and dk take ``dp * keep / (1 -
p)`` and dv ``(p * keep / (1 - p))^T dO``. It rides K1 and its backward
only (no mask, no band, ``Sq == Sk``), as in the JAX package.

Two entries dispatch on where the tensors lie:

- :func:`fa_forward` → :func:`fa_forward_plain` on CPU tensors; on any
  other, :func:`fa_forward_masked_cuda` (K6, the streamed masked
  forward) when there is a mask, a band or ``Sq != Sk``, as the JAX
  package routes them (``_fa_kernel.py:446``), else
  :func:`fa_forward_cuda` (K1, with its segment and dropout arms);
- :func:`fa_backward` → :func:`fa_backward_plain` on CPU tensors,
  :func:`fa_backward_cuda` (K2 for dq, then K3 for dk/dv, in the arms of
  the call) on any other.

A tensor off the CPU launches its kernel or raises (a CUDA wrapper
refuses a tensor that is not on a CUDA device); nothing falls back. As in
the JAX package, ``delta = rowsum(dO * O)`` (minus ``dlse`` when the caller
consumes the lse) is computed outside the kernels.

``stats`` counts kernel launches (one per kernel per call: K1
``fwd_launches``, K6 ``stream_fwd_launches``, K2 ``dq_launches``, K3
``dkv_launches``; of those, the launches in a segment arm
``seg_arm_launches`` and in a dropout arm ``drop_arm_launches``) and
plain-version calls, so a run can show which path it went through.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import KernelLibrary

__all__ = ["fa_forward", "fa_backward", "fa_forward_cuda",
           "fa_forward_masked_cuda", "fa_backward_cuda", "fa_dq_cuda",
           "fa_dkv_cuda", "fa_forward_plain", "fa_backward_plain",
           "masked_scores", "keep_scale", "keep_bhqk", "check_dropout",
           "check_fm_pairs", "stats", "reset_stats", "KERNEL_LIBRARY"]

stats = {"fwd_launches": 0, "stream_fwd_launches": 0, "dq_launches": 0,
         "dkv_launches": 0, "seg_arm_launches": 0, "drop_arm_launches": 0,
         "plain_fwd_calls": 0, "plain_bwd_calls": 0}


def reset_stats():
    for key in stats:
        stats[key] = 0


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def check_fm_pairs(fm_start, fm_end, fm_start2, fm_end2):
    """The bands come in pairs, and band 2 only with band 1 (the JAX
    package's ``_check_fm_pairs``): an unpaired bound would be read as
    another band's."""
    if (fm_start is None) != (fm_end is None):
        raise ValueError("FlashMask bounds must be paired: fm_start and "
                         "fm_end must both be given or both be None")
    if (fm_start2 is None) != (fm_end2 is None):
        raise ValueError("FlashMask bounds must be paired: fm_start2 and "
                         "fm_end2 must both be given or both be None")
    if fm_start2 is not None and fm_start is None:
        raise ValueError("FlashMask band 2 (fm_start2/fm_end2) requires "
                         "band 1 (fm_start/fm_end)")
    return [a for a in (fm_start, fm_end, fm_start2, fm_end2)
            if a is not None]


def check_dropout(dropout_p, seed, streamed):
    """``float(dropout_p)`` after the JAX kernels' checks: ``0 <= p < 1``,
    a seed with ``p > 0``, and no mask, band or ``Sq != Sk`` beside it
    (``streamed``: dropout rides K1 and its backward only)."""
    p = float(dropout_p)
    if p > 0.0:
        if not p < 1.0:
            raise ValueError(f"in-kernel dropout needs 0 <= p < 1, got {p}")
        if seed is None:
            raise ValueError("dropout_p > 0 requires a seed")
        if streamed:
            raise NotImplementedError(
                "in-kernel dropout rides the resident forward only (Sq == "
                "Sk, no dense mask, no FlashMask band)")
    return p


def fa_forward(q, k, v, causal=False, scale=None, return_lse=False,
               mask=None, fm_start=None, fm_end=None, fm_start2=None,
               fm_end2=None, q_seg=None, kv_seg=None, dropout_p=0.0,
               seed=None):
    """``out [B,Sq,H,D]`` in q's dtype, and with ``return_lse`` the row
    log-sum-exp ``[B,H,Sq]`` float32."""
    fm = check_fm_pairs(fm_start, fm_end, fm_start2, fm_end2)
    streamed = mask is not None or bool(fm) or q.shape[1] != k.shape[1]
    p = check_dropout(dropout_p, seed, streamed)
    kw = dict(causal=causal, scale=scale, return_lse=return_lse,
              q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return fa_forward_plain(q, k, v, mask=mask, fm=fm, dropout_p=p,
                                seed=seed, **kw)
    if streamed:
        return fa_forward_masked_cuda(q, k, v, mask=mask, fm=fm, **kw)
    return fa_forward_cuda(q, k, v, dropout_p=p, seed=seed, **kw)


def fa_backward(q, k, v, o, lse, do, causal=False, scale=None, dlse=None,
                mask=None, fm_start=None, fm_end=None, fm_start2=None,
                fm_end2=None, q_seg=None, kv_seg=None, dropout_p=0.0,
                seed=None):
    """``(dq, dk, dv)`` in the inputs' dtypes; ``dk, dv`` at the kv head
    count (the GQA group sum is taken). ``dlse [B,H,Sq]``: the cotangent
    of the lse output, folded in as ``delta - dlse``."""
    fm = check_fm_pairs(fm_start, fm_end, fm_start2, fm_end2)
    p = check_dropout(dropout_p, seed, mask is not None or bool(fm)
                      or q.shape[1] != k.shape[1])
    fn = fa_backward_plain if q.device.type == "cpu" else fa_backward_cuda
    return fn(q, k, v, o, lse, do, causal=causal, scale=scale, dlse=dlse,
              mask=mask, fm=fm, q_seg=q_seg, kv_seg=kv_seg, dropout_p=p,
              seed=seed)


def _delta(o, do, dlse):
    """``rowsum(dO * O) - dlse`` as ``[B,H,Sq]`` float32, contiguous."""
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# -- the plain versions ------------------------------------------------------

def _repeat_kv(x, g):
    return x if g == 1 else x.repeat_interleave(g, dim=2)


_M32 = 0xFFFFFFFF


def _mul32(x, m):
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``m``, in halves so that no product leaves int64."""
    return ((((x >> 16) * m) & 0xFFFF) << 16) + (x & 0xFFFF) * m & _M32


def _keep_threshold(drop_p):
    """The unsigned threshold a kept link's hash reaches and the kept
    links' float32 scale, as the JAX ``_keep_scale`` takes them: from the
    double ``p * 2**32`` and the double quotient ``1 / (1 - p)``."""
    return (min(int(drop_p * 2.0 ** 32), 2 ** 32 - 1),
            float(torch.tensor(1.0 / (1.0 - drop_p), dtype=torch.float32)))


def keep_scale(seed, bh, q0, k0, bq, bk, drop_p, device=None):
    """The TPU kernels' counter-hash dropout mask of one ``[bq, bk]`` tile
    (``_fa_kernel.py::_keep_scale``), bit for bit: ``1 / (1 - p)`` as
    float32 where the link of absolute row ``q0 + i`` and column ``k0 +
    j`` of flat query head ``bh = b*H + h`` is kept, else 0. Two rounds of
    murmur3's fmix32 over ``row * 0x9E3779B1 ^ col * 0x85EBCA77 ^ bh *
    0xC2B2AE3D ^ seed``, taken in int64 and cut to 32 bits after each
    multiply; kept where the hash, unsigned, is at least ``min(int(p *
    2**32), 2**32 - 1)``. ``bh`` may be a tensor that broadcasts against
    ``[bq, bk]`` (a ``[..., 1, 1]`` grid of heads)."""
    rows = (q0 + torch.arange(bq, dtype=torch.int64, device=device))[:, None]
    cols = (k0 + torch.arange(bk, dtype=torch.int64, device=device))[None]
    if isinstance(bh, torch.Tensor):
        bh = bh.to(device=device, dtype=torch.int64)
    else:
        bh = torch.tensor(int(bh), dtype=torch.int64, device=device)
    x = (_mul32(rows & _M32, 0x9E3779B1) ^ _mul32(cols & _M32, 0x85EBCA77)
         ^ _mul32(bh & _M32, 0xC2B2AE3D) ^ (int(seed) & _M32))
    for _ in range(2):
        x = x ^ (x >> 16)
        x = _mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = _mul32(x, 0xC2B2AE35)
        x = x ^ (x >> 16)
    thresh, sc = _keep_threshold(float(drop_p))
    return (x >= thresh).to(torch.float32) * sc


def keep_bhqk(seed, b, h, sq, sk, drop_p, device=None):
    """:func:`keep_scale` of every link, ``[B, H, Sq, Sk]`` float32 (one
    batch row at a time, to bound the int64 temporaries)."""
    heads = torch.arange(h, dtype=torch.int64, device=device)[:, None, None]
    return torch.stack([keep_scale(seed, bi * h + heads, 0, 0, sq, sk,
                                   drop_p, device) for bi in range(b)])


def masked_scores(s, causal=False, mask=None, fm=(), q_seg=None,
                  kv_seg=None):
    """The TPU kernels' ``_masked_scores`` on whole float32 score tensors
    ``s [B,H,Sq,Sk]``: causal with the diagonal at ``Sk - Sq``; each
    ``(start, end)`` pair of ``fm`` (``[B|1,H|1,Sk]`` int) masks the query
    rows ``[start_j, end_j)`` of key column j; then the additive ``mask``
    ``[B|1,H|1,Sq,Sk]`` is added; then a pair whose segment ids
    (``q_seg [B,Sq]``, ``kv_seg [B,Sk]``) differ, or are negative, is
    masked."""
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    if fm:
        rows = torch.arange(sq, device=s.device)[:, None]
        dead = torch.zeros((), dtype=torch.bool, device=s.device)
        for start, end in zip(fm[0::2], fm[1::2]):
            dead = dead | ((rows >= start[:, :, None, :].long())
                           & (rows < end[:, :, None, :].long()))
        s = s.masked_fill(dead, float("-inf"))
    if mask is not None:
        s = s + mask.float()
    if q_seg is not None:
        qs = q_seg.to(device=s.device, dtype=torch.int64)[:, None, :, None]
        ks = kv_seg.to(device=s.device, dtype=torch.int64)[:, None, None, :]
        s = s.masked_fill(~((qs == ks) & (qs >= 0)), float("-inf"))
    return s


def _scores(q, k, sc, causal=False, mask=None, fm=(), q_seg=None,
            kv_seg=None):
    """float32 masked ``[B,H,Sq,Sk]`` scores of q against (head-repeated)
    k."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    return masked_scores(s, causal, mask, fm, q_seg, kv_seg)


def _keep(q, k, dropout_p, seed):
    """The keep-and-scale factors ``[B,H,Sq,Sk]`` of a dropout call, or
    None without dropout."""
    if not dropout_p:
        return None
    b, sq, h, _ = q.shape
    return keep_bhqk(seed, b, h, sq, k.shape[1], dropout_p, q.device)


def fa_forward_plain(q, k, v, *, causal=False, scale=None,
                     return_lse=False, mask=None, fm=(), q_seg=None,
                     kv_seg=None, dropout_p=0.0, seed=None):
    """Plain PyTorch version of K1 and K6: the JAX oracle
    ``_attention_ref_lse`` (``ops/pallas/flash_attention.py:401``) with the
    kernels' masking — float32 scores, the probabilities cast to q's
    dtype before the product with V; a dead row gives 0 and lse -inf.
    With dropout the probabilities take :func:`keep_scale`'s factors
    (in float32) before that cast, and the lse stays undropped
    (``_attention_ref_hash_dropout``)."""
    stats["plain_fwd_calls"] += 1
    g = q.shape[2] // k.shape[2]
    s = _scores(q, _repeat_kv(k, g), _scale(scale, q.shape[-1]), causal,
                mask, fm, q_seg, kv_seg)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse))[..., None])
    p = p.nan_to_num(0.0)
    keep = _keep(q, k, dropout_p, seed)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype),
                       _repeat_kv(v, g).to(q.dtype)).contiguous()
    return (out, lse) if return_lse else out


def fa_backward_plain(q, k, v, o, lse, do, *, causal=False, scale=None,
                      dlse=None, mask=None, fm=(), q_seg=None, kv_seg=None,
                      dropout_p=0.0, seed=None):
    """Plain PyTorch version of K2 + K3: the oracle's vjp in closed form
    from the saved lse (exact in float32), ``p = exp(s - lse)`` where s is
    finite and 0 elsewhere, ``ds = p * (dp - delta)``; dk/dv summed over
    each kv head's query heads. With dropout, ``dp`` and dv's ``p`` take
    :func:`keep_scale`'s factors (``_fa_kernel.py:607, :676-679``)."""
    stats["plain_bwd_calls"] += 1
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    sc = _scale(scale, d)
    kf, vf = _repeat_kv(k, g).float(), _repeat_kv(v, g).float()
    qf, dof = q.float(), do.float()
    s = _scores(qf, kf, sc, causal, mask, fm, q_seg, kv_seg)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    keep = _keep(q, k, dropout_p, seed)
    pd = p
    if keep is not None:
        dp = dp * keep
        pd = p * keep
    ds = p * (dp - _delta(o, do, dlse)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sc
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sc
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, dof)
    sk = k.shape[1]
    dk = dk.reshape(b, sk, hkv, g, d).sum(3)
    dv = dv.reshape(b, sk, hkv, g, d).sum(3)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# -- the CUDA kernels --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint32
# B, Sq, Sk, H, HKV, D; scale; causal; the additive mask and its four
# element strides; the bands, their count and their band / batch / head
# strides; the segment ids of q and of k; dropout, seed, keep threshold,
# keep scale; dtype; stream
_TAIL = ([_I] * 6 + [_F, _I] + [_P] + [_L] * 4 + [_P, _I] + [_L] * 3
         + [_P, _P] + [_I, _U, _U, _F] + [_I, _P])
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"fa_forward": ([_P] * 5 + _TAIL, _I),
     "fa_forward_stream": ([_P] * 5 + _TAIL, _I),
     "fa_backward_dq": ([_P] * 7 + _TAIL, _I),
     "fa_backward_dkv": ([_P] * 8 + _TAIL, _I)})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check(q, k, v, *rest):
    """Device, dtype, shape and contiguity of q, k, v and the [B,Sq,H,D]
    tensors in ``rest``; returns ``(B, Sq, Sk, H, HKV, D)``."""
    dev = q.device
    _require(dev.type == "cuda", f"q lies on {dev}; the kernel needs CUDA")
    _require(q.dtype in _DTYPES, f"dtype {q.dtype} not in {tuple(_DTYPES)}")
    _require(q.dim() == 4 and k.dim() == 4, "q and k must be [B,S,H,D]")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _require(tuple(k.shape) == (b, sk, hkv, d) and v.shape == k.shape,
             f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(hkv > 0 and h % hkv == 0, f"{h} heads over {hkv} kv heads")
    _require(d in _HEAD_DIMS, f"head_dim {d} not in {_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v), *rest):
        _require(x.device == dev, f"{name} on {x.device}, q on {dev}")
        _require(x.dtype == q.dtype, f"{name} dtype {x.dtype} != {q.dtype}")
        _require(x.is_contiguous(), f"{name} is not contiguous")
        # the bf16 kernels move rows in 16-byte vectors
        _require(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    for name, x in rest:
        _require(x.shape == q.shape, f"{name} shape {tuple(x.shape)}")
    return b, sq, sk, h, hkv, d


def _bcast_dims(x, b, h):
    return x.shape[0] in (1, b) and x.shape[1] in (1, h)


def _mask_args(mask, fm, b, sq, sk, h, dev):
    """The masking arguments of a launch: ``(keep, args)``. ``keep``
    holds the tensors the pointers point into until the launch is
    queued; ``args`` are the additive mask's pointer and its element
    strides (0 over a broadcast dim), then the bands' pointer, count and
    band / batch / head strides (0 over a broadcast dim). The bands are
    stacked into one ``[n, MB, MH, Sk]`` int32 tensor."""
    keep = []
    margs = [None, 0, 0, 0, 0]
    if mask is not None:
        _require(mask.device == dev and mask.dtype == torch.float32
                 and mask.dim() == 4 and _bcast_dims(mask, b, h)
                 and tuple(mask.shape[2:]) == (sq, sk),
                 f"mask must be float32 [B|1, H|1, Sq, Sk] = [{b}|1, "
                 f"{h}|1, {sq}, {sk}] on {dev}, got {mask.dtype} "
                 f"{tuple(mask.shape)}")
        strides = [0 if n == 1 else st
                   for n, st in zip(mask.shape, mask.stride())]
        keep.append(mask)
        margs = [mask.data_ptr(), *strides]
    fargs = [None, 0, 0, 0, 0]
    if fm:
        for x in fm:
            _require(x.device == dev and x.dim() == 3 and x.shape[2] == sk
                     and _bcast_dims(x, b, h) and not x.is_floating_point(),
                     f"FlashMask bounds must be integer [B|1, H|1, Sk] = "
                     f"[{b}|1, {h}|1, {sk}] on {dev}, got {x.dtype} "
                     f"{tuple(x.shape)}")
        mb = max(x.shape[0] for x in fm)
        mh = max(x.shape[1] for x in fm)
        bands = torch.stack([x.expand(mb, mh, sk) for x in fm]).to(
            torch.int32).contiguous()
        keep.append(bands)
        fargs = [bands.data_ptr(), len(fm), mb * mh * sk,
                 mh * sk if mb > 1 else 0, sk if mh > 1 else 0]
    return keep, margs + fargs


def _seg_args(q_seg, kv_seg, b, sq, sk, dev):
    """``(keep, [q_seg pointer, kv_seg pointer])``: both int32 ``[B, Sq]``
    and ``[B, Sk]`` on ``dev`` (any integer type is converted), or both
    null."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("segment ids come in pairs: q_seg and kv_seg must "
                         "both be given or both be None")
    if q_seg is None:
        return [], [None, None]
    for name, x, n in (("q_seg", q_seg, sq), ("kv_seg", kv_seg, sk)):
        _require(x.device == dev and tuple(x.shape) == (b, n)
                 and not x.is_floating_point(),
                 f"{name} must be integer [B, S] = [{b}, {n}] on {dev}, got "
                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
    qs = q_seg.to(torch.int32).contiguous()
    ks = kv_seg.to(torch.int32).contiguous()
    return [qs, ks], [qs.data_ptr(), ks.data_ptr()]


def _drop_args(dropout_p, seed):
    """``[dropout, seed bits, keep threshold, keep scale]`` of a launch
    (:func:`keep_scale`'s constants, computed here as the JAX function
    computes them)."""
    if not dropout_p:
        return [0, 0, 0, 0.0]
    thresh, sc = _keep_threshold(float(dropout_p))
    return [1, int(seed) & _M32, thresh, sc]


def _count_arms(q_seg, dropout_p):
    if q_seg is not None:
        stats["seg_arm_launches"] += 1
    if dropout_p:
        stats["drop_arm_launches"] += 1


def _raise_on(rc, which):
    if rc != 0:
        raise RuntimeError(f"{which} kernel launch failed: cudaError {rc}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_forward(entry, q, k, v, causal, scale, return_lse, mask, fm,
                    q_seg, kv_seg, dropout_p, seed):
    b, sq, sk, h, hkv, d = _check(q, k, v)
    keep, margs = _mask_args(mask, fm, b, sq, sk, h, q.device)
    segs, sargs = _seg_args(q_seg, kv_seg, b, sq, sk, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        rc = getattr(KERNEL_LIBRARY.lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, sq, sk, h, hkv, d,
            _scale(scale, d), int(bool(causal)), *margs, *sargs,
            *_drop_args(dropout_p, seed), _DTYPES[q.dtype], _stream(q))
    return rc, ((out, lse) if return_lse else out)


def fa_forward_cuda(q, k, v, *, causal=False, scale=None, return_lse=False,
                    q_seg=None, kv_seg=None, dropout_p=0.0, seed=None):
    """Launch K1 on ``torch.cuda.current_stream()``: q [B,S,H,D], k/v
    [B,S,HKV,D], bf16 or float32, contiguous, on one CUDA device; D in
    (64, 128, 256); optional segment ids ``q_seg``/``kv_seg`` [B, S] and
    dropout (``dropout_p`` in (0, 1), an int ``seed``). Raises on anything
    else and if the launch fails."""
    _require(k.shape[1] == q.shape[1], f"Sq={q.shape[1]} != Sk="
             f"{k.shape[1]}: cross-length attention runs on K6")
    p = check_dropout(dropout_p, seed, False)
    rc, res = _launch_forward("fa_forward", q, k, v, causal, scale,
                              return_lse, None, (), q_seg, kv_seg, p, seed)
    _raise_on(rc, "fa_forward (K1)")
    stats["fwd_launches"] += 1
    _count_arms(q_seg, p)
    return res


def fa_forward_masked_cuda(q, k, v, *, causal=False, scale=None,
                           return_lse=False, mask=None, fm=(), q_seg=None,
                           kv_seg=None):
    """Launch K6, the streamed masked forward: as K1, and Sq may differ
    from Sk (the causal diagonal at ``Sk - Sq``), with the additive
    ``mask`` (float32 ``[B|1,H|1,Sq,Sk]``, any strides), 1 or 2
    FlashMask bands ``fm = (start, end[, start2, end2])`` (integer
    ``[B|1,H|1,Sk]``) and segment ids; k tiles that causality, the first
    band or the segment ids kill for the whole q tile are skipped. No
    dropout."""
    rc, res = _launch_forward("fa_forward_stream", q, k, v, causal, scale,
                              return_lse, mask, fm, q_seg, kv_seg, 0.0, None)
    _raise_on(rc, "fa_forward_stream (K6)")
    stats["stream_fwd_launches"] += 1
    _count_arms(q_seg, 0.0)
    return res


def fa_backward_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                     dlse=None, mask=None, fm=(), q_seg=None, kv_seg=None,
                     dropout_p=0.0, seed=None):
    """Launch K2 (dq) and K3 (dk, dv) on the current stream. ``o``,
    ``do`` like q; ``lse`` (and ``dlse``) [B,H,Sq] float32. Raises on
    anything the kernels do not take and if a launch fails."""
    _check(q, k, v, ("o", o), ("do", do))
    delta = _delta(o, do, dlse)
    kw = dict(causal=causal, scale=scale, mask=mask, fm=fm, q_seg=q_seg,
              kv_seg=kv_seg, dropout_p=dropout_p, seed=seed)
    dq = fa_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = fa_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def _backward_args(q, k, v, do, lse, delta, causal, scale, mask, fm, q_seg,
                   kv_seg, dropout_p, seed):
    b, sq, sk, h, hkv, d = _check(q, k, v, ("do", do))
    for name, x in (("lse", lse), ("delta", delta)):
        _require(x.device == q.device and x.dtype == torch.float32
                 and tuple(x.shape) == (b, h, sq) and x.is_contiguous(),
                 f"{name} must be contiguous float32 [B,H,Sq] on "
                 f"{q.device}")
    p = check_dropout(dropout_p, seed, mask is not None or bool(fm)
                      or sq != sk)
    keep, margs = _mask_args(mask, fm, b, sq, sk, h, q.device)
    segs, sargs = _seg_args(q_seg, kv_seg, b, sq, sk, q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    common = (b, sq, sk, h, hkv, d, _scale(scale, d), int(bool(causal)),
              *margs, *sargs, *_drop_args(p, seed), _DTYPES[q.dtype],
              _stream(q))
    return keep + segs, ins, common, p


def fa_dq_cuda(q, k, v, do, lse, delta, *, causal=False, scale=None,
               mask=None, fm=(), q_seg=None, kv_seg=None, dropout_p=0.0,
               seed=None):
    """K2 alone: dq from the saved lse and ``delta = rowsum(dO * O)
    [- dlse]`` ([B,H,Sq] float32), in the arms of the call (mask or
    bands, segment ids, dropout)."""
    keep, ins, common, p = _backward_args(q, k, v, do, lse, delta, causal,
                                          scale, mask, fm, q_seg, kv_seg,
                                          dropout_p, seed)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = KERNEL_LIBRARY.lib().fa_backward_dq(*ins, dq.data_ptr(),
                                                 *common)
    _raise_on(rc, "fa_backward_dq (K2)")
    stats["dq_launches"] += 1
    _count_arms(q_seg, p)
    return dq


def fa_dkv_cuda(q, k, v, do, lse, delta, *, causal=False, scale=None,
                mask=None, fm=(), q_seg=None, kv_seg=None, dropout_p=0.0,
                seed=None):
    """K3 alone: ``(dk, dv)`` at the kv head count; under dropout each
    query head of a GQA group draws its own keep mask."""
    keep, ins, common, p = _backward_args(q, k, v, do, lse, delta, causal,
                                          scale, mask, fm, q_seg, kv_seg,
                                          dropout_p, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = KERNEL_LIBRARY.lib().fa_backward_dkv(
            *ins, dk.data_ptr(), dv.data_ptr(), *common)
    _raise_on(rc, "fa_backward_dkv (K3)")
    stats["dkv_launches"] += 1
    _count_arms(q_seg, p)
    return dk, dv
