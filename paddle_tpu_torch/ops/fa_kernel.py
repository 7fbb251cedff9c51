"""Flash-attention forward and backward: the hand-written kernels K1-K3
and their plain PyTorch versions (counterpart:
``paddle_tpu/ops/pallas/_fa_kernel.py``).

Layouts are the JAX package's: ``q, o, do [B, S, H, D]``, ``k, v [B, S,
HKV, D]`` (GQA: query head h reads kv head ``h // (H // HKV)``). The log-
sum-exp comes out as ``[B, H, S]`` float32 (the TPU kernel's ``[B*H, S,
128]`` lane layout is a TPU artefact: ``lse_l[:, :, 0]`` is the same
numbers). Two entries dispatch on where the tensors lie:

- :func:`fa_forward` → :func:`fa_forward_plain` on CPU tensors,
  :func:`fa_forward_cuda` (K1) on any other;
- :func:`fa_backward` → :func:`fa_backward_plain` on CPU tensors,
  :func:`fa_backward_cuda` (K2 for dq, then K3 for dk/dv) on any other.

A tensor off the CPU launches its kernel or raises (a CUDA wrapper
refuses a tensor that is not on a CUDA device); nothing falls back. As in
the JAX package, ``delta = rowsum(dO * O)`` (minus ``dlse`` when the caller
consumes the lse) is computed outside the kernels.

This slice covers the arms the LLaMA training step runs: causal or not,
GQA, the lse output, ``Sq == Sk``. The additive mask, segment ids,
FlashMask bands and in-kernel dropout (and the streamed forward K6 that
carries them) are not ported; :mod:`.flash_attention` refuses them.

``stats`` counts kernel launches (one per kernel per call) and plain-
version calls, so a run can show which path it went through.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..cuda_build import KernelLibrary

__all__ = ["fa_forward", "fa_backward", "fa_forward_cuda",
           "fa_backward_cuda", "fa_dq_cuda", "fa_dkv_cuda",
           "fa_forward_plain", "fa_backward_plain", "stats", "reset_stats",
           "KERNEL_LIBRARY"]

stats = {"fwd_launches": 0, "dq_launches": 0, "dkv_launches": 0,
         "plain_fwd_calls": 0, "plain_bwd_calls": 0}


def reset_stats():
    for key in stats:
        stats[key] = 0


def _scale(scale, d):
    return float(scale) if scale is not None else 1.0 / (d ** 0.5)


def fa_forward(q, k, v, causal=False, scale=None, return_lse=False):
    """``out [B,S,H,D]`` in q's dtype, and with ``return_lse`` the row
    log-sum-exp ``[B,H,S]`` float32."""
    fn = fa_forward_plain if q.device.type == "cpu" else fa_forward_cuda
    return fn(q, k, v, causal=causal, scale=scale, return_lse=return_lse)


def fa_backward(q, k, v, o, lse, do, causal=False, scale=None, dlse=None):
    """``(dq, dk, dv)`` in the inputs' dtypes; ``dk, dv`` at the kv head
    count (the GQA group sum is taken). ``dlse [B,H,S]``: the cotangent
    of the lse output, folded in as ``delta - dlse``."""
    fn = fa_backward_plain if q.device.type == "cpu" else fa_backward_cuda
    return fn(q, k, v, o, lse, do, causal=causal, scale=scale, dlse=dlse)


def _delta(o, do, dlse):
    """``rowsum(dO * O) - dlse`` as ``[B,H,S]`` float32, contiguous."""
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


# -- the plain versions ------------------------------------------------------

def _repeat_kv(x, g):
    return x if g == 1 else x.repeat_interleave(g, dim=2)


def _scores(q, k, causal, sc):
    """float32 ``[B,H,Sq,Sk]`` scores of q against (head-repeated) k, the
    causal diagonal at ``Sk - Sq`` as in the JAX reference."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sc
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    return s


def fa_forward_plain(q, k, v, *, causal=False, scale=None,
                     return_lse=False):
    """Plain PyTorch version of K1: the JAX oracle ``_attention_ref_lse``
    (``ops/pallas/flash_attention.py:401``) — float32 scores, the
    probabilities cast to q's dtype before the product with V."""
    stats["plain_fwd_calls"] += 1
    g = q.shape[2] // k.shape[2]
    s = _scores(q, _repeat_kv(k, g), causal, _scale(scale, q.shape[-1]))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse,
                                  torch.zeros_like(lse))[..., None])
    p = p.nan_to_num(0.0).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p,
                       _repeat_kv(v, g).to(q.dtype)).contiguous()
    return (out, lse) if return_lse else out


def fa_backward_plain(q, k, v, o, lse, do, *, causal=False, scale=None,
                      dlse=None):
    """Plain PyTorch version of K2 + K3: the oracle's vjp in closed form
    from the saved lse (exact in float32), ``p = exp(s - lse)``, ``ds = p
    * (dp - delta)``; dk/dv summed over each kv head's query heads."""
    stats["plain_bwd_calls"] += 1
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    sc = _scale(scale, d)
    kf, vf = _repeat_kv(k, g).float(), _repeat_kv(v, g).float()
    qf, dof = q.float(), do.float()
    s = _scores(qf, kf, causal, sc)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(o, do, dlse)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sc
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sc
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    sk = k.shape[1]
    dk = dk.reshape(b, sk, hkv, g, d).sum(3)
    dv = dv.reshape(b, sk, hkv, g, d).sum(3)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


# -- the CUDA kernels --------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# B, S, H, HKV, D; scale; causal; dtype; stream
_TAIL = [_I] * 5 + [_F, _I, _I, _P]
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {"fa_forward": ([_P] * 5 + _TAIL, _I),
     "fa_backward_dq": ([_P] * 7 + _TAIL, _I),
     "fa_backward_dkv": ([_P] * 8 + _TAIL, _I)})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def _require(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check(q, k, v, *rest):
    """Device, dtype, shape and contiguity of q, k, v and the [B,S,H,D]
    tensors in ``rest``; returns ``(B, S, H, HKV, D)``."""
    dev = q.device
    _require(dev.type == "cuda", f"q lies on {dev}; the kernel needs CUDA")
    _require(q.dtype in _DTYPES, f"dtype {q.dtype} not in {tuple(_DTYPES)}")
    _require(q.dim() == 4 and k.dim() == 4, "q and k must be [B,S,H,D]")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[1] != s:
        raise NotImplementedError(
            f"Sq={s} != Sk={k.shape[1]}: cross-length attention runs on "
            "the streamed forward K6 (_fa_fwd_stream_kernel), not ported")
    _require(tuple(k.shape) == (b, s, hkv, d) and v.shape == k.shape,
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
    return b, s, h, hkv, d


def _raise_on(rc, which):
    if rc != 0:
        raise RuntimeError(f"{which} kernel launch failed: cudaError {rc}")


def fa_forward_cuda(q, k, v, *, causal=False, scale=None, return_lse=False):
    """Launch K1 on ``torch.cuda.current_stream()``: q [B,S,H,D], k/v
    [B,S,HKV,D], bf16 or float32, contiguous, on one CUDA device; D in
    (64, 128, 256). Raises on anything else and if the launch fails."""
    b, s, h, hkv, d = _check(q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = KERNEL_LIBRARY.lib()
    with torch.cuda.device(q.device):
        rc = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, s, h, hkv, d,
            _scale(scale, d), int(bool(causal)), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "fa_forward (K1)")
    stats["fwd_launches"] += 1
    return (out, lse) if return_lse else out


def fa_backward_cuda(q, k, v, o, lse, do, *, causal=False, scale=None,
                     dlse=None):
    """Launch K2 (dq) and K3 (dk, dv) on the current stream. ``o``,
    ``do`` like q; ``lse`` (and ``dlse``) [B,H,S] float32. Raises on
    anything the kernels do not take and if a launch fails."""
    _check(q, k, v, ("o", o), ("do", do))
    delta = _delta(o, do, dlse)
    dq = fa_dq_cuda(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = fa_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                         scale=scale)
    return dq, dk, dv


def _backward_args(q, k, v, do, lse, delta, causal, scale):
    b, s, h, hkv, d = _check(q, k, v, ("do", do))
    for name, x in (("lse", lse), ("delta", delta)):
        _require(x.device == q.device and x.dtype == torch.float32
                 and tuple(x.shape) == (b, h, s) and x.is_contiguous(),
                 f"{name} must be contiguous float32 [B,H,S] on {q.device}")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    common = (b, s, h, hkv, d, _scale(scale, d), int(bool(causal)),
              _DTYPES[q.dtype], torch.cuda.current_stream(q.device)
              .cuda_stream)
    return ins, common


def fa_dq_cuda(q, k, v, do, lse, delta, *, causal=False, scale=None):
    """K2 alone: dq from the saved lse and ``delta = rowsum(dO * O)
    [- dlse]`` ([B,H,S] float32)."""
    ins, common = _backward_args(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = KERNEL_LIBRARY.lib().fa_backward_dq(*ins, dq.data_ptr(),
                                                 *common)
    _raise_on(rc, "fa_backward_dq (K2)")
    stats["dq_launches"] += 1
    return dq


def fa_dkv_cuda(q, k, v, do, lse, delta, *, causal=False, scale=None):
    """K3 alone: ``(dk, dv)`` at the kv head count."""
    ins, common = _backward_args(q, k, v, do, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = KERNEL_LIBRARY.lib().fa_backward_dkv(
            *ins, dk.data_ptr(), dv.data_ptr(), *common)
    _raise_on(rc, "fa_backward_dkv (K3)")
    stats["dkv_launches"] += 1
    return dk, dv
