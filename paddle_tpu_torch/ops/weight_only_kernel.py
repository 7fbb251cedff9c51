"""Weight-only GEMM: the hand-written kernel K7 and its plain PyTorch
version.

K7 replaces no TPU kernel: the JAX package's weight-only linear
(``paddle_tpu/nn/quant/__init__.py:140-156``) and PTQ's int8 product
(``paddle_tpu/quantization/ptq.py:60-70``) are jnp code that XLA fuses, the
dequantization folded into the dot's operand read. PyTorch fuses nothing
of the kind, so ``csrc/weight_only_gemm.cu`` dequantizes in registers or
shared memory and no dequantized weight exists in device memory.

Layouts (the port's ``Linear`` is ``[out, in]``): codes ``[n, k]`` int8,
or ``[n, k/2]`` int4 (byte i of a row holds k = 2i in its low nibble and
2i + 1 in its high one, signed: the JAX package's packing transposed, its
bytes unchanged); scales ``[n]`` float32 per channel or ``[n, k/g]``
grouped.

- :func:`weight_only_matmul` ``(x, codes, scale, bias, int4=)``:
  ``x [..., k] . dequant(codes)^T (+ bias)`` in x's dtype, rounded as the
  JAX package rounds it (the scale cast to x's dtype, each weight
  dequantized in that dtype, the sum rounded once, then the bias added).
  CPU tensors take :func:`weight_only_matmul_plain`, any other tensor
  :func:`weight_only_matmul_cuda` (bf16 or float32 x), which raises for
  a tensor that is not on a CUDA device or that it does not take.
- :func:`int8_matmul` ``(x_i8, codes, scale, sx, out_dtype)``: PTQ's A8
  product, the int32 sum of int8 x against int8 codes, then ``(float)acc
  * (sx * (scale / 127))`` in the output dtype, bit for bit the plain
  version's (:func:`int8_matmul_plain`, the sum exact in float64).

Two forms on the card, chosen by M (the rows of x) in :func:`plan`: the
decode form (M <= 8 a pass; tensor cores through ``mma.sync`` for bf16
x, CUDA cores for float32 x and A8 at every M) and the tile form (bf16 x
at M > 8: a warp-specialized wgmma kernel, the weights dequantized into
registers once a token tile, K split across blocks where the blocks
alone would not fill the card). ``stats`` counts wrapper calls that
launched (``kernel_launches``, one a call), each form's launches
(``decode_launches``, ``tile_launches``, ``finish_launches`` for the split
tile form's second kernel, ``a8_launches``) and the plain versions' calls
(``plain_calls``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..cuda_build import KernelLibrary

__all__ = ["weight_only_matmul", "weight_only_matmul_cuda",
           "weight_only_matmul_plain", "int8_matmul", "int8_matmul_cuda",
           "int8_matmul_plain", "dequantize", "unpack_int4", "pack_int4",
           "plan", "tile_splits", "tile_terms", "stats", "reset_stats",
           "KERNEL_LIBRARY", "DECODE_MAX_M"]

stats = {"kernel_launches": 0, "decode_launches": 0, "tile_launches": 0,
         "finish_launches": 0, "a8_launches": 0, "plain_calls": 0}

DECODE_MAX_M = 8    # bf16 rows the decode form takes; more go to the tiles
_TILE_ROWS = 128    # as kTRows: weight rows a tile block
_TILE_K = 64        # as kTK: k a stage of the tile form
_TOKEN_TILES = (64, 128, 256)   # the tile form's token tiles (wgmma's N)
_K_ALIGN = 32       # as kKAlign: every form takes k a multiple of it
_SMS = 132          # the H100's SMs, one tile block each
_MIN_SPLIT_STEPS = 4
# the tile form's cost model (plan): microseconds a stage of a block by
# token tile, a wave of blocks' own (its ring filled and its epilogue), the
# bytes a microsecond of split partials written and read back, and the
# finishing kernel's; fitted (tools/k7_ab.py --fit) to the tile kernel's
# times on an H100 80GB HBM3 at 700 W
_STAGE_US = {64: 0.4726, 128: 0.5903, 256: 0.8566}
_WAVE_US = 2.368
_PART_BYTES_PER_US = 4.138e6
_FINISH_US = 3.53


def reset_stats():
    for key in stats:
        stats[key] = 0


# -- the arithmetic, shared by the plain versions ------------------------------

def unpack_int4(q):
    """``[n, k/2]`` packed int8 -> ``[n, k]`` signed-nibble values
    (-8..7) as int8: byte i gives k = 2i (low nibble) and 2i + 1 (high)."""
    qi = q.to(torch.int32)
    lo = qi & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)      # sign-extend the nibble
    hi = qi >> 4                                # arithmetic shift
    n, k2 = q.shape
    return torch.stack([lo, hi], dim=2).reshape(n, 2 * k2).to(torch.int8)


def pack_int4(vals):
    """``[n, k]`` values in -8..7 -> ``[n, k/2]`` int8, the inverse of
    :func:`unpack_int4` (the JAX package's packing transposed)."""
    v = vals.to(torch.int32)
    lo, hi = v[:, 0::2], v[:, 1::2]
    packed = (hi << 4) | (lo & 0xF)
    return torch.where(packed >= 128, packed - 256, packed).to(torch.int8)


def dequantize(codes, scale, int4, dtype):
    """``[n, k]`` weights ``code * scale`` computed in ``dtype``, the scale
    cast to ``dtype`` first (``paddle_tpu/nn/quant/__init__.py:145-151``;
    its ``weight_dequantize`` is this with float32)."""
    vals = unpack_int4(codes) if int4 else codes
    vals = vals.to(dtype)
    s = scale.to(dtype)
    n, k = vals.shape
    if s.dim() == 2:
        g = k // s.shape[1]
        return (vals.reshape(n, s.shape[1], g) * s[:, :, None]).reshape(n, k)
    return vals * s[:, None]


def weight_only_matmul_plain(x, codes, scale, bias=None, *, int4=False):
    """Plain version of K7: the weight dequantized in x's dtype, one
    matmul, then the bias (rounded apart, as the JAX package adds it)."""
    stats["plain_calls"] += 1
    y = torch.matmul(x, dequantize(codes, scale, int4, x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def int8_matmul_plain(x_i8, codes, scale, sx, out_dtype):
    """Plain version of K7's A8 arm (``ptq.py:60-70``): the int32 sum of
    int8 x against int8 codes (exact in float64, which every device
    multiplies), then ``(float)acc * (sx * (scale / 127))``, each op
    rounded in float32, cast to ``out_dtype``. ``sx`` is the activation
    scale / 127 as a float32 number."""
    stats["plain_calls"] += 1
    acc = torch.matmul(x_i8.to(torch.float64), codes.to(torch.float64).t())
    dev = x_i8.device
    s = (torch.tensor(np.float32(sx), device=dev)
         * (scale / torch.tensor(127.0, device=dev)))
    return (acc.to(torch.float32) * s).to(out_dtype)


# -- the CUDA kernel ----------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_LIBRARY = KernelLibrary(
    Path(__file__).resolve().parent / "csrc" / "weight_only_gemm.cu",
    {"k7_gemm": ([_P] * 6 + [_I] * 7 + [ctypes.c_float] + [_I] * 3 + [_P],
                 ctypes.c_int)})
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _require(cond, msg):
    if not cond:
        raise ValueError(f"weight_only_matmul_cuda (K7): {msg}")


def _pass_rows(m):
    """The decode form's tokens a pass: the power of two at or above m,
    at most 8."""
    return min(8, 1 << max(0, (m - 1).bit_length()))


def tile_splits(k):
    """The K splits the tile form weighs at this k: each as ``k7_gemm``
    recounts it (stages a split rounded up), none of fewer than
    ``_MIN_SPLIT_STEPS`` stages of 64."""
    steps, out = k // _TILE_K, []
    for want in range(1, max(1, steps // _MIN_SPLIT_STEPS) + 1):
        if -(-steps // -(-steps // want)) == want:
            out.append(want)
    return out


def tile_terms(m, n, k, tn, splits):
    """The cost model's terms for the tile form at token tile ``tn`` and
    ``splits``: (stages a block times waves of 132 blocks, waves, bytes of
    float32 partials written and read, 1 where K splits), weighed by
    ``_STAGE_US[tn]``, ``_WAVE_US``, ``1 / _PART_BYTES_PER_US`` and
    ``_FINISH_US``."""
    steps = k // _TILE_K
    blocks = -(-n // _TILE_ROWS) * -(-m // tn) * splits
    waves = -(-blocks // _SMS)
    split = int(splits > 1)
    return (waves * -(-steps // splits), waves, split * 8 * splits * m * n,
            split)


@functools.lru_cache(maxsize=4096)
def plan(m, n, k, dtype):
    """``(form, rows, splits)`` for an ``[m, k] x [n, k]^T`` product: the
    decode form (0, ``rows`` tokens a pass) for float32 x, for bf16 x at m
    <= 8 and where k is not a multiple of the tile form's 64; else the
    tile form (1), ``rows`` its token tile (64, 128 or 256) and K split
    in ``splits`` (:func:`tile_splits`), the pair of least modelled time
    (:func:`tile_terms`): a small token tile pads m least but
    dequantizes each weight once a tile, and a split fills idle SMs but
    writes partials. Cached: it depends on the shape alone."""
    if dtype == torch.float32 or m <= DECODE_MAX_M or k % _TILE_K:
        return 0, _pass_rows(m), 1
    best = None
    for tn in _TOKEN_TILES:
        for splits in tile_splits(k):
            stages, waves, part, split = tile_terms(m, n, k, tn, splits)
            us = (stages * _STAGE_US[tn] + waves * _WAVE_US
                  + part / _PART_BYTES_PER_US + split * _FINISH_US)
            if best is None or us < best[0]:
                best = (us, tn, splits)
    return 1, best[1], best[2]


def _check_common(x2, codes, scale, int4, dev):
    m, k = x2.shape
    _require(codes.device == dev and scale.device == dev,
             f"codes on {codes.device}, scale on {scale.device}, x on {dev}")
    _require(codes.dtype == torch.int8 and codes.dim() == 2
             and codes.is_contiguous(), "codes must be contiguous [n, k] "
             "(int4: [n, k/2]) int8")
    n, kc = codes.shape
    _require(kc * (2 if int4 else 1) == k,
             f"codes {tuple(codes.shape)} against x's k {k} (int4={int4})")
    _require(k % _K_ALIGN == 0, f"k {k} is not a multiple of {_K_ALIGN}")
    _require(scale.dtype == torch.float32 and scale.is_contiguous()
             and scale.dim() in (1, 2) and scale.shape[0] == n,
             f"scale must be contiguous float32 [n] or [n, k/g], got "
             f"{scale.dtype} {tuple(scale.shape)}")
    groups = 1 if scale.dim() == 1 else scale.shape[1]
    _require(groups > 0 and k % groups == 0,
             f"{groups} scale groups do not divide k {k}")
    _require(x2.data_ptr() % 16 == 0 and codes.data_ptr() % 16 == 0,
             "x and codes must be 16-byte aligned (16-byte loads)")
    return m, n, k, k // groups


def _launch(x2, codes, scale, bias, y, part, m, n, k, group, int4, x_code,
            y_code, sx, form, mt, splits):
    lib = KERNEL_LIBRARY.lib()
    dev = x2.device
    with torch.cuda.device(dev):
        rc = lib.k7_gemm(
            x2.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            part.data_ptr() if part is not None else None, m, n, k, group,
            int(int4), x_code, y_code, float(sx), form, mt, splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"k7_gemm (K7) launch failed: cudaError {rc}")


def weight_only_matmul_cuda(x, codes, scale, bias=None, *, int4=False):
    """Launch K7 on ``torch.cuda.current_stream()`` (allocating with
    ``torch.empty``, so it can be captured in a CUDA graph): x ``[...,
    k]`` bf16 or float32 on a CUDA device, k a multiple of 32; codes,
    scale and bias (x's dtype, cast if it is not) on the same device.
    Raises on anything else and if a launch fails."""
    dev = x.device
    _require(dev.type == "cuda", f"x lies on {dev}; K7 needs CUDA")
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"x dtype {x.dtype}: bf16 or float32 (A8 is int8_matmul)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, n, k, group = _check_common(x2, codes, scale, int4, dev)
    if bias is not None:
        _require(bias.device == dev and bias.shape == (n,),
                 f"bias must be [n] on {dev}")
        bias = bias.to(x.dtype).contiguous()
    y = torch.empty(m, n, dtype=x.dtype, device=dev)
    if m == 0:
        return y.reshape(*lead, n)
    form, mt, splits = plan(m, n, k, x.dtype)
    part = (torch.empty(splits, m, n, dtype=torch.float32, device=dev)
            if splits > 1 else None)
    code = _CODES[x.dtype]
    _launch(x2, codes, scale, bias, y, part, m, n, k, group, int4, code,
            code, 0.0, form, mt, splits)
    if form == 0:
        stats["decode_launches"] += 1
    else:
        stats["tile_launches"] += 1
        stats["finish_launches"] += splits > 1
    stats["kernel_launches"] += 1
    return y.reshape(*lead, n)


def weight_only_matmul(x, codes, scale, bias=None, *, int4=False):
    """``x . dequant(codes)^T (+ bias)``: the plain version for CPU
    tensors, K7 for any other."""
    fn = (weight_only_matmul_plain if x.device.type == "cpu"
          else weight_only_matmul_cuda)
    return fn(x, codes, scale, bias, int4=int4)


def int8_matmul_cuda(x_i8, codes, scale, sx, out_dtype):
    """K7's A8 arm: x_i8 ``[..., k]`` int8, codes ``[n, k]`` int8, scale
    ``[n]`` float32 on one CUDA device; the decode form at any M. Raises
    on anything else and if the launch fails."""
    dev = x_i8.device
    _require(dev.type == "cuda", f"x lies on {dev}; K7 needs CUDA")
    _require(x_i8.dtype == torch.int8, f"A8 x dtype {x_i8.dtype}")
    _require(out_dtype in (torch.bfloat16, torch.float32),
             f"A8 output dtype {out_dtype}")
    _require(scale.dim() == 1, "A8 takes per-channel scales only")
    lead = x_i8.shape[:-1]
    x2 = x_i8.reshape(-1, x_i8.shape[-1]).contiguous()
    m, n, k, group = _check_common(x2, codes, scale, False, dev)
    y = torch.empty(m, n, dtype=out_dtype, device=dev)
    if m == 0:
        return y.reshape(*lead, n)
    _launch(x2, codes, scale, None, y, None, m, n, k, group, False,
            _CODES[torch.int8], _CODES[out_dtype], float(np.float32(sx)), 0,
            _pass_rows(m), 1)
    stats["a8_launches"] += 1
    stats["kernel_launches"] += 1
    return y.reshape(*lead, n)


def int8_matmul(x_i8, codes, scale, sx, out_dtype):
    """PTQ's int8 x int8 -> int32 product, rescaled: the plain version for
    CPU tensors, K7's A8 arm for any other."""
    fn = (int8_matmul_plain if x_i8.device.type == "cpu"
          else int8_matmul_cuda)
    return fn(x_i8, codes, scale, sx, out_dtype)
