"""Weight-only quantization (counterpart: ``paddle_tpu/nn/quant``):
``weight_quantize``, ``weight_dequantize``, ``weight_only_linear``,
``WeightOnlyLinear`` and ``convert_to_weight_only``, under the JAX
package's names and errors.

Decode-time linear layers are bound by the bytes of their weights, so
storing them int8 (or int4, two nibbles a byte) halves (quarters) what a
step streams. The JAX package leaves the dequantization to XLA, which
folds it into the dot's operand read; here it happens inside the
hand-written kernel K7 (:mod:`..ops.weight_only_kernel`), so no
dequantized weight exists in device memory either.

Layout: the port's ``Linear`` keeps its weight ``[out, in]`` = ``[n,
k]``, so codes are ``[n, k]`` int8 or ``[n, k/2]`` int4 (byte i of a row
holds k = 2i in its low nibble and 2i + 1 in its high one: the JAX
package's ``[k/2, n]`` packing transposed, its bytes unchanged), and
scales ``[n]`` or, grouped, ``[n, k/g]`` float32 (``models/convert.py``
transposes when they are carried across). The codes are the JAX
package's bit for bit: the same float32 ops in the same order (absmax /
127 or / 7, the 1e-8 floor, the division, round half to even, clip).

``weight_only_linear`` has a gradient with respect to x and the bias:
the plain product with the weight dequantized in x's dtype (the JAX
package has no kernel there either). ``convert_to_weight_only`` swaps
layer by layer, so a model on the card never holds a float32 copy of all
its weights, and each bf16 weight is freed once its layer is converted.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.weight_only_kernel import (dequantize, pack_int4,
                                       weight_only_matmul)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "WeightOnlyLinear", "convert_to_weight_only"]


def _check_algo(algo):
    if algo not in ("weight_only_int8", "weight_only_int4"):
        raise ValueError(
            f"unsupported algo {algo!r}: expected 'weight_only_int8' or "
            "'weight_only_int4' (llm.int8 is a CUDA-kernel path the "
            "reference gates on sm75+; the TPU analogue is the fused "
            "dequant matmul used here)")


def _const(v, like):
    """A 0-d float32 tensor on ``like``'s device: a division by it is a
    true division on the card too (PyTorch multiplies by the reciprocal
    of a Python scalar divisor there)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@torch.no_grad()
def weight_quantize(x, algo="weight_only_int8", group_size=-1):
    """Quantize an ``[n, k]`` weight (``Linear.weight``) for weight-only
    inference. Returns ``(codes, scale)``:

    - int8: codes ``[n, k]`` int8, scale ``[n]`` (or ``[n, k/group]``
      grouped) float32;
    - int4: codes ``[n, k/2]`` int8, two signed nibbles (-8..7) a byte,
      scale as above."""
    _check_algo(algo)
    w = x.detach().to(torch.float32)
    n, k = w.shape
    bits_max = _const(127.0 if algo.endswith("int8") else 7.0, w)
    floor = _const(1e-8, w)
    if group_size and group_size > 0:
        if k % group_size:
            raise ValueError(f"group_size {group_size} must divide k={k}")
        wg = w.reshape(n, k // group_size, group_size)
        scale = torch.amax(wg.abs(), dim=2) / bits_max      # [n, k/g]
        scale = torch.maximum(scale, floor)
        q = torch.clamp(torch.round(wg / scale[:, :, None]), -bits_max,
                        bits_max).reshape(n, k)
    else:
        scale = torch.amax(w.abs(), dim=1) / bits_max       # [n]
        scale = torch.maximum(scale, floor)
        q = torch.clamp(torch.round(w / scale[:, None]), -bits_max,
                        bits_max)
    q = q.to(torch.int8)
    if algo.endswith("int4"):
        if k % 2:
            raise ValueError(f"int4 packing requires even k (got {k})")
        q = pack_int4(q)
    return q, scale.to(torch.float32)


def _check_group(group_size, scale, k):
    """group_size is redundant with the scale's own shape: the two must
    agree rather than one be silently ignored."""
    if group_size and group_size > 0:
        if scale.dim() != 2 or k // scale.shape[1] != group_size:
            raise ValueError(
                f"group_size {group_size} inconsistent with scale shape "
                f"{tuple(scale.shape)} for k={k}")
    elif scale.dim() == 2:
        raise ValueError(
            f"grouped scale {tuple(scale.shape)} requires passing the "
            f"matching group_size (={k // scale.shape[1]})")


def weight_dequantize(x, scale, algo="weight_only_int8", group_size=-1,
                      out_dtype=torch.float32):
    """Inverse of :func:`weight_quantize`, ``[n, k]`` in ``out_dtype``
    (computed in float32; mainly for tests: inference goes through
    :func:`weight_only_linear`, which never materializes it)."""
    _check_algo(algo)
    int4 = algo.endswith("int4")
    k = x.shape[1] * (2 if int4 else 1)
    _check_group(group_size, scale, k)
    return dequantize(x, scale.to(torch.float32), int4,
                      torch.float32).to(out_dtype)


class _WeightOnlyLinear(torch.autograd.Function):
    """K7 forward (the plain version on the CPU); the backward is the
    plain product with the weight dequantized in x's dtype, to x and to
    the bias (the codes and scales are buffers)."""

    @staticmethod
    def forward(ctx, x, qweight, scale, bias, int4):
        ctx.save_for_backward(qweight, scale)
        ctx.int4 = int4
        ctx.bias_dtype = None if bias is None else bias.dtype
        return weight_only_matmul(x, qweight, scale, bias, int4=int4)

    @staticmethod
    def backward(ctx, g):
        qweight, scale = ctx.saved_tensors
        gx = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(g, dequantize(qweight, scale, ctx.int4,
                                            g.dtype))
        if ctx.bias_dtype is not None and ctx.needs_input_grad[3]:
            gb = g.reshape(-1, g.shape[-1]).sum(0).to(ctx.bias_dtype)
        return gx, None, None, gb, None


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", group_size=-1):
    """``y = x @ dequant(weight)^T + bias`` with the dequantization inside
    K7 (no dequantized weight in device memory); ``weight`` the ``[n,
    k]`` (int4: ``[n, k/2]``) codes."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8/int4, got "
                         f"{weight_dtype!r}")
    if weight_scale is None:
        raise ValueError("weight_scale is required (from weight_quantize)")
    is4 = weight_dtype == "int4"
    _check_group(group_size, weight_scale, weight.shape[1] * (2 if is4
                                                              else 1))
    return _WeightOnlyLinear.apply(x, weight, weight_scale, bias, is4)


class WeightOnlyLinear(nn.Module):
    """Drop-in replacement for the port's ``Linear`` holding int8/int4
    weights. ``qweight`` and ``weight_scale`` are buffers (never trained,
    but in the ``state_dict`` and read by every CUDA graph by address);
    the bias stays a Parameter, or None."""

    def __init__(self, in_features, out_features, qweight, scale, bias,
                 weight_dtype, group_size=-1):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_dtype = weight_dtype
        self.group_size = group_size
        self.register_buffer("qweight", qweight)
        self.register_buffer("weight_scale", scale)
        self.bias = bias

    def forward(self, x):
        return weight_only_linear(
            x, self.qweight, bias=self.bias,
            weight_scale=self.weight_scale,
            weight_dtype=self.weight_dtype,
            group_size=self.group_size)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"weight_dtype={self.weight_dtype}")

    @staticmethod
    def from_linear(linear, algo="weight_only_int8", group_size=-1):
        qw, scale = weight_quantize(linear.weight, algo=algo,
                                    group_size=group_size)
        return WeightOnlyLinear(
            linear.in_features, linear.out_features, qw, scale,
            linear.bias, "int4" if algo.endswith("int4") else "int8",
            group_size)


def convert_to_weight_only(layer, algo="weight_only_int8", group_size=-1,
                           exclude=()):
    """Recursively swap every ``Linear`` sublayer for a
    :class:`WeightOnlyLinear` quantized from its current weight, one at a
    time (the old weight is freed as its layer is swapped). ``exclude``:
    substrings of the qualified sublayer name (``("lm_head",)`` keeps the
    output head in full precision). Returns ``layer``, mutated; the count
    of converted layers is ``layer._weight_only_converted``."""
    from ..common import Linear

    converted = 0

    def walk(mod, prefix):
        nonlocal converted
        for name, sub in list(mod.named_children()):
            qual = f"{prefix}.{name}" if prefix else name
            # exact type only, as the JAX package: a Linear subclass may
            # carry semantics (sharding) the swap would lose
            if type(sub) is Linear and not any(e in qual for e in exclude):
                setattr(mod, name, WeightOnlyLinear.from_linear(
                    sub, algo=algo, group_size=group_size))
                del sub
                converted += 1
            else:
                walk(sub, qual)

    walk(layer, "")
    layer._weight_only_converted = converted
    return layer
