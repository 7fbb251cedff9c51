"""Weight-only quantization of paddle_tpu_torch against paddle_tpu on the
CPU (``nn/quant``, K7's plain version, ``models/convert.py``).

- ``weight_quantize``: codes and scales bit-equal to the JAX package's
  (int8, int4, per-channel and grouped, float32 and bf16 weights), the
  port's ``[n, k]`` layout the JAX ``[k, n]`` transposed;
  ``weight_dequantize`` equal; int4 packing and unpacking inverse.
- ``weight_only_linear`` against the JAX function at 1e-5 in float32,
  with the gradients to x and to the bias; the reference's errors.
- ``convert_to_weight_only``: the exclude substring and the exact-type
  rule, the count, int8 buffers.
- A converted LLaMA's state carried across both ways: the JAX model's
  codes load into the port's converted model (logits equal to 1e-5),
  and the port's into the JAX one.
- K7's form plan from shapes alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import quant as JQ
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu,
                                     state_dict_to_paddle_tpu)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops import weight_only_kernel as WK

K, N = 96, 40
ALGOS = ["weight_only_int8", "weight_only_int4"]


def _w(seed=0, k=K, n=N):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def _jax_w(w, dtype):
    t = P.to_tensor(w)
    return t.astype(dtype) if dtype != "float32" else t


def _port_w(w, dtype):
    return torch.tensor(w.T.copy()).to(getattr(torch, dtype))


@pytest.mark.parametrize("algo,group,dtype", [
    ("weight_only_int8", -1, "float32"), ("weight_only_int8", 16, "bfloat16"),
    ("weight_only_int8", 24, "float32"), ("weight_only_int4", -1, "bfloat16"),
    ("weight_only_int4", 16, "float32"), ("weight_only_int4", 24, "bfloat16")])
def test_codes_and_scales_match_jax_bit_for_bit(algo, group, dtype):
    w = _w(1)
    jq, js = JQ.weight_quantize(_jax_w(w, dtype), algo=algo,
                                group_size=group)
    tq, ts = TQ.weight_quantize(_port_w(w, dtype), algo=algo,
                                group_size=group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.numpy()).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()).T)
    np.testing.assert_array_equal(
        TQ.weight_dequantize(tq, ts, algo=algo, group_size=group).numpy(),
        np.asarray(JQ.weight_dequantize(jq, js, algo=algo,
                                        group_size=group).numpy()).T)


def test_int4_packing_is_the_references_bytes_transposed():
    vals = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)   # [3, 32]
    packed = WK.pack_int4(vals)
    assert packed.shape == (3, 16)
    torch.testing.assert_close(WK.unpack_int4(packed), vals, rtol=0, atol=0)
    # byte i: k = 2i in the low nibble, 2i + 1 in the high one, signed
    assert int(packed[0, 0]) == ((-7 << 4) | (-8 & 0xF))


@pytest.mark.parametrize("group", [-1, 16])
@pytest.mark.parametrize("algo", ALGOS)
def test_weight_only_linear_and_its_grads_match_jax(algo, group):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    cot = rng.standard_normal((2, 3, N)).astype(np.float32)
    wd = algo[-4:]
    jq, js = JQ.weight_quantize(P.to_tensor(_w(3)), algo=algo,
                                group_size=group)
    jx = P.to_tensor(x, stop_gradient=False)
    jb = P.to_tensor(b, stop_gradient=False)
    jy = JQ.weight_only_linear(jx, jq, bias=jb, weight_scale=js,
                               weight_dtype=wd, group_size=group)
    (jy * P.to_tensor(cot)).sum().backward()
    tq, ts = TQ.weight_quantize(_port_w(_w(3), "float32"), algo=algo,
                                group_size=group)
    tx = torch.tensor(x, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    ty = TQ.weight_only_linear(tx, tq, bias=tb, weight_scale=ts,
                               weight_dtype=wd, group_size=group)
    (ty * torch.tensor(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), jb.grad.numpy(), **tol)


def test_weight_only_linear_in_bf16_rounds_the_weight_in_bf16():
    """The plain version dequantizes in x's dtype, as the reference: the
    same bf16 inputs give the JAX function's bf16 output."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, K)).astype(np.float32)
    jq, js = JQ.weight_quantize(P.to_tensor(_w(5)), group_size=32)
    tq, ts = TQ.weight_quantize(_port_w(_w(5), "float32"), group_size=32)
    jy = JQ.weight_only_linear(P.to_tensor(x).astype("bfloat16"), jq,
                               weight_scale=js, group_size=32)
    ty = TQ.weight_only_linear(torch.tensor(x).to(torch.bfloat16), tq,
                               weight_scale=ts, group_size=32)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype("float32").numpy()),
                               rtol=2 ** -7, atol=1e-3)
    wq = WK.dequantize(tq, ts, False, torch.bfloat16)
    want = (ts.to(torch.bfloat16).repeat_interleave(32, dim=1)
            * tq.to(torch.bfloat16))
    torch.testing.assert_close(wq, want, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(weight_dtype="fp8"), "int8/int4"),
    (dict(weight_scale=None), "weight_scale is required"),
    (dict(group_size=32), "inconsistent"),
])
def test_weight_only_linear_raises_what_the_reference_raises(kwargs, match):
    tq, ts = TQ.weight_quantize(_port_w(_w(), "float32"))
    jq, js = JQ.weight_quantize(P.to_tensor(_w()))
    kw = dict(dict(weight_scale=ts), **kwargs)
    jkw = dict(dict(weight_scale=js), **kwargs)
    with pytest.raises(ValueError, match=match):
        TQ.weight_only_linear(torch.zeros(1, K), tq, **kw)
    with pytest.raises(ValueError, match=match):
        JQ.weight_only_linear(P.to_tensor(np.zeros((1, K), np.float32)),
                              jq, **jkw)
    with pytest.raises(ValueError, match="unsupported algo"):
        TQ.weight_quantize(_port_w(_w(), "float32"), algo="fp8")
    with pytest.raises(ValueError, match="grouped scale"):
        TQ.weight_dequantize(*TQ.weight_quantize(_port_w(_w(), "float32"),
                                                 group_size=16))


class _Sub(Linear):
    """A Linear subclass: the exact-type rule leaves it alone."""


def test_convert_follows_the_exclude_and_exact_type_rules():
    torch.manual_seed(0)
    net = torch.nn.Module()
    net.body = torch.nn.Sequential(Linear(32, 64), torch.nn.ReLU(),
                                   Linear(64, 32))
    net.lm_head = Linear(32, 16)
    net.sub = _Sub(32, 32)
    net.plain = torch.nn.Linear(32, 32)
    x = torch.randn(4, 32)
    ref = net.body(x)
    TQ.convert_to_weight_only(net, exclude=("lm_head",))
    assert net._weight_only_converted == 2
    assert isinstance(net.body[0], TQ.WeightOnlyLinear)
    assert net.body[0].qweight.dtype == torch.int8
    assert "qweight" in net.body[0].state_dict()
    assert type(net.lm_head) is Linear and type(net.sub) is _Sub
    assert type(net.plain) is torch.nn.Linear
    assert (net.body(x) - ref).abs().max() / ref.abs().max() < 0.05
    # a converted model converts nothing more
    TQ.convert_to_weight_only(net, algo="weight_only_int4",
                              exclude=("lm_head",))
    assert net._weight_only_converted == 0


TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


@pytest.mark.parametrize("algo,group", [("weight_only_int8", -1),
                                        ("weight_only_int4", 32)])
def test_converted_state_crosses_both_ways(algo, group):
    """The JAX model's codes and scales load into the port's converted
    model (logits equal), and the port's into a converted JAX model."""
    P.seed(0)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    JQ.convert_to_weight_only(jm, algo=algo, group_size=group,
                              exclude=("lm_head",))
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu", seed=1)
    TQ.convert_to_weight_only(tm, algo=algo, group_size=group,
                              exclude=("lm_head",))
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    ids = np.random.default_rng(0).integers(0, 97, (2, 9)).astype(np.int32)
    # the JAX forward as one program (jit.to_static): the values of op by
    # op, with one compile
    want = np.asarray(P.jit.to_static(lambda x: jm(x))(
        P.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.tensor(ids).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = state_dict_to_paddle_tpu(tm.state_dict(), cfg)
    for key, arr in sd.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key], arr)
    # the port's own quantization, carried into the converted JAX model
    tm2 = LlamaForCausalLM(cfg, device="cpu", seed=2)
    TQ.convert_to_weight_only(tm2, algo=algo, group_size=group,
                              exclude=("lm_head",))
    carried = state_dict_to_paddle_tpu(tm2.state_dict(), cfg)
    missing, extra = jm.set_state_dict(carried)
    assert not missing and not extra
    for key, t in jm.state_dict().items():
        arr = np.asarray(t._data)
        assert arr.dtype == carried[key].dtype, key
        np.testing.assert_array_equal(arr, carried[key])


def test_a_state_of_another_quantization_is_refused():
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    TQ.convert_to_weight_only(tm, exclude=("lm_head",))
    sd = state_dict_to_paddle_tpu(tm.state_dict(), cfg)
    key = "llama.layers.0.mlp.up_proj.qweight"
    bad = dict(sd, **{key: sd[key][:5]})
    with pytest.raises(ValueError, match="up_proj.qweight"):
        state_dict_from_paddle_tpu(bad, cfg)
    with pytest.raises(KeyError, match="weight_scale"):
        state_dict_from_paddle_tpu(
            {k: v for k, v in sd.items()
             if k != "llama.layers.0.mlp.up_proj.weight_scale"}, cfg)


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (1, 4096, 4096, torch.bfloat16, (0, 1, 1)),
    (3, 4096, 4096, torch.bfloat16, (0, 4, 1)),
    (8, 1024, 4096, torch.bfloat16, (0, 8, 1)),
    (40, 4096, 4096, torch.bfloat16, (1, 0, 5)),      # the verify round
    (256, 4096, 4096, torch.bfloat16, (1, 0, 2)),     # a prefill chunk
    (264, 4096, 11008, torch.bfloat16, (1, 0, 1)),    # a ragged step
    (4096, 4096, 4096, torch.bfloat16, (1, 0, 1)),    # a long prefill
    (256, 4096, 4096, torch.float32, (0, 8, 1)),
    (40, 1024, 4128, torch.bfloat16, (0, 8, 1)),      # k % 64 = 32
])
def test_k7_plan_picks_its_form_from_shapes(m, n, k, dtype, want):
    """The decode form below 9 bf16 rows, for every float32 M and where
    k is no multiple of 64; the tile form otherwise, K split until tiles
    x splits reach two blocks an SM (each split at least 4 steps of
    64)."""
    assert WK.plan(m, n, k, dtype) == want
