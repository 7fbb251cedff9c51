"""``paddle_tpu_torch.quantization`` against ``paddle_tpu.quantization`` on
the CPU, on the same numpy inputs and transplanted weights:

- ``fake_quant`` value for value at 8 and 4 bits, and its clipped
  straight-through gradient;
- QAT: the same two-layer net quantized in both packages, trained by
  Adam loss for loss, then ``convert``'s frozen weights and outputs;
- PTQ: observers, calibration, ``convert``; the converted first layer's
  output bit for bit the JAX package's (the int8 x int8 -> int32 product
  and its float32 rescale are exact), the net's within one float32
  rounding, and the weight-only branch without an activation scale;
  ``QuantConfig``'s precedence and its qualified names.

The JAX package's ``Linear`` is ``[in, out]``, the port's ``[out, in]``:
weights cross transposed, and the port's channel-wise weight quanter
takes axis 0 where the JAX one takes axis 1 (the same output channel).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import Adam

from test_torch_weight_only import jax_ops_compiled_fast  # noqa: F401


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_matches_jax(bits):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32) * 2
    scale = np.float32(2.5)
    want = JQ.fake_quant(P.to_tensor(x), P.to_tensor(scale),
                         bit_length=bits).numpy()
    got = TQ.fake_quant(torch.tensor(x), torch.tensor(scale),
                        bit_length=bits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fake_quant_gradient_is_the_clipped_ste():
    x = torch.tensor([0.5, -0.3, 4.0, -5.0], requires_grad=True)
    scale = torch.tensor(1.0, requires_grad=True)
    TQ.fake_quant(x, scale).backward(torch.ones(4))
    np.testing.assert_array_equal(x.grad.numpy(), [1, 1, 0, 0])
    assert scale.grad.item() == 0.0


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnn.functional.relu(self.fc1(x)))


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16)
        self.fc2 = Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _pair(seed=0):
    """The JAX net and the port's, with the same weights."""
    P.seed(seed)
    jnet = _JNet()
    tnet = _TNet()
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            jl, tl = getattr(jnet, name), getattr(tnet, name)
            tl.weight.copy_(torch.tensor(np.asarray(jl.weight.numpy()).T))
            tl.bias.copy_(torch.tensor(np.asarray(jl.bias.numpy())))
    return jnet, tnet


def _batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int64))


def test_qat_trains_loss_for_loss_and_converts_as_jax():
    jnet, tnet = _pair()
    JQ.QAT().quantize(jnet, inplace=True)
    TQ.QAT().quantize(tnet, inplace=True)
    assert isinstance(tnet.fc1, TQ.QuantedLinear)
    jopt = P.optimizer.Adam(0.01, parameters=jnet.parameters())
    topt = Adam(0.01, parameters=tnet.parameters())
    jloss_fn = jnn.CrossEntropyLoss()
    x, y = _batch()
    jl, tl = [], []
    for _ in range(3):
        loss = jloss_fn(jnet(P.to_tensor(x)), P.to_tensor(y))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss))
        tloss = torch.nn.functional.cross_entropy(tnet(torch.tensor(x)),
                                                  torch.tensor(y))
        tloss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    # the activation quanters' moving scales followed the same batches
    np.testing.assert_allclose(
        tnet.fc1.activation_quanter.scale.numpy(),
        np.asarray(jnet.fc1.activation_quanter.scale.numpy()), rtol=1e-6)
    JQ.QAT().convert(jnet, inplace=True)
    TQ.QAT().convert(tnet, inplace=True)
    assert type(tnet.fc1) is Linear
    for name in ("fc1", "fc2"):
        np.testing.assert_allclose(
            getattr(tnet, name).weight.detach().numpy(),
            np.asarray(getattr(jnet, name).weight.numpy()).T,
            rtol=1e-5, atol=1e-6)
    xe = _batch(1, 4)[0]
    np.testing.assert_allclose(tnet(torch.tensor(xe)).detach().numpy(),
                               jnet(P.to_tensor(xe)).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def ptq_pair():
    """Both nets calibrated on the same 4 batches and converted."""
    jnet, tnet = _pair(3)
    JQ.PTQ().quantize(jnet)
    TQ.PTQ().quantize(tnet)
    for i in range(4):
        x = _batch(10 + i, 4)[0]
        jnet(P.to_tensor(x))
        tnet(torch.tensor(x))
    obs = (tnet.fc1.activation_observer.scales().item(),
           jnet.fc1.activation_observer.scales().numpy())
    JQ.PTQ().convert(jnet)
    TQ.PTQ().convert(tnet)
    return jnet, tnet, obs


def test_ptq_int8_path_is_exact(ptq_pair):
    jnet, tnet, (t_obs, j_obs) = ptq_pair
    assert t_obs == float(j_obs)
    assert isinstance(tnet.fc1, TQ.QuantizedInferenceLinear)
    np.testing.assert_array_equal(
        tnet.fc1.weight_quant.numpy(),
        np.asarray(jnet.fc1.weight_quant.numpy()).T)
    np.testing.assert_array_equal(
        tnet.fc1.weight_scale.numpy(),
        np.asarray(jnet.fc1.weight_scale.numpy()).T)
    x = _batch(20, 5)[0]
    with torch.no_grad():
        got1, got = tnet.fc1(torch.tensor(x)), tnet(torch.tensor(x))
    np.testing.assert_array_equal(got1.numpy(),
                                  jnet.fc1(P.to_tensor(x)).numpy())
    # through fc2, XLA may contract the rescale and the bias add into one
    # FMA: one float32 rounding apart at most
    np.testing.assert_allclose(got.numpy(), jnet(P.to_tensor(x)).numpy(),
                               rtol=2.5e-7, atol=0)


def test_ptq_weight_only_branch_matches_jax(ptq_pair):
    jnet, tnet, _ = ptq_pair
    jl = JQ.QuantizedInferenceLinear(
        jnet.fc1.weight_quant.numpy(), jnet.fc1.weight_scale.numpy(),
        jnet.fc1.bias, act_scale=None)
    tl = TQ.QuantizedInferenceLinear(
        tnet.fc1.weight_quant, tnet.fc1.weight_scale, tnet.fc1.bias,
        act_scale=None)
    x = _batch(21, 3)[0]
    np.testing.assert_allclose(tl(torch.tensor(x)).detach().numpy(),
                               jl(P.to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_observers_match_jax():
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) * (i + 1)
          for i in range(3)]
    for cls in ("AbsmaxObserver", "EMAObserver"):
        j, t = getattr(JQ, cls)(), getattr(TQ, cls)()
        for x in xs:
            j(P.to_tensor(x))
            t(torch.tensor(x))
        assert t.scales().item() == float(j.scales().numpy())


def test_quant_config_precedence_and_qualified_names():
    class Inner(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Linear(4, 4)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = Inner()
            self.b = Inner()
            self.c = Linear(4, 4)

    net = Net()
    cfg = TQ.QuantConfig(activation=None, weight=None)
    cfg.add_name_config("a.fc", activation=TQ.AbsmaxObserver)
    cfg.add_layer_config(net.c, activation=TQ.EMAObserver)
    TQ.PTQ(cfg).quantize(net)
    assert type(net.b.fc) is Linear
    assert isinstance(net.a.fc.activation_observer, TQ.AbsmaxObserver)
    assert isinstance(net.c.activation_observer, TQ.EMAObserver)
    cfg2 = TQ.QuantConfig(activation=TQ.AbsmaxObserver)
    cfg2.add_type_config(Linear, activation=TQ.EMAObserver)
    assert cfg2._get_config_by_layer(Linear(2, 2)).activation is \
        TQ.EMAObserver
    with pytest.raises(NotImplementedError, match="inplace"):
        TQ.QAT().quantize(Net(), inplace=False)
