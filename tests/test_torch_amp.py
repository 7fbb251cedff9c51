"""The port's AMP (``auto_cast``, ``decorate``, ``GradScaler``) against
``paddle_tpu`` on the CPU, from numpy inputs and weights made from a
seed.

Tolerances: the O1 and O2 logits of a 2-layer LLaMA (bf16 matmuls and
attention, float32 elsewhere) to 2e-2 of the float32 logits' largest
magnitude: each bf16 rounding moves a value by up to 2**-8 of itself, and
the two frameworks round their GEMM outputs after sums in other orders,
so one rounding step apart is the expected difference; masters and loss
scales exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     state_dict_from_paddle_tpu)
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32)
LOGIT_TOL = 2e-2


def _pair():
    P.seed(0)
    jm = JaxLlama(JaxConfig(**TINY))
    cfg = LlamaConfig(**TINY)
    tm = LlamaForCausalLM(cfg, device="cpu")
    sd = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm.load_state_dict(state_dict_from_paddle_tpu(sd, cfg))
    return jm, tm


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_logits_match_jax(level, monkeypatch):
    jm, tm = _pair()
    jm.eval()
    tm.eval()
    ids = np.random.default_rng(0).integers(0, 64, (2, 12)).astype(np.int32)
    with torch.no_grad():
        ref32 = tm(torch.from_numpy(ids).long()).numpy()
    seen = []
    import paddle_tpu_torch.nn.functional as TF
    inner = TF.flash_attention_bshd

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return inner(q, k, v, **kw)
    monkeypatch.setattr(TF, "flash_attention_bshd", spy)
    with P.amp.auto_cast(level=level, dtype="bfloat16"):
        # one program (the JAX package's jit.to_static), the same values
        # as its op-by-op forward with far fewer compiles
        want = P.jit.to_static(lambda x: jm(x))(P.to_tensor(ids))
    with amp.auto_cast(level=level, dtype="bfloat16"), torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    # the attention kernels see what the JAX package's hook gives its
    # attention: bf16 q, k, v; the head's GEMM writes bf16 logits
    assert seen == [(torch.bfloat16,) * 3] * 2
    assert got.dtype == torch.bfloat16
    assert "bfloat16" in str(want.dtype)
    w = np.asarray(want._data.astype("float32"))
    scale = np.abs(ref32).max()
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=LOGIT_TOL * scale)
    # and it is bf16 arithmetic, not the float32 model
    assert np.abs(got.float().numpy() - ref32).max() > 1e-4 * scale


def test_auto_cast_leaves_black_listed_and_disabled_ops_alone():
    x = torch.ones(2, dtype=torch.float32)
    from paddle_tpu_torch.amp.state import cast_for_op
    with amp.auto_cast(level="O2"):
        assert cast_for_op((x,), "softmax")[0].dtype == torch.float32
        assert cast_for_op((x, None), "matmul")[0].dtype == torch.bfloat16
    with amp.auto_cast(level="O1", custom_black_list=["matmul"]):
        assert cast_for_op((x,), "matmul")[0].dtype == torch.float32
    with amp.auto_cast(enable=False):
        assert cast_for_op((x,), "matmul")[0].dtype == torch.float32
    assert cast_for_op((x,), "matmul")[0].dtype == torch.float32


def test_decorate_keeps_the_original_float32_values_as_masters():
    jm, tm = _pair()
    orig = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = AdamW(1e-3, parameters=tm.parameters())
    tm2, opt2 = amp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert tm2 is tm and opt2 is opt and opt._use_master_weights
    P.amp.decorate(jm, level="O2", dtype="bfloat16")
    jsd = {n: np.asarray(p._master_weight)
           for n, p in jm.named_parameters()}
    from paddle_tpu_torch.models import state_dict_to_paddle_tpu
    masters = state_dict_to_paddle_tpu(
        {n: p._master_weight for n, p in tm.named_parameters()},
        tm.cfg)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p._master_weight, orig[n])
        # the optimizer's master IS that tensor, not the bf16 param widened
        assert opt._get_state(p)["master"] is p._master_weight
    for key, val in masters.items():
        np.testing.assert_array_equal(val, jsd[key], err_msg=key)


def test_master_grad_accumulates_float32_grads_that_k4_steps_with():
    _, tm = _pair()
    opt = AdamW(1e-3, parameters=tm.parameters())
    amp.decorate(tm, opt, level="O2", master_grad=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 8))).long()
    for _ in range(2):   # two backwards accumulate in float32
        tm(ids).float().square().mean().backward()
    w = tm.llama.layers[0].mlp.up_proj.weight
    assert w.grad is None and w.main_grad.dtype == torch.float32
    g = w.main_grad.clone()
    opt.step()
    st = opt._get_state(w)
    np.testing.assert_allclose(st["moment1"].numpy(), 0.1 * g.numpy(),
                               rtol=1e-6, atol=0)
    opt.clear_grad()
    assert w.main_grad is None


def test_grad_scaler_follows_jax_over_planted_infs():
    """Eight steps with infs planted at steps 2, 3 and 6: the scale, the
    found-inf flag and the params follow the JAX package's GradScaler
    step for step (growth every 2 good steps, backoff after 1 bad)."""
    rng = np.random.default_rng(4)
    shapes = [(4, 3), (5,)]
    inits = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    jps = [P.to_tensor(a, stop_gradient=False) for a in inits]
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in inits]
    jopt = P.optimizer.AdamW(1e-2, parameters=jps)
    topt = AdamW(1e-2, parameters=tps)
    js, ts = P.amp.GradScaler(**kw), amp.GradScaler(**kw)
    for step in range(8):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        if step in (2, 3, 6):
            gs[step % 2].flat[1] = np.inf if step != 3 else np.nan
        scale = ts.get_loss_scaling()
        assert scale == js.get_loss_scaling()
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = P.to_tensor(g * scale)
            tp.grad = torch.from_numpy(g * scale)
        js.step(jopt)
        ts.step(topt)
        assert ts._found_inf == js._found_inf == (step in (2, 3, 6))
        jopt.clear_grad()
        topt.clear_grad()
    assert ts.state_dict() == js.state_dict()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp._data), rtol=0, atol=1e-6)
