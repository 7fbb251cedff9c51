"""The port's schedules, gradient clips, regularizers and
``Optimizer.step`` (global-norm clip, L1, a schedule) against
``paddle_tpu`` on the CPU, from numpy inputs made from a seed.

Tolerances: learning rates exactly (the same float64 arithmetic); clipped
float32 grads to 1e-6 relative (the global norm's sum of squares runs in
another order: one or two float32 ulps of the factor), bf16 clipped grads
to one bf16 ulp; five AdamW steps' params and moments to 1e-6 (float32,
lr 1e-2).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.nn.clip_grad import clip_grad_norm_ as jcn
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.nn import clip_grad as C
from paddle_tpu_torch.ops import adamw_kernel
from paddle_tpu_torch.optimizer import AdamW, lr as tlr
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

STEPS = 40


def _sched_args():
    lam = (lambda e: 0.95 ** e)
    cos = ("CosineAnnealingDecay", (0.1, 10), {})
    return [
        ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
        ("PiecewiseDecay", ([5, 15, 30], [0.1, 0.05, 0.01, 0.001]), {}),
        ("NaturalExpDecay", (0.1, 0.05), {}),
        ("InverseTimeDecay", (0.1, 0.2), {}),
        ("PolynomialDecay", (0.1, 12), {"end_lr": 0.001, "power": 2.0}),
        ("PolynomialDecay", (0.1, 12), {"cycle": True}),
        ("LinearWarmup", (0.1, 8, 0.0, 0.1), {}),
        ("ExponentialDecay", (0.1, 0.9), {}),
        ("MultiStepDecay", (0.1, [4, 9, 20]), {"gamma": 0.5}),
        ("StepDecay", (0.1, 7), {"gamma": 0.3}),
        ("LambdaDecay", (0.1, lam), {}),
        cos,
        ("CosineAnnealingWarmRestarts", (0.1, 5), {"T_mult": 2,
                                                   "eta_min": 1e-3}),
        ("OneCycleLR", (0.1, 30), {}),
        ("OneCycleLR", (0.1, 30), {"anneal_strategy": "linear"}),
        ("CyclicLR", (0.01, 0.1), {"step_size_up": 6, "mode": "triangular2"}),
        ("CyclicLR", (0.01, 0.1), {"step_size_up": 6, "mode": "exp_range",
                                   "exp_gamma": 0.97}),
        ("MultiplicativeDecay", (0.1, lam), {}),
        ("LinearLR", (0.1, 12), {"start_factor": 0.25}),
    ]


@pytest.mark.parametrize("name,args,kw", _sched_args(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_schedule_matches_jax_over_40_steps(name, args, kw):
    j, t = getattr(jlr, name)(*args, **kw), getattr(tlr, name)(*args, **kw)
    got, want = [], []
    for _ in range(STEPS):
        got.append(t())
        want.append(j())
        t.step()
        j.step()
    assert got == want
    # the state round trip: a fresh schedule set from the state goes on
    # where this one is
    fresh = getattr(tlr, name)(*args, **kw)
    fresh.set_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict()
    for _ in range(5):
        t.step()
        fresh.step()
        assert fresh() == t()


def test_linear_warmup_wrapping_a_schedule_and_reduce_on_plateau():
    def pair(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(3e-4, 20), 5, 0.0,
                                3e-4)
    j, t = pair(jlr), pair(tlr)
    for _ in range(STEPS):
        assert t() == j()
        t.step()
        j.step()
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84,
               0.85]
    j = jlr.ReduceOnPlateau(0.1, patience=2, cooldown=1, factor=0.5)
    t = tlr.ReduceOnPlateau(0.1, patience=2, cooldown=1, factor=0.5)
    for x in metrics:
        j.step(x)
        t.step(torch.tensor(x, dtype=torch.float64))
        assert t() == j() and t.state_dict() == j.state_dict()


def _grads(seed, dtype=np.float32, scale=3.0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (4, 4), (2, 9)]
    return [(rng.standard_normal(s) * scale).astype(dtype) for s in shapes]


def _jax_pairs(arrays, need_clip):
    pairs = []
    for a, nc in zip(arrays, need_clip):
        p = P.to_tensor(np.zeros_like(a))
        p.need_clip = nc
        pairs.append((p, P.to_tensor(a)))
    return pairs


def _torch_pairs(arrays, need_clip, dtype=None):
    pairs = []
    for a, nc in zip(arrays, need_clip):
        p = torch.zeros(a.shape)
        p.need_clip = nc
        g = torch.from_numpy(a)
        pairs.append((p, g.to(dtype) if dtype else g))
    return pairs


CLIPS = [("ClipGradByValue", (0.5,), {}),
         ("ClipGradByValue", (0.5,), {"min": -0.1}),
         ("ClipGradByNorm", (1.5,), {}),
         ("ClipGradByGlobalNorm", (2.0,), {}),
         ("ClipGradByGlobalNorm", (1e3,), {})]   # a factor of 1


@pytest.mark.parametrize("name,args,kw", CLIPS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CLIPS)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_clips_match_jax_with_need_clip(name, args, kw, bf16):
    arrays = _grads(1)
    need = [True, False, True, True]
    jc = getattr(P.nn, name)(*args, **kw)
    tc = getattr(C, name)(*args, **kw)
    if bf16:
        import jax.numpy as jnp
        jpairs = [(p, P.Tensor(g._data.astype(jnp.bfloat16)))
                  for p, g in _jax_pairs(arrays, need)]
        tpairs = _torch_pairs(arrays, need, torch.bfloat16)
    else:
        jpairs, tpairs = _jax_pairs(arrays, need), _torch_pairs(arrays, need)
    want = [np.asarray(g._data).astype(np.float32) for _, g in jc(jpairs)]
    got = tc(tpairs)
    for (p, g), w, (_, g0), nc in zip(got, want, tpairs, need):
        assert g.dtype == g0.dtype
        if not nc:
            assert g is g0
        if bf16:
            # the factor may differ by an ulp of float32: the product
            # rounds to bf16 alike or one bf16 ulp apart
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -7,
                                       atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)


def test_clip_grad_norm_matches_jax():
    arrays = _grads(2)
    for norm_type in (2.0, float("inf")):
        jps, tps = [], []
        for a in arrays:
            jp = P.to_tensor(np.zeros_like(a), stop_gradient=False)
            jp.grad = P.to_tensor(a)
            jps.append(jp)
            tp = torch.zeros(a.shape, requires_grad=True)
            tp.grad = torch.from_numpy(a.copy())
            tps.append(tp)
        jt = jcn(jps, 1.0, norm_type=norm_type)
        tt = C.clip_grad_norm_(tps, 1.0, norm_type=norm_type)
        np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.grad.numpy(),
                                       np.asarray(jp.grad._data),
                                       rtol=1e-6, atol=0)


def test_regularizers_feed_the_optimizer():
    p = torch.nn.Parameter(torch.ones(3))
    assert AdamW(parameters=[p], weight_decay=L2Decay(0.3))._weight_decay \
        == 0.3
    opt = AdamW(parameters=[p], weight_decay=L1Decay(0.2))
    assert (opt._weight_decay, opt._l1) == (0.0, 0.2)
    assert repr(L1Decay(0.2)) == "L1Decay(0.2)"


def _host_read(*args, **kwargs):
    raise AssertionError("Optimizer.step read a tensor on the host")


@pytest.mark.parametrize("multi_precision", [False, True],
                         ids=["f32", "bf16-masters"])
def test_optimizer_step_with_clip_l1_and_schedule_matches_jax(
        multi_precision):
    """Five AdamW steps with ClipGradByGlobalNorm, L1Decay and a
    LinearWarmup(CosineAnnealingDecay) through K4's plain version (the
    clip factor folded in, no grad rewritten, no host read), against the
    JAX package's ``step()``; one leaf with ``need_clip`` False."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    shapes = [(6, 5), (9,), (3, 4)]
    inits = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 4).astype(np.float32)
              for s in shapes] for _ in range(5)]
    dt = jnp.bfloat16 if multi_precision else jnp.float32
    tdt = torch.bfloat16 if multi_precision else torch.float32

    def sched(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-2, 6), 2, 0.0,
                                1e-2)
    jps = [P.to_tensor(np.asarray(jnp.asarray(a).astype(dt)),
                       stop_gradient=False) for a in inits]
    jps[1].need_clip = False
    jopt = P.optimizer.AdamW(sched(jlr), parameters=jps,
                             weight_decay=P.regularizer.L1Decay(1e-3),
                             grad_clip=P.nn.ClipGradByGlobalNorm(1.0),
                             multi_precision=multi_precision)
    tps = [torch.nn.Parameter(torch.from_numpy(a).to(tdt)) for a in inits]
    tps[1].need_clip = False
    topt = AdamW(sched(tlr), parameters=tps, weight_decay=L1Decay(1e-3),
                 grad_clip=C.ClipGradByGlobalNorm(1.0),
                 multi_precision=multi_precision)
    adamw_kernel.reset_stats()
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = P.Tensor(jnp.asarray(g).astype(dt))
            tp.grad = torch.from_numpy(g).to(tdt)
        held = [tp.grad for tp in tps]
        jopt.step()
        with pytest.MonkeyPatch.context() as mp:
            # the step reads nothing off its tensors on the host
            for name in ("item", "tolist", "numpy", "__float__",
                         "__int__", "__bool__"):
                mp.setattr(torch.Tensor, name, _host_read)
            topt.step()
        assert all(tp.grad is h for tp, h in zip(tps, held))
        assert topt._clip_factor.item() < 1
        jopt._lr.step()
        topt._lr.step()
    assert adamw_kernel.stats["plain_calls"] == 5
    for jp, tp in zip(jps, tps):
        js, ts = jopt._accum[id(jp)], topt._accum[id(tp)]
        for key in ("moment1", "moment2") + (("master",) if
                                             multi_precision else ()):
            np.testing.assert_allclose(ts[key].numpy(),
                                       np.asarray(js[key]), rtol=0,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(
            tp.detach().float().numpy(),
            np.asarray(jp._data.astype(jnp.float32)), rtol=0, atol=1e-6)
