"""The optimizers of paddle_tpu_torch against paddle_tpu's on the CPU.

Every optimizer other than Adam and AdamW (which ``test_torch_adamw.py``
and ``test_torch_lr_clip.py`` hold): the same numpy params and grads, two
leaves of at most 64 elements, three ``step()``s in each package, at the
defaults and at non-default hyperparameters (Nesterov, ``centered``,
weight decay, ``ClipGradByGlobalNorm``, ``L1Decay``, bf16 params with
float32 masters). Params, masters and every state tensor are held to
1e-6 of the tensor's largest magnitude (float32); a bf16 param to one
bf16 rounding of its master. The multi-tensor pass that CUDA params take
(``_foreach_update``) runs here on CPU tensors against the leaf rule.
Then the ``state_dict`` round trip, the never-read arguments, and LBFGS
on a quadratic and on Rosenbrock's function, probe for probe.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu_torch import nn as TNN
from paddle_tpu_torch import optimizer as O
from paddle_tpu_torch import regularizer as TR
from paddle_tpu_torch.optimizer import optimizer as base

SHAPES = [(8, 8), (9,)]
STEPS = 3
RTOL = 1e-6
BF16_ULP = 2.0 ** -8


def _clip(mod):
    return mod.ClipGradByGlobalNorm(1.0)


# (class, keyword arguments, bf16 params with float32 masters, steps
# taken before the three compared ones)
CASES = {
    "sgd": ("SGD", {}, False, 0),
    "sgd-wd-clip-bf16": ("SGD", {"weight_decay": 0.01, "clip": 1},
                         True, 0),
    "momentum": ("Momentum", {}, False, 0),
    "momentum-nesterov-l1": ("Momentum", {"use_nesterov": True,
                                          "l1": 1e-3}, False, 0),
    "momentum-nesterov-clip-bf16": ("Momentum", {"use_nesterov": True,
                                                 "momentum": 0.8,
                                                 "clip": 1}, True, 0),
    "adagrad": ("Adagrad", {}, False, 0),
    "adagrad-wd-acc-clip-bf16": ("Adagrad", {
        "weight_decay": 0.01, "initial_accumulator_value": 0.1,
        "epsilon": 1e-5, "clip": 1}, True, 0),
    "rmsprop": ("RMSProp", {}, False, 0),
    "rmsprop-centered-momentum-wd": ("RMSProp", {
        "centered": True, "momentum": 0.9, "weight_decay": 0.01,
        "rho": 0.9}, False, 0),
    "rmsprop-centered-clip-l1-bf16": ("RMSProp", {
        "centered": True, "clip": 1, "l1": 1e-3}, True, 0),
    "adamax": ("Adamax", {}, False, 0),
    "adamax-wd-clip": ("Adamax", {"weight_decay": 0.01, "beta1": 0.8,
                                  "clip": 1}, False, 0),
    "adadelta": ("Adadelta", {}, False, 0),
    "adadelta-rho-l1-clip": ("Adadelta", {"rho": 0.9, "l1": 1e-3,
                                          "clip": 1}, False, 0),
    "lamb": ("Lamb", {}, False, 0),
    "lamb-wd-clip-bf16": ("Lamb", {"lamb_weight_decay": 0.1, "beta2": 0.99,
                                   "clip": 1}, True, 0),
    "nadam": ("NAdam", {}, False, 0),
    "nadam-decay-wd-clip": ("NAdam", {"momentum_decay": 0.01,
                                      "weight_decay": 0.01, "clip": 1},
                            False, 0),
    "radam": ("RAdam", {}, False, 0),
    "radam-rectified-wd-clip": ("RAdam", {"weight_decay": 0.01, "clip": 1},
                                False, 6),
    "rprop": ("Rprop", {}, False, 0),
    "rprop-etas-range-clip": ("Rprop", {
        "etas": (0.4, 1.5), "learning_rate_range": (1e-3, 0.05),
        "clip": 1}, False, 0),
    "asgd": ("ASGD", {}, False, 0),
    "asgd-wd-clip-bf16": ("ASGD", {"weight_decay": 0.01, "clip": 1},
                          True, 0),
}
LR = {"Adagrad": 0.05, "RMSProp": 0.01, "Rprop": 0.01}


def _kwargs(mod, regularizer, kw, multi_precision, name):
    kw = dict(kw)
    if kw.pop("clip", None):
        kw["grad_clip"] = _clip(mod)
    l1 = kw.pop("l1", None)
    if l1:
        kw["weight_decay"] = regularizer.L1Decay(l1)
    if multi_precision:
        kw["multi_precision"] = True
    kw["learning_rate"] = LR.get(name, 0.01)
    return kw


def _data(seed=0):
    rng = np.random.default_rng(seed)
    inits = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.standard_normal(s) * 2).astype(np.float32)
              for s in SHAPES] for _ in range(STEPS)]
    return inits, grads


def _torch_opt(name, kw, bf16, inits, start):
    dt = torch.bfloat16 if bf16 else torch.float32
    ps = [torch.nn.Parameter(torch.from_numpy(a).to(dt)) for a in inits]
    opt = getattr(O, name)(parameters=ps, **_kwargs(TNN, TR, kw, bf16,
                                                    name))
    opt._step_count = start
    return ps, opt


def _jax_run(name, kw, bf16, inits, grads, start):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    ps = [P.to_tensor(np.asarray(jnp.asarray(a).astype(dt)),
                      stop_gradient=False) for a in inits]
    opt = getattr(P.optimizer, name)(parameters=ps, **_kwargs(
        P.nn, P.regularizer, kw, bf16, name))
    opt._step_count = start
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = P.Tensor(jnp.asarray(g).astype(dt))
        opt.step()
    return ([np.asarray(p._data.astype(jnp.float32)) for p in ps],
            [{k: np.asarray(v, np.float32) for k, v in
              opt._accum[id(p)].items()} for p in ps])


def _torch_steps(ps, opt, grads):
    dt = ps[0].dtype
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(dt)
        opt.step()
    return ([p.detach().float().numpy() for p in ps],
            [{k: v.numpy() for k, v in opt._accum[id(p)].items()}
             for p in ps])


def _close(got, want, what, bf16_param=False):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(
        got, want, rtol=BF16_ULP if bf16_param else RTOL,
        atol=scale * (BF16_ULP if bf16_param else RTOL), err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(case):
    name, kw, bf16, start = CASES[case]
    inits, grads = _data()
    want_p, want_s = _jax_run(name, kw, bf16, inits, grads, start)
    ps, opt = _torch_opt(name, kw, bf16, inits, start)
    base.reset_stats()
    got_p, got_s = _torch_steps(ps, opt, grads)
    assert base.stats == {"foreach_passes": 0, "leaf_rule_steps": STEPS}
    for i, (gp, wp, gs, ws) in enumerate(zip(got_p, want_p, got_s,
                                             want_s)):
        _close(gp, wp, f"{case} param {i}", bf16_param=bf16)
        assert sorted(gs) == sorted(ws), (gs.keys(), ws.keys())
        for key in ws:
            _close(gs[key], ws[key], f"{case} param {i} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_foreach_pass_matches_the_leaf_rule(case):
    """The multi-tensor pass (the step on CUDA params) on CPU tensors,
    against the leaf rule on a copy of the same leaves."""
    name, kw, bf16, start = CASES[case]
    inits, grads = _data(1)
    ps, opt = _torch_opt(name, kw, bf16, inits, start)
    _torch_steps(ps, opt, grads[:1])   # states away from their init
    pairs = [(p, torch.from_numpy(g).to(p.dtype))
             for p, g in zip(ps, grads[1])]
    clip = (opt._grad_clip.factor(pairs) if opt._grad_clip is not None
            else None)
    args = (opt.get_lr(), opt._step_count + 1, clip, [True, False])

    def leaves():
        p = [x.detach().clone() for x in ps]
        s = [copy.deepcopy(opt._accum[id(x)]) for x in ps]
        return p, s

    fp, fs = leaves()
    lp, ls = leaves()
    base.reset_stats()
    with torch.no_grad():
        opt._apply_foreach(fp, [g for _, g in pairs], fs, *args)
        opt._apply_leaves(lp, [g for _, g in pairs], ls, *args)
    assert base.stats == {"foreach_passes": 1, "leaf_rule_steps": 1}
    for i in range(len(ps)):
        _close(fp[i].float().numpy(), lp[i].float().numpy(),
               f"{case} param {i}", bf16_param=bf16)
        for key in ls[i]:
            _close(fs[i][key].numpy(), ls[i][key].numpy(),
                   f"{case} param {i} {key}")


@pytest.mark.parametrize("case", ["momentum-nesterov-clip-bf16",
                                  "rmsprop-centered-clip-l1-bf16",
                                  "lamb-wd-clip-bf16", "nadam",
                                  "rprop-etas-range-clip",
                                  "asgd-wd-clip-bf16"])
def test_state_dict_round_trip(case):
    """Two steps, ``state_dict``, a fresh optimizer over params equal to
    the stepped ones, ``set_state_dict``, one more step each: equal."""
    name, kw, bf16, start = CASES[case]
    inits, grads = _data(2)
    ps, opt = _torch_opt(name, kw, bf16, inits, start)
    _torch_steps(ps, opt, grads[:2])
    state = opt.state_dict()
    ps2, opt2 = _torch_opt(name, kw, bf16, inits, 0)
    with torch.no_grad():
        for p2, p in zip(ps2, ps):
            p2.copy_(p)
    opt2.set_state_dict(state)
    a = _torch_steps(ps, opt, grads[2:])
    b = _torch_steps(ps2, opt2, grads[2:])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    for sx, sy in zip(a[1], b[1]):
        assert sx.keys() == sy.keys()
        for key in sx:
            np.testing.assert_array_equal(sx[key], sy[key])
    assert opt2.averaged_parameters() if name == "ASGD" else True


@pytest.mark.parametrize("make", [
    lambda ps: O.Adam(parameters=ps, lazy_mode=True),
    lambda ps: O.Lamb(parameters=ps, exclude_from_weight_decay_fn=bool),
    lambda ps: O.ASGD(parameters=ps, batch_num=4),
    lambda ps: O.LBFGS(parameters=ps, max_eval=30),
    lambda ps: O.LBFGS(parameters=ps, line_search_fn="strong_wolfe"),
    lambda ps: O.LBFGS(parameters=ps, weight_decay=0.1),
    lambda ps: O.LBFGS(parameters=ps, grad_clip=TNN.ClipGradByGlobalNorm(1.0)),
], ids=["adam-lazy_mode", "lamb-exclude_fn", "asgd-batch_num",
        "lbfgs-max_eval", "lbfgs-line_search_fn", "lbfgs-weight_decay",
        "lbfgs-grad_clip"])
def test_never_read_arguments_raise(make):
    with pytest.raises(NotImplementedError, match="never reads"):
        make([torch.nn.Parameter(torch.ones(3))])


def test_all_twelve_are_exported():
    for name in ("SGD", "Momentum", "Adagrad", "RMSProp", "Adamax",
                 "Adadelta", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD",
                 "LBFGS"):
        assert issubclass(getattr(O, name), O.Optimizer)


# -- LBFGS ---------------------------------------------------------------------

def _lbfgs_pair(x0, loss_np_ops, **kw):
    """Run both packages' LBFGS from ``x0``; returns each side's closure
    losses in call order and its final iterate."""
    jw = P.to_tensor(np.asarray(x0, np.float32), stop_gradient=False)
    tw = torch.nn.Parameter(torch.tensor(x0, dtype=torch.float32))
    jopt = P.optimizer.LBFGS(parameters=[jw], **kw)
    topt = O.LBFGS(parameters=[tw], **kw)
    jl, tl = [], []

    def jclosure():
        loss = loss_np_ops(jw)
        loss.backward()
        jl.append(float(np.asarray(loss._data)))
        return jl[-1]

    def tclosure():
        loss = loss_np_ops(tw)
        loss.backward()
        tl.append(loss.item())
        return loss

    jopt.step(jclosure)
    topt.step(tclosure)
    return (jl, np.asarray(jw._data)), (tl, tw.detach().numpy()), topt


def test_lbfgs_quadratic_matches_jax():
    target = np.asarray([1.0, -0.5, 2.0, 0.25], np.float32)
    scale = np.asarray([1.0, 4.0, 0.5, 9.0], np.float32)

    def loss(w):
        t = (P.to_tensor(target) if not isinstance(w, torch.Tensor)
             else torch.from_numpy(target))
        s = (P.to_tensor(scale) if not isinstance(w, torch.Tensor)
             else torch.from_numpy(scale))
        return (s * (w - t) ** 2).sum()

    (jl, jx), (tl, tx), _ = _lbfgs_pair([3.0, -2.0, 0.0, 1.0], loss,
                                        max_iter=30)
    assert len(tl) == len(jl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tx, jx, atol=1e-5)
    np.testing.assert_allclose(tx, target, atol=1e-4)


def test_lbfgs_rosenbrock_matches_jax_and_round_trips_its_history():
    def loss(w):
        a, b = w[0], w[1]
        return (1 - a) ** 2 + 100 * (b - a * a) ** 2

    (jl, jx), (tl, tx), topt = _lbfgs_pair([-1.2, 1.0], loss, max_iter=60,
                                           history_size=10)
    # the valley amplifies float32 rounding (the dot products sum in
    # another order): the probes agree for the first ~25 evaluations,
    # then both runs reach the minimum (1, 1) by their own paths
    np.testing.assert_allclose(tl[:24], jl[:24], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tx, jx, atol=1e-3)
    np.testing.assert_allclose(tx, [1.0, 1.0], atol=1e-3)
    assert tl[-1] < 1e-3 and jl[-1] < 1e-3
    state = topt.state_dict()
    assert 0 < len(topt._s) <= 10 and "history_0.s" in state
    again = O.LBFGS(parameters=[torch.nn.Parameter(torch.zeros(2))],
                    history_size=10)
    again.set_state_dict(state)
    for a, b in zip(again._s + again._y, topt._s + topt._y):
        assert torch.equal(a, b)


def test_foreach_groups_change_nothing(monkeypatch):
    """A pass in groups of one leaf equals the pass over all leaves at
    once."""
    name, kw, bf16, start = CASES["lamb-wd-clip-bf16"]
    inits, grads = _data(3)
    runs = []
    for limit in (base.FOREACH_GROUP, 1):
        monkeypatch.setattr(base, "FOREACH_GROUP", limit)
        ps, opt = _torch_opt(name, kw, bf16, inits, start)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g).to(p.dtype)
            with torch.no_grad():
                pairs = [(p, p.grad) for p in ps]
                opt._step_count += 1
                opt._apply_foreach(ps, [g for _, g in pairs],
                                   [opt._get_state(p) for p in ps],
                                   opt.get_lr(), opt._step_count,
                                   opt._grad_clip.factor(pairs))
        runs.append([p.detach().float().clone() for p in ps])
        assert len(list(base._groups(ps))) == (1 if limit > 1 else 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
