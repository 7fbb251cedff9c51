"""paddle_tpu_torch's AdamW (the plain version of the multi-tensor kernel
K4 that its CPU path runs, and the optimizer over it) against
paddle_tpu's fused AdamW Pallas kernel in interpret mode
(``adamw_update``) and its XLA rule ``Adam._update``, on the same numpy
inputs.

Cases: a bf16 param with an f32 master and an f32 param without one,
coupled (Adam + L2) and decoupled (AdamW) decay, leaf sizes that are not
multiples of 128 (the TPU kernel takes only lane-divisible leaves, so it
is compared on those), two steps. Tolerance: 1e-6 absolute on float32
masters, params and moments (a few ulps: the kernel's
``(m1/bc1)/(sqrt(m2)/sbc2+eps)`` against the rule's
``m_hat/(sqrt(v_hat)+eps)``); bf16 params exactly the cast of the
master. The CUDA kernel itself runs only on the card (``chip_smoke.py``
holds it against this plain version).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas._adamw_kernel import adamw_update as jax_adamw
from paddle_tpu.optimizer.optimizers import Adam as JaxAdam
from paddle_tpu_torch.ops import adamw_kernel as TK
from paddle_tpu_torch.optimizer import Adam, AdamW, LRScheduler

ATOL = 1e-6
B1, B2, EPS = 0.9, 0.999, 1e-8


def _leaf(n, seed, master):
    """numpy (param, grad, state) of one leaf: moments as after some
    steps; param and grad bf16-representable when the leaf has a
    master (the param is its bf16 cast)."""
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal(n).astype(np.float32)  # noqa: E731
    st = {"moment1": f() * 0.1, "moment2": np.abs(f()) * 0.01}
    p, g = f(), f()
    if master:
        st["master"] = p
        p, g = (torch.from_numpy(x).bfloat16().float().numpy()
                for x in (p, g))
    return p, g, st


def _torch_leaf(p, g, st, master):
    dt = torch.bfloat16 if master else torch.float32
    return (torch.from_numpy(p.copy()).to(dt),
            torch.from_numpy(g.copy()).to(dt),
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def _close(got, want, name, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want,
                                                          np.float32),
        atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("master,decoupled", [(True, True), (False, False)])
def test_plain_k4_matches_the_pallas_kernel(master, decoupled):
    wd, lr, step = 0.01, 1e-3, 7
    p, g, st = _leaf(96 * 128, 0, master)
    jp = jnp.asarray(p, jnp.bfloat16 if master else jnp.float32)
    jg = jnp.asarray(g).astype(jp.dtype)
    want_p, want_st = jax_adamw(
        jp, jg, {k: jnp.asarray(v) for k, v in st.items()},
        jnp.asarray(lr, jnp.float32), jnp.asarray(step, jnp.int32), b1=B1,
        b2=B2, eps=EPS, wd=wd, decoupled=decoupled, interpret=True)
    tp, tg, tst = _torch_leaf(p, g, st, master)
    TK.adamw_update([tp], [tg], [tst], lr=lr, step=step, b1=B1, b2=B2,
                    eps=EPS, wd=wd, decoupled=decoupled)
    for key in want_st:
        _close(tst[key], want_st[key], key)
    _close(tp, want_p, "param", atol=0 if master else ATOL)


@pytest.mark.parametrize("decoupled", [False, True])
def test_plain_k4_matches_the_xla_rule_on_odd_sizes(decoupled):
    """Three leaves of 7, 300 and 1000 elements (bf16 + master, f32, bf16
    + master), two steps, against ``Adam._update`` leaf by leaf."""
    hp = {"b1": B1, "b2": B2, "eps": EPS, "weight_decay": 0.01,
          "decoupled": decoupled, "amsgrad": False}
    leaves = [_leaf(n, i, m) for i, (n, m) in enumerate(
        [(7, True), (300, False), (1000, True)])]
    torch_leaves = [_torch_leaf(p, g, st, "master" in st)
                    for p, g, st in leaves]
    # JAX side: the f32 tensor the rule runs on (master or param) + state
    jax_src = [jnp.asarray(st.get("master", p)) for p, _, st in leaves]
    jax_state = [{k: jnp.asarray(v) for k, v in st.items() if k != "master"}
                 for _, _, st in leaves]
    for step in (1, 2):
        lr = 3e-4 * step
        for i, (_, g, _) in enumerate(leaves):
            jax_src[i], jax_state[i] = JaxAdam._update(
                jax_src[i], jnp.asarray(g), jax_state[i],
                jnp.asarray(lr, jnp.float32), jnp.asarray(step, jnp.int32),
                hp)
        tps, tgs, tsts = zip(*torch_leaves)
        TK.adamw_update(list(tps), list(tgs), list(tsts), lr=lr, step=step,
                        b1=B1, b2=B2, eps=EPS, wd=0.01, decoupled=decoupled)
    for (tp, _, tst), src, js in zip(torch_leaves, jax_src, jax_state):
        for key in js:
            _close(tst[key], js[key], key)
        if "master" in tst:
            _close(tst["master"], src, "master")
            _close(tp, src.astype(jnp.bfloat16), "param", atol=0)
        else:
            _close(tp, src, "param")


def test_adamw_optimizer_keeps_masters_and_counts_its_route():
    torch.manual_seed(0)
    wb = torch.nn.Parameter(torch.randn(5, 3).bfloat16())
    wf = torch.nn.Parameter(torch.randn(4))
    opt = AdamW(1e-2, parameters=[wb, wf], multi_precision=True)
    TK.reset_stats()
    for _ in range(2):
        (wb.float().sum() + (wf * wf).sum()).backward()
        opt.step()
        opt.clear_grad()
    assert wb.grad is None and opt._step_count == 2
    st_b, st_f = opt._get_state(wb), opt._get_state(wf)
    assert st_b["master"].dtype == torch.float32 and "master" not in st_f
    assert torch.equal(wb.detach(), st_b["master"].bfloat16())
    assert TK.stats == {"kernel_launches": 0, "plain_calls": 2,
                        "amsgrad_plain_calls": 0}
    ams = Adam(1e-2, parameters=[wf], amsgrad=True)
    (wf * wf).sum().backward()
    ams.step()
    assert TK.stats["amsgrad_plain_calls"] == 1
    assert TK.stats["plain_calls"] == 2
    assert "moment2_max" in ams._get_state(wf)
    assert not TK.adamw_eligible(ams._get_state(wf))


def test_lr_scheduler_feeds_get_lr():
    class Halving(LRScheduler):
        def get_lr(self):
            return self.base_lr * 0.5 ** self.last_epoch

    w = torch.nn.Parameter(torch.ones(3))
    sched = Halving(0.4)
    opt = AdamW(sched, parameters=[w])
    assert opt.get_lr() == pytest.approx(0.4)
    sched.step()
    assert opt.get_lr() == pytest.approx(0.2)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)


@pytest.mark.parametrize("kwargs", [
    dict(apply_decay_param_fun=lambda name: True), dict(lr_ratio=0.5),
    dict(grad_clip=object()), dict(lazy_mode=True)])
def test_unported_adamw_arguments_raise(kwargs):
    with pytest.raises(NotImplementedError):
        AdamW(1e-3, parameters=[torch.nn.Parameter(torch.ones(2))],
              **kwargs)


def test_per_group_options_raise_instead_of_being_ignored():
    w = torch.nn.Parameter(torch.ones(2))
    AdamW(1e-3, parameters=[{"params": [w]}])
    with pytest.raises(NotImplementedError, match="learning_rate"):
        AdamW(1e-3, parameters=[{"params": [w], "learning_rate": 0.1}])
