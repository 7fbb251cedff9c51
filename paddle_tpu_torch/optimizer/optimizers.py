"""The optimizers (counterpart: ``paddle_tpu/optimizer/optimizers.py``).

Adam and AdamW: on CUDA parameters a step is ONE launch of the multi-tensor kernel K4
over every leaf (:mod:`..ops.adamw_kernel`), the global-norm clip factor
and the L1 term folded in; on CPU parameters it is the same rule leaf by
leaf. ``amsgrad=True`` takes the plain rule on either
device, as the JAX package takes its XLA rule, and is counted under
``adamw_kernel.stats["amsgrad_plain_calls"]``.

There is no ``use_multi_tensor`` argument: the card's step is always
the multi-tensor kernel, and the JAX package never reads it.

SGD, Momentum, Adagrad, RMSProp, Adamax, Adadelta, Lamb, NAdam, RAdam,
Rprop and ASGD: ``_update`` is the JAX package's rule line for line (on
CPU parameters it runs leaf by leaf), and ``_foreach_update`` the same
arithmetic over every leaf at once in ``torch._foreach_*`` (the step on
CUDA parameters; :data:`.optimizer.stats`). None of them has a TPU
kernel, so plain PyTorch is their port. The scalars of the step count
(bias corrections, NAdam's momentum decay, RAdam's rho_t and its branch)
are float32 on the host, once a step, as the JAX package computes them
on the device; per-leaf scalars (Lamb's trust ratio ||w|| / ||r||,
NAdam's momentum-decay product, which each leaf keeps in its state) stay
on the device. :class:`LBFGS` takes a closure, as the reference's.

Arguments the JAX package stores and never reads raise
``NotImplementedError`` unless left at their defaults rather than being
ignored: ``Adam(lazy_mode=True)``, ``AdamW(apply_decay_param_fun=...,
lr_ratio=...)`` (decay applies to every leaf there),
``Lamb(exclude_from_weight_decay_fn=...)``, ``ASGD(batch_num=...)`` and
``LBFGS(max_eval=..., line_search_fn=..., weight_decay=...,
grad_clip=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import adamw_kernel
from .optimizer import Optimizer, grad_of

__all__ = ["Adam", "AdamW", "SGD", "Momentum", "Adagrad", "RMSProp",
           "Adamax", "Adadelta", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD",
           "LBFGS"]


def _never_read(cls, **args):
    """Refuse the arguments the JAX package stores and never reads:
    ``args`` maps each name to whether it was left at its default."""
    for name, default in args.items():
        if not default:
            raise NotImplementedError(
                f"{cls}({name}=...) is not ported to paddle_tpu_torch (the "
                "JAX package stores it and never reads it)")


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 *, amsgrad=False, name=None):
        _never_read("Adam", lazy_mode=not lazy_mode)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        kw = dict(dtype=torch.float32, device=p.device)
        s = {"moment1": torch.zeros(p.shape, **kw),
             "moment2": torch.zeros(p.shape, **kw)}
        if self._amsgrad:
            s["moment2_max"] = torch.zeros(p.shape, **kw)
        return s

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon,
                "amsgrad": self._amsgrad, "decoupled": False}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        return adamw_kernel.adam_rule(
            param, grad, state, lr, step, b1=hp["b1"], b2=hp["b2"],
            eps=hp["eps"], wd=hp["weight_decay"], decoupled=hp["decoupled"],
            amsgrad=hp["amsgrad"])

    def _apply(self, params, grads, states, lr, step, clip=None,
               clip_mask=None):
        if self._amsgrad:
            adamw_kernel.stats["amsgrad_plain_calls"] += 1
            return super()._apply(params, grads, states, lr, step, clip,
                                  clip_mask)
        hp = self._hyperparams()
        adamw_kernel.adamw_update(
            params, grads, states, lr=lr, step=step, b1=hp["b1"],
            b2=hp["b2"], eps=hp["eps"], wd=hp["weight_decay"],
            decoupled=hp["decoupled"], l1=self._l1, clip=clip,
            clip_mask=clip_mask)


class AdamW(Adam):
    """Decoupled weight decay (default coefficient 0.01) on every leaf."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        _never_read("AdamW", lr_ratio=lr_ratio is None,
                    apply_decay_param_fun=apply_decay_param_fun is None)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)

    def _hyperparams(self):
        hp = super()._hyperparams()
        hp["decoupled"] = True
        return hp


# -- the other optimizers ------------------------------------------------------

def _f32(x):
    return np.float32(x)


def _pow(b, step):
    """``b ** t`` in float32, t the step count as the JAX package's
    ``step.astype(float32)``."""
    return _f32(b) ** _f32(step)


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _col(states, key):
    return [s[key] for s in states]


def _decayed(gs, ws, wd):
    """``grad + wd * param`` leaf for leaf (coupled weight decay)."""
    return torch._foreach_add(gs, torch._foreach_mul(ws, wd)) if wd else gs


def _ema_(xs, ys, beta):
    """``x = beta * x + (1 - beta) * y`` in place."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, torch._foreach_mul(ys, 1 - beta))


def _ema_sq_(xs, gs, beta):
    """``x = beta * x + (1 - beta) * g * g`` in place."""
    torch._foreach_mul_(xs, beta)
    torch._foreach_add_(xs, torch._foreach_mul(
        torch._foreach_mul(gs, 1 - beta), gs))


def _one_minus(xs):
    """``1 - x`` for each tensor of ``xs``."""
    out = torch._foreach_neg(xs)
    torch._foreach_add_(out, 1.0)
    return out


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        return param - lr * grad, {}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        gs = _decayed(gs, ws, hp["weight_decay"])
        torch._foreach_sub_(ws, torch._foreach_mul(gs, lr))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        self._momentum = float(momentum)
        self._nesterov = use_nesterov
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"velocity": _zeros(p)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "mu": self._momentum,
                "nesterov": self._nesterov}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        wd, mu = hp["weight_decay"], hp["mu"]
        if wd:
            grad = grad + wd * param
        v = mu * state["velocity"] + grad
        if hp["nesterov"]:
            new_p = param - lr * (grad + mu * v)
        else:
            new_p = param - lr * v
        return new_p, {"velocity": v}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        mu = hp["mu"]
        gs = _decayed(gs, ws, hp["weight_decay"])
        vs = _col(states, "velocity")
        torch._foreach_mul_(vs, mu)
        torch._foreach_add_(vs, gs)
        step_dir = (torch._foreach_add(gs, torch._foreach_mul(vs, mu))
                    if hp["nesterov"] else vs)
        torch._foreach_sub_(ws, torch._foreach_mul(step_dir, lr))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=torch.float32, device=p.device)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "eps": self._epsilon}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        m = state["moment"] + grad * grad
        return (param - lr * grad / (torch.sqrt(m) + hp["eps"]),
                {"moment": m})

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        gs = _decayed(gs, ws, hp["weight_decay"])
        ms = _col(states, "moment")
        torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
        denom = torch._foreach_sqrt(ms)
        torch._foreach_add_(denom, hp["eps"])
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(gs, lr), denom))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)

    def _init_state(self, p):
        s = {"mean_square": _zeros(p), "moment": _zeros(p)}
        if self._centered:
            s["mean_grad"] = _zeros(p)
        return s

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "rho": self._rho,
                "eps": self._epsilon, "mu": self._momentum,
                "centered": self._centered}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        wd, rho, eps, mu = (hp["weight_decay"], hp["rho"], hp["eps"],
                            hp["mu"])
        if wd:
            grad = grad + wd * param
        ms = rho * state["mean_square"] + (1 - rho) * grad * grad
        out_state = {"mean_square": ms}
        if hp["centered"]:
            mg = rho * state["mean_grad"] + (1 - rho) * grad
            denom = torch.sqrt(ms - mg * mg + eps)
            out_state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = mu * state["moment"] + lr * grad / denom
        out_state["moment"] = mom
        return param - mom, out_state

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        rho, eps, mu = hp["rho"], hp["eps"], hp["mu"]
        gs = _decayed(gs, ws, hp["weight_decay"])
        ms = _col(states, "mean_square")
        _ema_sq_(ms, gs, rho)
        if hp["centered"]:
            mg = _col(states, "mean_grad")
            _ema_(mg, gs, rho)
            denom = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            torch._foreach_add_(denom, eps)
        else:
            denom = torch._foreach_add(ms, eps)
        torch._foreach_sqrt_(denom)
        mom = _col(states, "moment")
        torch._foreach_mul_(mom, mu)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(gs, lr), denom))
        torch._foreach_sub_(ws, mom)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)

    def _init_state(self, p):
        return {"moment": _zeros(p), "inf_norm": _zeros(p)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon}

    @staticmethod
    def _lr_t(lr, step, hp):
        return float(_f32(lr) / (1 - _pow(hp["b1"], step)))

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        m = b1 * state["moment"] + (1 - b1) * grad
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(grad))
        lr_t = Adamax._lr_t(lr, step, hp)
        return (param - lr_t * m / (u + eps),
                {"moment": m, "inf_norm": u})

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        gs = _decayed(gs, ws, hp["weight_decay"])
        ms, us = _col(states, "moment"), _col(states, "inf_norm")
        _ema_(ms, gs, hp["b1"])
        torch._foreach_mul_(us, hp["b2"])
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, hp["eps"])
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(ms, Adamax._lr_t(lr, step, hp)), denom))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        self._rho, self._epsilon = rho, epsilon
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)

    def _init_state(self, p):
        return {"avg_squared_grad": _zeros(p),
                "avg_squared_update": _zeros(p)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "rho": self._rho,
                "eps": self._epsilon}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        rho, eps = hp["rho"], hp["eps"]
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        asg = rho * state["avg_squared_grad"] + (1 - rho) * grad * grad
        upd = (torch.sqrt(state["avg_squared_update"] + eps) /
               torch.sqrt(asg + eps)) * grad
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        return param - lr * upd, {"avg_squared_grad": asg,
                                  "avg_squared_update": asu}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        rho, eps = hp["rho"], hp["eps"]
        gs = _decayed(gs, ws, hp["weight_decay"])
        asg = _col(states, "avg_squared_grad")
        asu = _col(states, "avg_squared_update")
        _ema_sq_(asg, gs, rho)
        upd = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        torch._foreach_div_(upd, torch._foreach_sqrt(
            torch._foreach_add(asg, eps)))
        torch._foreach_mul_(upd, gs)
        _ema_sq_(asu, upd, rho)
        torch._foreach_sub_(ws, torch._foreach_mul(upd, lr))


def _adam_moments_(states, gs, b1, b2):
    m1, m2 = _col(states, "moment1"), _col(states, "moment2")
    _ema_(m1, gs, b1)
    _ema_sq_(m2, gs, b2)
    return m1, m2


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        _never_read("Lamb", exclude_from_weight_decay_fn=(
            exclude_from_weight_decay_fn is None))
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision, name)

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon}

    @staticmethod
    def _corrections(step, hp, device):
        return (torch.tensor(1 - _pow(hp["b1"], step), device=device),
                torch.tensor(1 - _pow(hp["b2"], step), device=device))

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
        bc1, bc2 = Lamb._corrections(step, hp, param.device)
        r = m1 / bc1 / (torch.sqrt(m2 / bc2) + eps) + wd * param
        w_norm = torch.sqrt(torch.sum(param * param))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        return param - lr * trust * r, {"moment1": m1, "moment2": m2}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        m1, m2 = _adam_moments_(states, gs, hp["b1"], hp["b2"])
        bc1, bc2 = Lamb._corrections(step, hp, ws[0].device)
        denom = torch._foreach_sqrt(torch._foreach_div(m2, bc2))
        torch._foreach_add_(denom, hp["eps"])
        r = torch._foreach_div(torch._foreach_div(m1, bc1), denom)
        if hp["weight_decay"]:
            torch._foreach_add_(r, torch._foreach_mul(ws, hp["weight_decay"]))
        w_norm = torch.stack(torch._foreach_norm(ws))
        r_norm = torch.stack(torch._foreach_norm(r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        # one device scalar a leaf: the list-by-list product broadcasts
        torch._foreach_sub_(ws, torch._foreach_mul(r, list(
            (lr * trust).unbind())))


class NAdam(Optimizer):
    """Nesterov Adam with momentum decay ``psi``: the momentum of step t
    is ``b1 * (1 - 0.5 * 0.96 ** (t * psi))``, and each leaf keeps the
    product of the momenta so far as ``mu_product``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._psi = momentum_decay
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, False, name)

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=p.device)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon,
                "psi": self._psi}

    @staticmethod
    def _momenta(step, hp):
        """(mu_t, mu_t+1, 1 - b2 ** t) in float32."""
        b1, psi, t = _f32(hp["b1"]), _f32(hp["psi"]), _f32(step)
        half, decay = _f32(0.5), _f32(0.96)
        mu_t = b1 * (1 - half * decay ** (t * psi))
        mu_t1 = b1 * (1 - half * decay ** ((t + 1) * psi))
        return float(mu_t), float(mu_t1), float(1 - _pow(hp["b2"], step))

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        mu_t, mu_t1, bc2 = NAdam._momenta(step, hp)
        mu_prod = state["mu_product"] * mu_t
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
        m_hat = (mu_t1 * m1 / (1 - mu_prod * mu_t1) +
                 (1 - mu_t) * grad / (1 - mu_prod))
        v_hat = m2 / torch.tensor(bc2, device=param.device)
        new = param - lr * m_hat / (torch.sqrt(v_hat) + eps)
        return new, {"moment1": m1, "moment2": m2, "mu_product": mu_prod}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        gs = _decayed(gs, ws, hp["weight_decay"])
        mu_t, mu_t1, bc2 = NAdam._momenta(step, hp)
        mu_prod = _col(states, "mu_product")
        torch._foreach_mul_(mu_prod, mu_t)
        m1, m2 = _adam_moments_(states, gs, hp["b1"], hp["b2"])
        # per-leaf device scalars: the list-by-list quotients broadcast
        m_hat = torch._foreach_div(torch._foreach_mul(m1, mu_t1),
                                   _one_minus(torch._foreach_mul(mu_prod,
                                                                 mu_t1)))
        torch._foreach_add_(m_hat, torch._foreach_div(
            torch._foreach_mul(gs, 1 - mu_t), _one_minus(mu_prod)))
        denom = torch._foreach_sqrt(torch._foreach_div(
            m2, torch.tensor(bc2, device=ws[0].device)))
        torch._foreach_add_(denom, hp["eps"])
        torch._foreach_sub_(ws, torch._foreach_div(
            torch._foreach_mul(m_hat, lr), denom))


class RAdam(Optimizer):
    """Rectified Adam: the rectified step while the variance's length
    rho_t exceeds 5, the unadapted momentum step before."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, False, name)

    def _init_state(self, p):
        return {"moment1": _zeros(p), "moment2": _zeros(p)}

    def _hyperparams(self):
        return {"weight_decay": self._weight_decay, "b1": self._beta1,
                "b2": self._beta2, "eps": self._epsilon}

    @staticmethod
    def _scalars(step, hp):
        """(1 - b1 ** t, the adaptive step's factor rect * sqrt(1 - b2 **
        t), or None while rho_t <= 5) in float32, as the JAX rule."""
        t, b2t = _f32(step), _pow(hp["b2"], step)
        rho_inf = _f32(2.0 / (1 - hp["b2"]) - 1.0)
        rho_t = rho_inf - _f32(2.0) * t * b2t / (1 - b2t)
        r_num = (rho_t - 4) * (rho_t - 2) * rho_inf
        r_den = (rho_inf - 4) * (rho_inf - 2) * rho_t
        rect = np.sqrt(np.maximum(r_num / np.maximum(r_den, _f32(1e-30)),
                                  _f32(0)))
        adaptive = rect * np.sqrt(1 - b2t) if rho_t > 5 else None
        return float(1 - _pow(hp["b1"], step)), (
            None if adaptive is None else float(adaptive))

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        m1 = b1 * state["moment1"] + (1 - b1) * grad
        m2 = b2 * state["moment2"] + (1 - b2) * grad * grad
        bc1, adaptive = RAdam._scalars(step, hp)
        m_hat = m1 / torch.tensor(bc1, device=param.device)
        if adaptive is None:
            return param - lr * m_hat, {"moment1": m1, "moment2": m2}
        factor = torch.tensor(adaptive, device=param.device) / (
            torch.sqrt(m2) + eps)
        return (param - lr * m_hat * factor,
                {"moment1": m1, "moment2": m2})

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        gs = _decayed(gs, ws, hp["weight_decay"])
        m1, m2 = _adam_moments_(states, gs, hp["b1"], hp["b2"])
        bc1, adaptive = RAdam._scalars(step, hp)
        upd = torch._foreach_mul(torch._foreach_div(
            m1, torch.tensor(bc1, device=ws[0].device)), lr)
        if adaptive is not None:
            denom = torch._foreach_sqrt(m2)
            torch._foreach_add_(denom, hp["eps"])
            c = torch.tensor(adaptive, device=ws[0].device)
            torch._foreach_mul_(upd, torch._foreach_div([c] * len(ws),
                                                        denom))
        torch._foreach_sub_(ws, upd)


class Rprop(Optimizer):
    """Resilient backprop: a step size per element, grown by ``etas[1]``
    where the gradient kept its sign, shrunk by ``etas[0]`` where it
    flipped (and no move there), clipped to ``learning_rate_range``; the
    learning rate is the first step size."""

    def __init__(self, learning_rate=0.01, learning_rate_range=(1e-5, 50),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        self._eta_minus, self._eta_plus = etas
        self._lr_min, self._lr_max = learning_rate_range
        self._lr0 = float(learning_rate)
        super().__init__(learning_rate, parameters, None, grad_clip,
                         False, name)

    def _init_state(self, p):
        return {"prev_grad": _zeros(p),
                "step_size": torch.full(p.shape, self._lr0,
                                        dtype=torch.float32,
                                        device=p.device)}

    def _hyperparams(self):
        return {"weight_decay": 0.0, "em": self._eta_minus,
                "ep": self._eta_plus, "lo": self._lr_min,
                "hi": self._lr_max}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        em, ep, lo, hi = hp["em"], hp["ep"], hp["lo"], hp["hi"]
        sign = torch.sign(grad * state["prev_grad"])
        size = torch.where(sign > 0, state["step_size"] * ep,
                           torch.where(sign < 0, state["step_size"] * em,
                                       state["step_size"]))
        size = torch.clamp(size, lo, hi)
        eff_grad = torch.where(sign < 0, 0.0, grad)
        new = param - torch.sign(eff_grad) * size
        return new, {"prev_grad": eff_grad, "step_size": size}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        prev, size = _col(states, "prev_grad"), _col(states, "step_size")
        s = torch._foreach_sign(torch._foreach_mul(gs, prev))
        # with s in {-1, 0, 1}: grew = s(s+1)/2, flipped = s(s-1)/2 and
        # kept = 1 - grew - flipped are 0/1 masks, every product exact
        grew = torch._foreach_mul(torch._foreach_mul(
            s, torch._foreach_add(s, 1.0)), 0.5)
        flipped = torch._foreach_mul(torch._foreach_mul(
            s, torch._foreach_sub(s, 1.0)), 0.5)
        factor = torch._foreach_add(torch._foreach_mul(grew, hp["ep"]),
                                    torch._foreach_mul(flipped, hp["em"]))
        torch._foreach_add_(factor, _one_minus(torch._foreach_add(
            grew, flipped)))
        torch._foreach_mul_(size, factor)
        torch._foreach_clamp_min_(size, hp["lo"])
        torch._foreach_clamp_max_(size, hp["hi"])
        eff = torch._foreach_mul(gs, _one_minus(flipped))
        # where(flipped, 0, g): a flipped element's g * 0 may be -0.0
        torch._foreach_add_(eff, 0.0)
        torch._foreach_copy_(prev, eff)
        torch._foreach_sub_(ws, torch._foreach_mul(
            torch._foreach_sign(eff), size))


class ASGD(Optimizer):
    """Averaged SGD: SGD steps and, in ``state["averaged"]``, the running
    mean of the iterates (:meth:`averaged_parameters`)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        _never_read("ASGD", batch_num=batch_num == 1)
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, multi_precision, name)

    def _init_state(self, p):
        return {"averaged": p.detach().to(torch.float32, copy=True)}

    @staticmethod
    def _update(param, grad, state, lr, step, hp):
        wd = hp["weight_decay"]
        if wd:
            grad = grad + wd * param
        new = param - lr * grad
        t = torch.tensor(float(step), device=param.device)
        avg = state["averaged"] + (new - state["averaged"]) / t
        return new, {"averaged": avg}

    @staticmethod
    def _foreach_update(ws, gs, states, lr, step, hp):
        SGD._foreach_update(ws, gs, states, lr, step, hp)
        avg = _col(states, "averaged")
        diff = torch._foreach_sub(ws, avg)
        torch._foreach_add_(avg, torch._foreach_div(
            diff, torch.tensor(float(step), device=ws[0].device)))

    def averaged_parameters(self):
        return [self._accum[id(p)]["averaged"]
                for p in self._all_params() if id(p) in self._accum]


class LBFGS(Optimizer):
    """L-BFGS with a closure, as the reference's: the two-loop recursion
    over the last ``history_size`` (s, y) pairs, an Armijo backtracking
    line search, then a Wolfe-style expansion (double t while the
    directional derivative is still above 0.9 of the first and Armijo
    holds). The flat vectors are float32 on the parameters' device; the
    line search and the stopping tests read their scalars on the host,
    as the reference does. ``state_dict`` carries the (s, y) history;
    ``n_iter`` is the last ``step``'s count of iterations."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        _never_read("LBFGS", max_eval=max_eval is None,
                    line_search_fn=line_search_fn is None,
                    weight_decay=weight_decay is None,
                    grad_clip=grad_clip is None)
        super().__init__(learning_rate, parameters, None, None, False, name)
        self._max_iter = max_iter
        self._tol_g = tolerance_grad
        self._tol_x = tolerance_change
        self._hist = history_size
        self._s, self._y = [], []
        self.n_iter = 0

    def _flat(self, arrs):
        return torch.cat([a.reshape(-1).float() for a in arrs])

    def _set_params(self, flat):
        off = 0
        for p in self._all_params():
            n = p.numel()
            p.copy_(flat[off:off + n].view(p.shape))
            off += n

    def _eval(self, closure):
        for p in self._all_params():
            p.grad = None
        with torch.enable_grad():
            loss = closure()
        g = self._flat([grad_of(p) if grad_of(p) is not None
                        else torch.zeros_like(p)
                        for p in self._all_params()])
        return float(loss), g

    def _direction(self, g):
        """The two-loop recursion: ``-H g`` for the history's H."""
        q, alphas = g, []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            q = q * (torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10))
        for a, rho, s, y in reversed(alphas):
            q = q + s * (a - rho * torch.dot(y, q))
        return -q

    @torch.no_grad()
    def step(self, closure):
        """Up to ``max_iter`` iterations on ``closure`` (which computes
        the loss and calls ``backward``); returns the last loss."""
        x = self._flat(list(self._all_params()))
        loss, g = self._eval(closure)
        self.n_iter = 0
        for _ in range(self._max_iter):
            if g.abs().max().item() < self._tol_g:
                break
            self.n_iter += 1
            d = self._direction(g)
            t = float(self.get_lr())
            gtd = torch.dot(g, d).item()
            ok, best = False, None   # best: (t, loss, g), simple decrease
            for _bt in range(25):
                self._set_params(x + t * d)
                new_loss, new_g = self._eval(closure)
                if new_loss <= loss + 1e-4 * t * gtd:
                    ok = True
                    break
                if new_loss < loss and (best is None or new_loss < best[1]):
                    best = (t, new_loss, new_g)
                t *= 0.5
            if not ok:
                if best is None:
                    self._set_params(x)
                    if self._s:
                        # a non-descent direction from an ill-conditioned
                        # pair: drop the history, retry as steepest descent
                        self._s.clear()
                        self._y.clear()
                        continue
                    break
                t, new_loss, new_g = best
                self._set_params(x + t * d)
            else:
                for _ex in range(10):
                    if abs(torch.dot(new_g, d).item()) <= 0.9 * abs(gtd):
                        break
                    t2 = t * 2.0
                    self._set_params(x + t2 * d)
                    l2, g2 = self._eval(closure)
                    if l2 <= loss + 1e-4 * t2 * gtd:
                        t, new_loss, new_g = t2, l2, g2
                    else:
                        self._set_params(x + t * d)
                        break
            x_new = x + t * d
            s_vec, y_vec = x_new - x, new_g - g
            if torch.dot(s_vec, y_vec).item() > 1e-10:
                self._s.append(s_vec)
                self._y.append(y_vec)
                if len(self._s) > self._hist:
                    self._s.pop(0)
                    self._y.pop(0)
            x, loss, g = x_new, new_loss, new_g
            if s_vec.abs().max().item() < self._tol_x:
                break
        self._set_params(x)
        return loss

    def state_dict(self):
        out = super().state_dict()
        for i, (s, y) in enumerate(zip(self._s, self._y)):
            out[f"history_{i}.s"], out[f"history_{i}.y"] = s, y
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        super().set_state_dict(state)
        dev = next(iter(self._all_params())).device
        self._s, self._y = [], []
        i = 0
        while f"history_{i}.s" in state:
            self._s.append(torch.as_tensor(state[f"history_{i}.s"]).to(
                dev, torch.float32))
            self._y.append(torch.as_tensor(state[f"history_{i}.y"]).to(
                dev, torch.float32))
            i += 1

    set_dict = set_state_dict
