"""Automatic mixed precision (counterpart: ``paddle_tpu/amp``).

- :func:`auto_cast` (O1, O2): the JAX package's op-layer cast rule
  (:mod:`.state`), not ``torch.autocast``.
- :func:`decorate` (O2): casts every float32 parameter to the AMP dtype
  and keeps its ORIGINAL float32 tensor as ``p._master_weight``, which
  the optimizer takes as the leaf's master (``multi_precision``), so the
  masters are the float32 values themselves, not the bf16 params widened.
  ``master_grad=True`` accumulates each low-precision parameter's
  gradient in float32 in ``p.main_grad`` (K4 reads float32 grads under
  bf16 params); autograd sums a parameter's uses within one backward in
  its own dtype first, where the JAX package's tape casts each one.
- :class:`GradScaler`: dynamic loss scaling. :meth:`GradScaler.unscale_`
  unscales every grad and looks for infs and NaNs in one multi-tensor
  pass a device and dtype, with one host read a step for the
  ``_found_inf`` that :meth:`GradScaler.step` branches on.
"""
from __future__ import annotations

import contextlib

import torch

from ..device import resolve_dtype
from .state import amp_state

__all__ = ["auto_cast", "autocast", "amp_guard", "decorate", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported"]

@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    st = amp_state()
    prev = st.snapshot()
    st.enabled = bool(enable)
    st.dtype = resolve_dtype(dtype)
    st.level = level
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        st.restore(prev)


autocast = auto_cast
amp_guard = auto_cast


def _to_main_grad(p):
    """Post-accumulate hook: move a low-precision grad into the float32
    ``p.main_grad``, adding to what an earlier backward left there."""
    if p.grad.dtype == torch.float32:
        return
    g = p.grad.float()
    p.main_grad = g if getattr(p, "main_grad", None) is None \
        else p.main_grad.add_(g)
    p.grad = None


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """O2: cast the models' float32 parameters to ``dtype`` in place,
    each keeping its original float32 tensor as ``_master_weight``; the
    optimizers keep master weights (``master_weight``, default: at O2)."""
    if save_dtype is not None:
        raise NotImplementedError(
            "decorate(save_dtype=...) is not ported to paddle_tpu_torch "
            "(the JAX package accepts it and never reads it)")
    d = resolve_dtype(dtype)
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p._master_weight = p.data
                        p.data = p.data.to(d)
        if master_grad:
            for m in model_list:
                for p in m.parameters():
                    p.register_post_accumulate_grad_hook(_to_main_grad)
    if optimizers is None:
        return models if single else model_list
    for o in (optimizers if isinstance(optimizers, (list, tuple))
              else [optimizers]):
        o._use_master_weights = (level == "O2") if master_weight is None \
            else master_weight
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling: ``scale`` / ``unscale_`` / ``step`` /
    ``minimize`` / ``update``, growth by ``incr_ratio`` after
    ``incr_every_n_steps`` good steps, backoff by ``decr_ratio`` (not below
    1) after ``decr_every_n_nan_or_inf`` bad ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        return loss * self._scale if self._enable else loss

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Multiply every grad by 1 / scale in place and set
        ``_found_inf``: one ``_amp_foreach_non_finite_check_and_unscale_``
        a device and dtype, one host read."""
        if not self._enable:
            return
        from ..optimizer.optimizer import grad_of
        groups = {}
        for p in optimizer._all_params():
            g = grad_of(p)
            if g is not None:
                groups.setdefault((g.device, g.dtype), []).append(g)
        found = []
        for (dev, _), grads in groups.items():
            f = torch.zeros(1, dtype=torch.float32, device=dev)
            inv = torch.full((1,), 1.0 / self._scale, dtype=torch.float32,
                             device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(grads, f, inv)
            found.append(f.to(found[0].device) if found else f)
        self._found_inf = bool(torch.stack(found).sum() > 0) if found \
            else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_every_n_steps": self._incr_every,
                "decr_every_n_nan_or_inf": self._decr_every,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return torch.cuda.is_available()
