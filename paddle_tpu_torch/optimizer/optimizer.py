"""Optimizers — port of ``paddle_tpu/optimizer/optimizer.py`` (the
``Optimizer`` base, ``Momentum`` ``:336``, ``Adam`` ``:353`` and its
subclass ``AdamW`` ``:375``) together with the mapping the compiled train
step applies to them (``paddle_tpu/static/executor.py:76-106``).

The reference's ``TrainStep`` does not run ``_update_param``: it runs
``optax.inject_hyperparams(optax.adamw)`` (or ``optax.adam``) built from
the optimizer's hyperparameters. So :meth:`Adam.update` follows
``optax.adam`` and, with a decay, ``optax.adamw``:

    mu   = b1 * mu + (1 - b1) * g
    nu   = b2 * nu + (1 - b2) * g * g
    t    = t + 1
    u    = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p    = p - lr * (u + weight_decay * p)

Decay applies to every parameter; ``eps`` sits outside the square root
(as in the reference's eager ``_adam_update``, ``:255-263``). The update
is in place on the parameters and the moments (float32). ``Adam`` has no
decay term: ``optax.adam`` takes none, so the reference's step drops
``Adam(weight_decay=...)`` without a word, and the port's ``TrainStep``
refuses it (``ROADMAP.md`` caveat 15). ``AdamW``'s
``apply_decay_param_fun`` and ``lr_ratio`` are kept on the optimizer, but
the reference's ``TrainStep`` ignores them (caveat 4), so the port's
``TrainStep`` refuses an optimizer that sets them.

:class:`Momentum` follows ``optax.sgd(momentum=, nesterov=)``, which the
reference's ``TrainStep`` runs for it (``executor.py:103-106``):

    trace = g + momentum * trace
    p     = p - lr * trace                       (plain)
    p     = p - lr * (g + momentum * trace)      (use_nesterov)

with a float32 trace, in place. ``optax.sgd`` takes no decay, so the
reference's step drops ``weight_decay`` (and ``rescale_grad``) without a
word; the port's ``TrainStep`` refuses a ``Momentum`` that sets either
(``ROADMAP.md`` caveat 12).
"""
from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW", "Momentum"]


class Optimizer:
    """``parameters`` is accepted for the reference's signature; the
    train step updates its model's trainable parameters."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self._grad_clip = grad_clip

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def _lr_sched_step(self):
        if isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.step()


def _coeff(weight_decay):
    return float(getattr(weight_decay, "coeff", weight_decay) or 0.0)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._wd = _coeff(weight_decay)

    def init_state(self, params, device_count=False):
        """Zero moments (float32, beside each parameter) and a zero step
        count: a Python int, or with ``device_count`` a 0-d int64 tensor
        on the parameters' device (a step that may be rejected on the
        device must not count, and the host cannot know without a
        sync)."""
        count = 0
        if device_count:
            count = torch.zeros((), dtype=torch.int64,
                                device=params[0].device)
        return {"count": count,
                "mu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]}

    def _bias_corrections(self, count):
        """``(1 - b1**count, 1 - b2**count)`` as 0-d float32 tensors for a
        device ``count``: a gather from a table of the host's values
        (the same float32 numbers as the host-count path), grown through
        pinned memory, so nothing waits for the card. The table covers
        every update made with a device count so far."""
        self._device_updates = getattr(self, "_device_updates", 0) + 1
        tab = getattr(self, "_bc_table", None)
        if tab is None or tab.device != count.device \
                or tab.shape[1] <= self._device_updates:
            n = max(64, 2 * self._device_updates)
            host = torch.tensor([[1.0 - self._beta1 ** t for t in range(n)],
                                 [1.0 - self._beta2 ** t for t in range(n)]],
                                dtype=torch.float32)
            if count.device.type == "cuda":
                host = host.pin_memory()
            tab = self._bc_table = host.to(count.device, non_blocking=True)
        bc = torch.index_select(tab, 1, count.reshape(1))
        return bc[0, 0], bc[1, 0]

    @torch.no_grad()
    def update(self, params, grads, state, lr):
        """One ``optax.adam`` step (``optax.adamw`` with a decay) at
        learning rate ``lr``, in place on ``params`` and ``state``
        (float32 parameters and gradients). Returns the step's direction
        ``u + weight_decay * p`` (the parameters moved by ``-lr`` times
        it: optax's update)."""
        b1, b2, eps, wd = self._beta1, self._beta2, self._epsilon, self._wd
        mu, nu = state["mu"], state["nu"]
        if isinstance(state["count"], torch.Tensor):
            state["count"] = state["count"] + 1
            bc1, bc2 = self._bias_corrections(state["count"])
        else:
            state["count"] += 1
            t = state["count"]
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        if wd:
            torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-float(lr))
        return upd


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = _coeff(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0):
        super().__init__(learning_rate, parameters, grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        self._wd = _coeff(weight_decay)
        self._rescale_grad = float(rescale_grad)

    def init_state(self, params, device_count=False):
        """A zero trace (float32, beside each parameter); ``optax.sgd``
        keeps no step count, so ``device_count`` changes nothing."""
        return {"trace": [torch.zeros_like(p, dtype=torch.float32)
                          for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, lr):
        """One ``optax.sgd`` momentum step at learning rate ``lr``, in
        place on ``params`` and ``state``. Returns the step's direction
        (the parameters moved by ``-lr`` times it)."""
        mu, trace = self._momentum, state["trace"]
        torch._foreach_mul_(trace, mu)
        torch._foreach_add_(trace, grads)
        upd = trace
        if self._use_nesterov:
            upd = torch._foreach_add(grads, trace, alpha=mu)
        torch._foreach_add_(params, upd, alpha=-float(lr))
        return upd
