"""Optimizers — port of ``paddle_tpu/optimizer/optimizer.py``: the
``Optimizer`` base with its eager path (``:36-240``) and the nine eager
update rules (``:243-510``), together with the optax mapping the compiled
train step applies to six of them (``paddle_tpu/static/executor.py:76-121``).

**The eager path** (``step``, ``minimize``, ``clear_grad``) updates the
parameters given as ``parameters=`` from their ``.grad``, as the
reference's ``Optimizer.step`` does: the regularizer (``L2Decay`` adds
``coeff * p`` to the gradient, ``L1Decay`` ``coeff * sign(p)``; a
parameter's own ``regularizer`` attribute first; none for ``AdamW``,
whose decay is decoupled), then the gradient clip (``ClipGradByGlobalNorm``,
its norm kept as ``_last_grad_norm`` with no sync), then each parameter's
``_update_param``. The rules are the reference's jitted ones:

- ``SGD``:      ``p - lr * g`` in p's dtype;
- ``Momentum``: ``v = mu * v + g``; ``p - lr * v`` (nesterov ``g + mu * v``),
  the velocity in p's dtype;
- ``Adam``:     moments in float32; ``p = (p32 - lr * m_hat / (sqrt(v_hat)
  + eps)).astype(p.dtype)``;
- ``AdamW``:    ``p32 * (1 - lr * lr_ratio * wd)`` before the moments, then
  Adam's step scaled by ``lr_ratio`` (where ``optax.adamw`` adds
  ``wd * p`` to the update); ``apply_decay_param_fun(name)`` False turns
  the decay off;
- ``Adagrad``:  ``m += g^2``; ``p - lr * g / (sqrt(m) + eps)``;
- ``RMSProp``:  ``ms = rho ms + (1 - rho) g^2`` (centered: minus ``mg^2``
  with ``mg = rho mg + (1 - rho) g``); ``mom = momentum mom + lr g /
  sqrt(. + eps)``; ``p - mom``;
- ``Adamax``:   ``m`` as Adam's, ``u = max(b2 u, |g|)``; ``p - lr / (1 -
  b1^t) m / (u + eps)``;
- ``Lamb``:     ``r = m_hat / (sqrt(v_hat) + eps) + wd p``; ``p - lr *
  trust * r``, ``trust = |p| / |r|`` (1 where either is 0);
- ``AdamDelta``: ``E[g^2]``, ``u = g sqrt(E[u^2] + eps) / sqrt(E[g^2] +
  eps)``, ``E[u^2]``; ``p - lr u``.

Accumulators are float32 for floating parameters (Momentum's velocity
takes the parameter's dtype, as the reference's), made at a parameter's
first step. Every float32 rule computes in float32 and casts back to the
parameter's dtype, so an O2 float16 or bf16 parameter (``amp.decorate``)
is stepped with no master weight. The step count ``t`` is the
optimizer's (``@step``). ``state_dict`` keys are the reference's:
``{param name}_{accumulator}``, ``@step`` and ``LR_Scheduler``; a
parameter's name is its ``name`` attribute where it has one, else
``param_{i}`` by position. State loaded before the first step is held
and consumed when the accumulator is made, as the reference's
``_accumulators_holder``.

**The compiled step's mapping** (``init_state`` / ``update``, used by
``parallel/api.py``'s ``TrainStep``, not by ``step``): the reference's
``TrainStep`` runs ``optax.inject_hyperparams`` over

- ``Adam`` -> ``optax.adam``, ``AdamW`` -> ``optax.adamw``:
  ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``, ``u = mu_hat /
  (sqrt(nu_hat) + eps)`` (+ ``wd p``), ``p - lr u``;
- ``Momentum`` -> ``optax.sgd(momentum, nesterov)``: ``trace = g + mu
  trace``; ``p - lr trace`` (nesterov ``g + mu trace``);
- ``SGD`` -> ``optax.sgd``: ``p - lr g``;
- ``RMSProp`` -> ``optax.rmsprop(decay=rho, eps, momentum, centered)``:
  ``nu = rho nu + (1-rho) g^2`` (centered: ``mu`` too), ``s = g /
  sqrt(nu [- mu^2] + eps)``, ``trace = -lr s + momentum trace``, ``p +
  trace``;
- ``Adagrad`` -> ``optax.adagrad(eps)``: ``sum = 0.1 + ...`` (optax's
  ``initial_accumulator_value``, the optimizer's own is not passed),
  ``p - lr g rsqrt(sum + eps)`` where ``sum > 0``;
- ``Lamb`` -> ``optax.lamb(b1, b2, eps, weight_decay)``: Adam's ``u`` plus
  ``wd p``, times ``|p| / |u|`` (1 where either is 0), ``p - lr u``.

What optax drops, the port's ``TrainStep`` refuses (ROADMAP caveats 4,
12, 15, 16, 17): AdamW's ``apply_decay_param_fun`` and ``lr_ratio``,
Adam's ``weight_decay``, Momentum's ``weight_decay`` and
``rescale_grad``, any regularizer of SGD, RMSProp and Adagrad, Adagrad's
``initial_accumulator_value``, Lamb's ``exclude_from_weight_decay_fn``,
and Adamax and AdamDelta, which the reference's mapping gives
``optax.sgd`` without a word (caveat 16). The compiled step's state and
hyperparameters are float32 whatever the parameters' dtype, the update
cast back to each parameter's dtype; the reference's follow the
parameters' dtype under O2 (caveat 18). ``Adam(lazy_mode=,
multi_precision=)``, which the reference accepts and ignores, are
refused when set.
"""
from __future__ import annotations

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW", "Adagrad", "RMSProp", "Adamax", "Lamb", "AdamDelta",
           "Adadelta"]

_f32 = np.float32


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _coeff(weight_decay):
    return float(getattr(weight_decay, "coeff", weight_decay) or 0.0)


def _refuse_ignored(what):
    raise NotImplementedError(
        f"{what} is accepted and ignored by the reference; "
        "paddle_tpu_torch refuses it (ROADMAP caveat 17)")


class Optimizer:
    """The eager optimizer over ``parameters`` (a list of
    ``torch.nn.Parameter``); see the module docstring."""

    _decoupled_decay = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._grad_clip = grad_clip
        self.regularization = (L2Decay(weight_decay)
                               if isinstance(weight_decay, (int, float))
                               and not isinstance(weight_decay, bool)
                               else weight_decay)
        self._accumulators = {}         # name -> {id(param): tensor}
        self._accumulators_holder = {}  # "{param}_{name}" -> tensor
        self._step_count = 0
        self._last_grad_norm = None

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using LRScheduler")
        self._learning_rate = float(value)

    def _lr_sched_step(self):
        if isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.step()

    # -- parameters ---------------------------------------------------------
    def _params(self):
        if self._parameter_list is None:
            raise ValueError("optimizer created without parameters")
        return self._parameter_list

    def _names(self):
        """``{id(param): name}``: a parameter's ``name`` attribute, else
        ``param_{i}`` by its position in the list."""
        return {id(p): getattr(p, "name", None) or f"param_{i}"
                for i, p in enumerate(self._params())}

    def _param_name(self, p):
        return self._names()[id(p)]

    # -- accumulators ---------------------------------------------------------
    def _get_accumulator(self, name, p, init=0.0, dtype=None):
        store = self._accumulators.setdefault(name, {})
        pid = id(p)
        if pid not in store:
            dtype = dtype or (torch.float32 if p.is_floating_point()
                              else p.dtype)
            held = self._accumulators_holder.pop(
                f"{self._param_name(p)}_{name}", None)
            if held is not None:
                store[pid] = torch.as_tensor(held).to(
                    device=p.device, dtype=dtype).clone()
            else:
                store[pid] = torch.full(p.shape, float(init), dtype=dtype,
                                        device=p.device)
        return store[pid]

    def _set_accumulator(self, name, p, value):
        self._accumulators[name][id(p)] = value

    # -- the eager step -------------------------------------------------------
    def _collect_params_grads(self):
        return [(p, p.grad) for p in self._params()
                if p.requires_grad and p.grad is not None]

    def _apply_decay_and_clip(self, params_grads):
        """The regularizer added to each gradient (a parameter's own
        ``regularizer`` first; none for a decoupled decay), then the
        clip (``regularizer.py``, ``optimizer.py:99-128``)."""
        reg = self.regularization
        if reg is not None and not self._decoupled_decay:
            out = []
            for p, g in params_grads:
                reg_p = getattr(p, "regularizer", None) or reg
                if isinstance(reg_p, L2Decay) and reg_p.coeff:
                    g = g + reg_p.coeff * p.to(g.dtype)
                elif isinstance(reg_p, L1Decay) and reg_p.coeff:
                    g = g + reg_p.coeff * torch.sign(p.to(g.dtype))
                out.append((p, g))
            params_grads = out
        if self._grad_clip is not None and params_grads:
            grads, norm, _ = self._grad_clip.clip_and_norm(
                [g for _, g in params_grads])
            params_grads = list(zip([p for p, _ in params_grads], grads))
            self._last_grad_norm = norm
        return params_grads

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        params_grads = self._apply_decay_and_clip(
            self._collect_params_grads())
        for p, g in params_grads:
            self._update_param(p, g.to(p.dtype) if g.dtype != p.dtype
                               else g)

    minimize_step = step

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` and :meth:`step` (eager only); returns
        ``(None, [(param, grad)])``."""
        if startup_program is not None or parameters is not None \
                or no_grad_set is not None:
            raise NotImplementedError(
                "minimize(startup_program=, parameters=, no_grad_set=) "
                "is the static graph's, not ported to paddle_tpu_torch")
        loss.backward()
        self.step()
        return None, self._collect_params_grads()

    def clear_grad(self, set_to_zero=False):
        for p in self._params():
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def _update_param(self, p, g):
        raise NotImplementedError

    def _scalars(self):
        """The step's float32 scalars: lr and t (``jnp.float32`` in the
        reference's jitted rules)."""
        return _f32(self.get_lr()), _f32(self._step_count)

    # -- state ----------------------------------------------------------------
    def state_dict(self):
        sd = {}
        names = self._names()
        for acc_name, store in self._accumulators.items():
            for pid, t in store.items():
                if pid in names:
                    sd[f"{names[pid]}_{acc_name}"] = t.detach().clone()
        for key, t in self._accumulators_holder.items():
            sd.setdefault(key, torch.as_tensor(t).clone())
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@step"] = self._step_count
        return sd

    def set_state_dict(self, state_dict):
        by_name = {n: p for p in self._params()
                   for n in [self._names()[id(p)]]}
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for key, val in state_dict.items():
            if key in ("LR_Scheduler", "@step"):
                continue
            t = torch.as_tensor(np.asarray(val) if not isinstance(
                val, torch.Tensor) else val).clone()
            applied = False
            for acc_name, store in self._accumulators.items():
                suffix = "_" + acc_name
                if key.endswith(suffix):
                    p = by_name.get(key[:-len(suffix)])
                    if p is not None and id(p) in store:
                        store[id(p)] = t.to(device=store[id(p)].device,
                                            dtype=store[id(p)].dtype)
                        applied = True
            if not applied:
                self._accumulators_holder[key] = t
        return self

    set_dict = set_state_dict

    # -- the compiled step's state (TrainStep) --------------------------------
    def init_state(self, params, device_count=False):
        raise NotImplementedError(
            f"{type(self).__name__} has no compiled-step mapping")


def _zeros(params):
    """Float32 zeros beside each parameter (the compiled step's state)."""
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _apply(params, upd, want_update):
    """``params += upd`` (float32 updates, each rounded once into its
    parameter's dtype); returns ``upd`` when asked, for the numerics pass."""
    torch._foreach_add_(params, upd)
    return upd if want_update else None


class _CountedMoments:
    """The step count of a compiled-step state with Adam's moments: a
    Python int, or with ``device_count`` a 0-d int64 tensor on the
    parameters' device (a step that may be rejected on the device must
    not count, and the host cannot know without a sync)."""

    def _init_count(self, params, device_count):
        if device_count:
            return torch.zeros((), dtype=torch.int64,
                               device=params[0].device)
        return 0

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

    def _count_step(self, state):
        """Advance the count; the bias corrections of the new count."""
        b1, b2 = self._beta1, self._beta2
        if isinstance(state["count"], torch.Tensor):
            state["count"] = state["count"] + 1
            return self._bias_corrections(state["count"])
        state["count"] += 1
        t = state["count"]
        return 1.0 - b1 ** t, 1.0 - b2 ** t

    def _adam_direction(self, grads, state):
        """Moments updated in place; ``m_hat / (sqrt(nu_hat) + eps)``."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        mu, nu = state["mu"], state["nu"]
        bc1, bc2 = self._count_step(state)
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g32, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g32, g32, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        return torch._foreach_div(mu_hat, den)


# -- the nine optimizers -----------------------------------------------------

class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update_param(self, p, g):
        lr, _ = self._scalars()
        p.sub_(torch.tensor(lr, device=p.device).to(p.dtype) * g)

    def init_state(self, params, device_count=False):
        return {}

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.sgd`` step: ``p - lr g``."""
        return _apply(params, torch._foreach_mul(
            [g.float() for g in grads], -float(lr)), want_update)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, rescale_grad=1.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = float(momentum)
        self._use_nesterov = bool(use_nesterov)
        self._wd = _coeff(weight_decay)
        self._rescale_grad = float(rescale_grad)

    def _update_param(self, p, g):
        if self._rescale_grad != 1.0:
            _refuse_ignored("Momentum(rescale_grad=...) in the eager step")
        lr, _ = self._scalars()
        vel = self._get_accumulator("velocity", p, dtype=p.dtype)
        mu = torch.tensor(self._momentum, dtype=p.dtype, device=p.device)
        v2 = mu * vel + g
        upd = g + mu * v2 if self._use_nesterov else v2
        p.sub_(torch.tensor(lr, device=p.device).to(p.dtype)
               * upd.to(p.dtype))
        self._set_accumulator("velocity", p, v2)

    def init_state(self, params, device_count=False):
        """A zero trace (float32, beside each parameter); ``optax.sgd``
        keeps no step count, so ``device_count`` changes nothing."""
        return {"trace": _zeros(params)}

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.sgd`` momentum step at learning rate ``lr``, in
        place on ``params`` and ``state``."""
        mu, trace = self._momentum, state["trace"]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(trace, mu)
        torch._foreach_add_(trace, g32)
        d = trace
        if self._use_nesterov:
            d = torch._foreach_add(g32, trace, alpha=mu)
        return _apply(params, torch._foreach_mul(d, -float(lr)),
                      want_update)


class Adam(_CountedMoments, Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        if lazy_mode:
            _refuse_ignored("Adam(lazy_mode=True)")
        if multi_precision:
            _refuse_ignored("Adam(multi_precision=True)")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._wd = _coeff(weight_decay)

    def _moments(self, p, g):
        """Adam's float32 moment update (``_adam_update``): ``(g32, m2, v2,
        m_hat, v_hat)`` with the accumulators replaced."""
        lr, t = self._scalars()
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        one = _f32(1)
        g32 = g.float()
        m = self._get_accumulator("moment1", p)
        v = self._get_accumulator("moment2", p)
        m2 = float(b1) * m + float(one - b1) * g32
        v2 = float(b2) * v + float(one - b2) * (g32 * g32)
        self._set_accumulator("moment1", p, m2)
        self._set_accumulator("moment2", p, v2)
        return (m2 / float(one - b1 ** t), v2 / float(one - b2 ** t))

    def _update_param(self, p, g):
        lr, _ = self._scalars()
        mhat, vhat = self._moments(p, g)
        upd = float(lr) * mhat / (torch.sqrt(vhat) + float(
            _f32(self._epsilon)))
        p.copy_((p.float() - upd).to(p.dtype))

    def init_state(self, params, device_count=False):
        """Zero moments (float32, beside each parameter) and a zero step
        count (see ``_CountedMoments``)."""
        return {"count": self._init_count(params, device_count),
                "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.adam`` step (``optax.adamw`` with a decay) at
        learning rate ``lr``, in place on ``params`` and ``state``."""
        upd = self._adam_direction(grads, state)
        if self._wd:
            torch._foreach_add_(upd, [p.float() for p in params],
                                alpha=self._wd)
        torch._foreach_mul_(upd, -float(lr))
        return _apply(params, upd, want_update)


class AdamW(Adam):
    _decoupled_decay = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision)
        self._wd = _coeff(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, g):
        lr, _ = self._scalars()
        wd = _f32(self._wd)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            wd = _f32(0.0)
        ratio = _f32(1.0 if self._lr_ratio is None else self._lr_ratio(p))
        p32 = p.float() * float(_f32(1) - lr * ratio * wd)
        mhat, vhat = self._moments(p, g)
        upd = float(lr * ratio) * mhat / (torch.sqrt(vhat) + float(
            _f32(self._epsilon)))
        p.copy_((p32 - upd).to(p.dtype))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = float(epsilon)
        self._init_acc = float(initial_accumulator_value)

    def _update_param(self, p, g):
        lr, _ = self._scalars()
        g32 = g.float()
        m2 = self._get_accumulator("moment", p, init=self._init_acc) \
            + g32 * g32
        upd = float(lr) * g32 / (torch.sqrt(m2) + float(_f32(self._epsilon)))
        p.copy_((p.float() - upd).to(p.dtype))
        self._set_accumulator("moment", p, m2)

    OPTAX_INITIAL_ACCUMULATOR = 0.1   # optax.adagrad's default

    def init_state(self, params, device_count=False):
        return {"sum": [torch.full_like(p, self.OPTAX_INITIAL_ACCUMULATOR,
                                        dtype=torch.float32)
                        for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.adagrad`` step: ``sum += g^2``; ``p - lr g
        rsqrt(sum + eps)`` where ``sum > 0`` (else no move)."""
        g32 = [g.float() for g in grads]
        torch._foreach_addcmul_(state["sum"], g32, g32)
        upd = []
        for s, g in zip(state["sum"], g32):
            inv = torch.where(s > 0, torch.rsqrt(s + self._epsilon),
                              torch.zeros((), device=s.device))
            upd.append(inv * g * -float(lr))
        return _apply(params, upd, want_update)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = float(rho)
        self._epsilon = float(epsilon)
        self._momentum = float(momentum)
        self._centered = bool(centered)

    def _update_param(self, p, g):
        lr, _ = self._scalars()
        rho, eps = _f32(self._rho), _f32(self._epsilon)
        g32 = g.float()
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum_acc", p)
        mg = self._get_accumulator("mean_grad", p)
        ms2 = float(rho) * ms + float(_f32(1) - rho) * g32 * g32
        if self._centered:
            mg = float(rho) * mg + float(_f32(1) - rho) * g32
            denom = torch.sqrt(ms2 - mg * mg + float(eps))
        else:
            denom = torch.sqrt(ms2 + float(eps))
        mom2 = float(_f32(self._momentum)) * mom + float(lr) * g32 / denom
        p.copy_((p.float() - mom2).to(p.dtype))
        self._set_accumulator("mean_square", p, ms2)
        self._set_accumulator("momentum_acc", p, mom2)
        self._set_accumulator("mean_grad", p, mg)

    def init_state(self, params, device_count=False):
        st = {"nu": _zeros(params), "trace": _zeros(params)}
        if self._centered:
            st["mu"] = _zeros(params)
        return st

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.rmsprop`` step (see the module docstring)."""
        rho, eps = self._rho, self._epsilon
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(state["nu"], rho)
        torch._foreach_addcmul_(state["nu"], g32, g32, value=1.0 - rho)
        if self._centered:
            torch._foreach_mul_(state["mu"], rho)
            torch._foreach_add_(state["mu"], g32, alpha=1.0 - rho)
            den = torch._foreach_sub(state["nu"], torch._foreach_mul(
                state["mu"], state["mu"]))
        else:
            den = [n.clone() for n in state["nu"]]
        torch._foreach_add_(den, eps)
        torch._foreach_rsqrt_(den)
        scaled = torch._foreach_mul(den, g32)
        torch._foreach_mul_(scaled, -float(lr))
        torch._foreach_mul_(state["trace"], self._momentum)
        torch._foreach_add_(state["trace"], scaled)
        return _apply(params, [t.clone() for t in state["trace"]],
                      want_update)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _update_param(self, p, g):
        lr, t = self._scalars()
        b1, b2 = _f32(self._beta1), _f32(self._beta2)
        g32 = g.float()
        m2 = float(b1) * self._get_accumulator("moment", p) \
            + float(_f32(1) - b1) * g32
        inf2 = torch.maximum(float(b2) * self._get_accumulator(
            "inf_norm", p), g32.abs())
        upd = float(lr / (_f32(1) - b1 ** t)) * m2 / (
            inf2 + float(_f32(self._epsilon)))
        p.copy_((p.float() - upd).to(p.dtype))
        self._set_accumulator("moment", p, m2)
        self._set_accumulator("inf_norm", p, inf2)


class Lamb(_CountedMoments, Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._wd = float(lamb_weight_decay)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g):
        lr, t = self._scalars()
        b1, b2, eps = _f32(self._beta1), _f32(self._beta2), _f32(
            self._epsilon)
        wd = _f32(self._wd)
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = _f32(0.0)
        g32, p32 = g.float(), p.float()
        m2 = float(b1) * self._get_accumulator("moment1", p) \
            + float(_f32(1) - b1) * g32
        v2 = float(b2) * self._get_accumulator("moment2", p) \
            + float(_f32(1) - b2) * g32 * g32
        mhat = m2 / float(_f32(1) - b1 ** t)
        vhat = v2 / float(_f32(1) - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + float(eps)) + float(wd) * p32
        r_norm, w_norm = torch.linalg.norm(r), torch.linalg.norm(p32)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones((), device=p.device))
        p.copy_((p32 - float(lr) * ratio * r).to(p.dtype))
        self._set_accumulator("moment1", p, m2)
        self._set_accumulator("moment2", p, v2)

    def init_state(self, params, device_count=False):
        return {"count": self._init_count(params, device_count),
                "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def update(self, params, grads, state, lr, want_update=False):
        """One ``optax.lamb`` step (see the module docstring)."""
        upd = self._adam_direction(grads, state)
        p32 = [p.float() for p in params]
        if self._wd:
            torch._foreach_add_(upd, p32, alpha=self._wd)
        pn = torch._foreach_norm(p32)
        un = torch._foreach_norm(upd)
        for u, a, b in zip(upd, pn, un):
            ratio = torch.where((a == 0) | (b == 0),
                                torch.ones((), device=u.device), a / b)
            u.mul_(ratio * -float(lr))
        return _apply(params, upd, want_update)


class AdamDelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = float(epsilon), float(rho)

    def _update_param(self, p, g):
        rho, eps = self._rho, self._epsilon
        g32 = g.float()
        avg_sq = rho * self._get_accumulator("avg_squared_grad", p) \
            + (1 - rho) * g32 * g32
        avg_up = self._get_accumulator("avg_squared_update", p)
        upd = g32 * torch.sqrt(avg_up + eps) / torch.sqrt(avg_sq + eps)
        avg_up = rho * avg_up + (1 - rho) * upd * upd
        p.copy_((p.float() - self.get_lr() * upd).to(p.dtype))
        self._set_accumulator("avg_squared_grad", p, avg_sq)
        self._set_accumulator("avg_squared_update", p, avg_up)


Adadelta = AdamDelta
