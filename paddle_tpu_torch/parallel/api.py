"""The train step — port of ``paddle_tpu/parallel/api.py``
(``TrainStep``) for one device.

``TrainStep(model, loss_fn, optimizer)`` runs ``loss_fn(model, *batch)``,
its backward, the optimizer's gradient clip and the optax update the
reference maps the optimizer to (``Adam``, ``AdamW``, ``Momentum``,
``SGD``, ``RMSProp``, ``Adagrad``, ``Lamb``; ``optimizer/optimizer.py``),
as the reference's compiled step does (``:328-378``), eagerly: PyTorch
needs no trace. The model's parameters are updated in place; the
optimizer state and hyperparameters are float32 whatever the
parameters' dtype, each update rounded once into its parameter's dtype
(ROADMAP caveat 18: the reference's follow the parameters' dtype under
O2).

The model's buffers (BatchNorm's running statistics) are carried
through every step as the reference carries them (``:143``, swapped in
and out ``:220-249``, threaded through the scan ``:448-566``, updated by
``grad_step`` too ``:572-613``): here the layer's forward updates its
buffers in place, once a step, so ``__call__``, each step of
``multi_step`` and ``grad_step`` all leave them moved by one batch.

- ``__call__(*batch)``: one step; returns the loss as a device scalar,
  with no host sync (``:409-445``).
- ``multi_step(*stacked)``: ``K`` steps over the leading axis, each at
  its scheduler's learning rate, collected up front as the reference
  does (``:537-544``); returns the ``[K]`` losses on the device.
- ``grad_step(*batch)``: the loss and the gradients aligned with the
  trainable parameters, without an update (``:572-613``).
- ``has_aux=True``: ``loss_fn`` returns ``(loss, aux)`` and the step
  hands ``aux`` back (detached); ``auto_lr_step=False`` leaves the
  scheduler to the caller (hapi's ``LRScheduler`` callback); with
  ``optimizer=None`` the step is eval/predict-only (``:84-89``).
- ``eval_step(*batch)`` / ``predict_step(*inputs)`` (``:795-816``): the
  forward in eval mode without gradients, the loss summed (and aux), or
  the model's outputs; the model's mode is restored after.
- ``apply_grads(grads)`` (``:638-686``): externally computed gradients
  (aligned with the trainable parameters, ``None`` as zeros) through the
  same clip and update, one optimizer state with the full step.
- ``opt_state_dict()`` / ``set_opt_state_dict(state)`` (``:722-740``):
  the optimizer state as host numpy arrays, and back (its structure
  checked).
- The clip is ``ClipGradByGlobalNorm`` with the reference's formula
  (``_clip_and_norm``, ``:254-299``).

- ``numerics="stats"|"watch"`` (``:76-142``): the TensorHealth pass
  (``observability/numerics.py``) of each step, one launch of the
  ``tensor_health`` kernel a kind on CUDA: per-tensor NaN/Inf counts,
  abs-max, sum of squares and exact-zero fraction of the raw (pre-clip)
  gradients (``"stats"``), and of the parameters before the update and
  the updates (``"watch"``, which also hands back the raw gradients),
  with the global gradient norm, ``found_inf`` and the loss, kept on the
  device in ``last_numerics``. Nothing syncs with the host until
  :meth:`numerics_view`. Where the global-norm clip is set, the pass
  takes the clip's per-tensor sums of squares (``_health_tree``,
  ``:301``), so turning it on cannot change what the clip computes.
  ``multi_step`` reduces its window as ``_reduce_health_window``
  (``:689``): counts summed, ``found_inf`` or-ed, abs-max the window's
  max, the rest the last step's.
- ``skip_nonfinite=True`` (``:359-372``): with the pass on, a step whose
  raw gradients hold a NaN or an Inf is rejected on the device:
  ``torch.where(found_inf, old, new)`` over the parameters and the whole
  optimizer state (old copies kept in buffers of the same size; Adam's
  step count lives on the device, so it does not advance either). As in
  the reference, buffers are not masked, and without the pass
  (``numerics=None``) nothing is masked (ROADMAP caveat 14).

What the reference's step also does and the port does not yet (a mesh,
FSDP/ZeRO placements, extra state, gradient merge, ASP, a clip other
than by global norm) raises ``NotImplementedError``, as do the optimizer
arguments the reference's optax mapping silently drops (AdamW's
``apply_decay_param_fun`` and ``lr_ratio``, Adam's ``weight_decay``,
Momentum's ``weight_decay`` and ``rescale_grad``, a regularizer of SGD,
RMSProp or Adagrad, Adagrad's ``initial_accumulator_value``, Lamb's
``exclude_from_weight_decay_fn``) and Adamax and AdamDelta, which it
steps as plain SGD (ROADMAP caveat 16). The device follows
``resolve_device``: CUDA unless ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn.clip import ClipGradByGlobalNorm
from ..observability.numerics import TensorHealth, stats_tree
from ..optimizer.optimizer import (SGD, Adagrad, Adam, AdamDelta, Adamax,
                                   AdamW, Lamb, Momentum, RMSProp)

__all__ = ["TrainStep"]


def _refuse(what):
    raise NotImplementedError(
        f"TrainStep: {what} is not ported to paddle_tpu_torch yet")


def _check_optimizer(optimizer):
    """Refuse what the reference's optax mapping drops
    (``static/executor.py:76-121``)."""
    if isinstance(optimizer, (Adamax, AdamDelta)):
        raise NotImplementedError(
            f"TrainStep: the reference's compiled step runs "
            f"{type(optimizer).__name__} as plain optax.sgd without a "
            "word (static/executor.py:121); paddle_tpu_torch refuses it "
            "(ROADMAP caveat 16): use its eager step()")
    if not isinstance(optimizer, (Adam, Momentum, SGD, RMSProp, Adagrad,
                                  Lamb)):
        _refuse(f"optimizer {type(optimizer).__name__}")
    if getattr(optimizer, "_grad_merge_k", 0) > 1:
        _refuse("gradient merge")
    if getattr(optimizer, "_asp_masks_by_param", None):
        _refuse("ASP")
    if isinstance(optimizer, AdamW):
        if optimizer._apply_decay_param_fun is not None:
            _refuse("AdamW(apply_decay_param_fun=...)")
        if optimizer._lr_ratio is not None:
            _refuse("AdamW(lr_ratio=...)")
    elif isinstance(optimizer, Adam):
        # optax.adam takes no decay: the reference's step drops it
        if optimizer._wd:
            _refuse("Adam(weight_decay=...)")
    elif isinstance(optimizer, Momentum):
        # optax.sgd takes neither: the reference's step drops them
        if optimizer._wd:
            _refuse("Momentum(weight_decay=...)")
        if optimizer._rescale_grad != 1.0:
            _refuse("Momentum(rescale_grad=...)")
    elif isinstance(optimizer, Lamb):
        if optimizer._exclude_fn is not None:
            _refuse("Lamb(exclude_from_weight_decay_fn=...)")
    else:
        # optax.sgd / rmsprop / adagrad take no decay
        reg = optimizer.regularization
        if reg is not None and getattr(reg, "coeff", 0.0):
            _refuse(f"{type(optimizer).__name__}(weight_decay=...)")
        if isinstance(optimizer, Adagrad) and optimizer._init_acc != 0.0:
            _refuse("Adagrad(initial_accumulator_value=...)")
    clip = optimizer._grad_clip
    if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
        _refuse(f"grad_clip {type(clip).__name__}")


def _detached(tree):
    """``aux`` with every tensor detached (lists, tuples, dicts kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _structure(tree):
    if isinstance(tree, dict):
        return ("dict", tuple(sorted((k, _structure(v))
                                     for k, v in tree.items())))
    if isinstance(tree, (list, tuple)):
        return ("seq", tuple(_structure(v) for v in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return ("leaf", tuple(tree.shape))
    return ("leaf", ())


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, device=None, *, mesh=None,
                 fsdp_params=False, shard_opt=None, extra_state=None,
                 has_aux=False, auto_lr_step=True, numerics=None,
                 numerics_kinds=None, skip_nonfinite=False):
        for what, on in (("mesh", mesh is not None),
                         ("fsdp_params", fsdp_params),
                         ("shard_opt", shard_opt is not None),
                         ("extra_state", extra_state is not None)):
            if on:
                _refuse(what)
        if numerics in ("off", None):
            numerics = None
        elif numerics not in ("stats", "watch"):
            raise ValueError(
                f"numerics must be None|'stats'|'watch', got {numerics!r}")
        if optimizer is not None:
            _check_optimizer(optimizer)
        self._has_aux = bool(has_aux)
        self._auto_lr = bool(auto_lr_step)
        self._step_count = 0
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._param_names = [n for n, _ in named]
        self._params = [p for _, p in named]
        self._numerics = numerics
        if numerics_kinds is None:
            numerics_kinds = (("grad", "param", "update")
                              if numerics == "watch" else ("grad",))
        self._numerics_kinds = tuple(numerics_kinds)
        self._skip_nonfinite = bool(skip_nonfinite)
        self._mask = numerics is not None and self._skip_nonfinite
        self._old = None           # the masked step's copies of the state
        self.last_numerics = None  # device stats of the last step
        self._opt_state = None if optimizer is None else \
            optimizer.init_state(self._params,
                                 device_count=self._skip_nonfinite)

    def _place(self, a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device)

    def _split(self, res):
        """``(loss, aux)`` of a ``loss_fn`` result."""
        if self._has_aux:
            loss, aux = res
            return loss, _detached(aux)
        return res, None

    def _loss_and_grads(self, batch):
        loss, aux = self._split(self.loss_fn(self.model, *batch))
        loss = loss.sum()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self._params, grads)], aux

    def _need_optimizer(self):
        if self.optimizer is None:
            raise RuntimeError("TrainStep built without an optimizer is "
                               "eval/predict-only")

    def _state_tensors(self):
        """The parameters and every tensor of the optimizer state in a
        list (the step count aside)."""
        if self._opt_state is None:
            return list(self._params)
        out = list(self._params)
        for v in self._opt_state.values():
            if isinstance(v, list):
                out.extend(v)
        return out

    def _step(self, batch, lr, include_grads=True):
        """One step: loss, gradients, the clip, the numerics pass and the
        (masked) update. Returns ``(loss, health-or-None, aux)``."""
        loss, raw, aux = self._loss_and_grads(batch)
        with torch.no_grad():
            return (*self._update(loss, raw, lr, include_grads), aux)

    def _update(self, loss, raw, lr, include_grads):
        clip = self.optimizer._grad_clip
        grads, gnorm, sqs = raw, None, None
        if clip is not None:
            grads, gnorm, sqs = clip.clip_and_norm(raw)
        if self._numerics is None:
            self.optimizer.update(self._params, grads, self._opt_state, lr)
            return loss, None
        kinds = self._numerics_kinds
        # the raw gradients' pass is what found_inf reads, whatever kinds
        gs = stats_tree(raw, sq_sums=sqs)
        if gnorm is None:
            gnorm = gs["sq_sum"].sum().sqrt()
        health = {}
        if "grad" in kinds:
            health["grad"] = gs
        if "param" in kinds:        # before the update, as the reference
            health["param"] = stats_tree(self._params)
        found = (gs["nan"].sum() + gs["inf"].sum()) > 0
        if self._mask:
            state = self._state_tensors()
            if self._old is None:
                self._old = [torch.empty_like(t) for t in state]
            torch._foreach_copy_(self._old, state)
            old_count = self._opt_state.get("count")
        upd = self.optimizer.update(self._params, grads, self._opt_state, lr,
                                    want_update="update" in kinds)
        if "update" in kinds:       # optax's update, as applied
            health["update"] = stats_tree(upd)
        del upd                     # not held through the mask
        if self._mask:
            # reject the whole update when a raw gradient is not finite:
            # parameters and optimizer state keep their old bits
            for o, n in zip(self._old, state):
                torch.where(found, o, n, out=n)
            if isinstance(old_count, torch.Tensor):
                self._opt_state["count"] = torch.where(
                    found, old_count, self._opt_state["count"])
        health["found_inf"] = found
        health["grad_norm"] = gnorm
        health["loss"] = loss
        if include_grads and self._numerics == "watch":
            health["grad_arrays"] = list(raw)
        return loss, health

    def __call__(self, *batch):
        """One step; the loss, or ``(loss, aux)`` with ``has_aux``."""
        self._need_optimizer()
        loss, health, aux = self._step([self._place(a) for a in batch],
                                       self.optimizer.get_lr())
        if health is not None:
            self.last_numerics = health
        self._step_count += 1
        if self._auto_lr:
            self.optimizer._lr_sched_step()
        return (loss, aux) if self._has_aux else loss

    def multi_step(self, *stacked_batch):
        """K steps; each argument has a leading steps axis ``[K, ...]``.
        Returns the per-step losses as one ``[K]`` tensor. With numerics
        on, ``last_numerics`` is the window's verdict (no raw gradients,
        as the reference's scan)."""
        if self._has_aux:
            raise NotImplementedError(
                "multi_step with has_aux=True would stack K copies of the "
                "aux outputs; call the step per batch instead")
        self._need_optimizer()
        arrays = [self._place(a) for a in stacked_batch]
        k = int(arrays[0].shape[0])
        lrs = []
        for _ in range(k):
            lrs.append(self.optimizer.get_lr())
            if self._auto_lr:
                self.optimizer._lr_sched_step()
        losses, healths = [], []
        for i in range(k):
            loss, health, _ = self._step([a[i] for a in arrays], lrs[i],
                                         include_grads=False)
            losses.append(loss)
            healths.append(health)
        self._step_count += k
        if self._numerics is not None:
            self.last_numerics = self._reduce_health_window(healths)
        return torch.stack(losses)

    @staticmethod
    def _reduce_health_window(healths):
        """K steps' stats reduced to one verdict for the window
        (reference ``_reduce_health_window``): nonfinite counts summed and
        ``found_inf`` or-ed (with ``skip_nonfinite`` a poisoned step j is
        masked out of steps j+1..K-1, so the last step alone would report
        the window clean), abs-max the window's max (NaN propagates),
        point-in-time values (sums of squares, zero fractions, the norm,
        the loss) the last step's."""
        out = {}
        for key, last in healths[-1].items():
            vals = [h[key] for h in healths]
            if key == "found_inf":
                out[key] = torch.stack(vals).any()
            elif isinstance(last, dict):
                out[key] = {
                    "nan": torch.stack([v["nan"] for v in vals]).sum(
                        0).to(torch.int32),
                    "inf": torch.stack([v["inf"] for v in vals]).sum(
                        0).to(torch.int32),
                    "absmax": torch.stack([v["absmax"] for v in vals]).amax(0),
                    "sq_sum": last["sq_sum"],
                    "zero_frac": last["zero_frac"]}
            else:
                out[key] = last
        return out

    def numerics_view(self, step=None):
        """The last step's :class:`~observability.numerics.TensorHealth`
        (the host view: the one sync of the whole pass), or None when
        numerics is off or no step has run."""
        if self.last_numerics is None:
            return None
        return TensorHealth.from_device(self._param_names,
                                        self.last_numerics, step=step)

    def grad_step(self, *batch):
        """``(loss, grads, aux)`` without an update (aux ``None`` without
        ``has_aux``): the reference's triple."""
        return self._loss_and_grads([self._place(a) for a in batch])

    def apply_grads(self, grads):
        """Apply externally computed gradients (aligned with the trainable
        parameters, ``None`` as zeros) through the clip and the optimizer
        update of the full step: one optimizer state (``:638-686``). No
        numerics pass runs."""
        self._need_optimizer()
        self.last_numerics = None
        gs = [torch.zeros_like(p) if g is None else
              self._place(g).to(p.dtype) for p, g in zip(self._params,
                                                         grads)]
        with torch.no_grad():
            clip = self.optimizer._grad_clip
            if clip is not None:
                gs = clip.clip(gs)
            self.optimizer.update(self._params, gs, self._opt_state,
                                  self.optimizer.get_lr())
        self._step_count += 1
        if self._auto_lr:
            self.optimizer._lr_sched_step()

    # -- optimizer-state checkpointing (:722-740) -------------------------
    def opt_state_dict(self):
        """The optimizer state as host numpy arrays (the step count a
        Python int), or None without an optimizer."""
        if self._opt_state is None:
            return None
        return _to_host(self._opt_state)

    def set_opt_state_dict(self, state):
        """Load a state from :meth:`opt_state_dict` (numpy arrays or
        tensors); raises when its structure differs from this step's."""
        if state is None or self._opt_state is None:
            return
        if _structure(state) != _structure(self._opt_state):
            raise ValueError("optimizer state structure mismatch")

        def load(cur, new):
            if isinstance(cur, dict):
                return {k: load(cur[k], new[k]) for k in cur}
            if isinstance(cur, list):
                return [load(c, n) for c, n in zip(cur, new)]
            if isinstance(cur, torch.Tensor):
                return torch.as_tensor(np.asarray(new)).to(
                    device=cur.device, dtype=cur.dtype).clone()
            return type(cur)(np.asarray(new).item()) \
                if isinstance(cur, (int, float)) else new
        self._opt_state = load(self._opt_state, state)

    # -- eval / predict (:741-816) ------------------------------------------
    def _run_fwd(self, fn, batch):
        """``fn(model, *batch)`` in eval mode without gradients; the
        model's mode restored after."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return fn(self.model, *[self._place(a) for a in batch])
        finally:
            if was_training:
                self.model.train()

    def eval_step(self, *batch):
        """The loss summed (a device scalar), or ``(loss, aux)`` with
        ``has_aux``, in eval mode; no update, no buffer moves."""
        loss, aux = self._split(self._run_fwd(self.loss_fn, batch))
        loss = loss.sum()
        return (loss, aux) if self._has_aux else loss

    def predict_step(self, *inputs):
        """The model's outputs on ``inputs`` in eval mode."""
        return _detached(self._run_fwd(lambda m, *ins: m(*ins), inputs))
