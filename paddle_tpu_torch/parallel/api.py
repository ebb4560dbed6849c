"""The train step — port of ``paddle_tpu/parallel/api.py``
(``TrainStep``) for one device.

``TrainStep(model, loss_fn, optimizer)`` runs ``loss_fn(model, *batch)``,
its backward, the optimizer's gradient clip and the ``optax.adamw`` or
``optax.sgd`` momentum update (``AdamW`` or ``Momentum``,
``optimizer/optimizer.py``), as the reference's compiled step does
(``:328-378``), eagerly: PyTorch needs no trace. The model's parameters
are updated in place.

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
  optimizer state (old copies kept in buffers of the same size; AdamW's
  step count lives on the device, so it does not advance either). As in
  the reference, buffers are not masked, and without the pass
  (``numerics=None``) nothing is masked (ROADMAP caveat 14).

What the reference's step also does and the port does not yet (a mesh,
FSDP/ZeRO placements, extra state, aux outputs, gradient merge, ASP, an
optimizer other than AdamW and Momentum, a clip other than by global
norm, eval-only steps) raises ``NotImplementedError``, as do AdamW's
``apply_decay_param_fun`` and ``lr_ratio`` and Momentum's
``weight_decay`` and ``rescale_grad``, which the reference's step
silently ignores. The device follows ``resolve_device``: CUDA unless
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn.clip import ClipGradByGlobalNorm
from ..observability.numerics import TensorHealth, stats_tree
from ..optimizer.optimizer import AdamW, Momentum

__all__ = ["TrainStep"]


def _refuse(what):
    raise NotImplementedError(
        f"TrainStep: {what} is not ported to paddle_tpu_torch yet")


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, device=None, *, mesh=None,
                 fsdp_params=False, shard_opt=None, extra_state=None,
                 has_aux=False, numerics=None, numerics_kinds=None,
                 skip_nonfinite=False):
        for what, on in (("mesh", mesh is not None),
                         ("fsdp_params", fsdp_params),
                         ("shard_opt", shard_opt is not None),
                         ("extra_state", extra_state is not None),
                         ("has_aux", has_aux),
                         ("an eval-only step (optimizer=None)",
                          optimizer is None)):
            if on:
                _refuse(what)
        if numerics in ("off", None):
            numerics = None
        elif numerics not in ("stats", "watch"):
            raise ValueError(
                f"numerics must be None|'stats'|'watch', got {numerics!r}")
        if not isinstance(optimizer, (AdamW, Momentum)):
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
        else:
            # optax.sgd takes neither: the reference's step drops them
            if optimizer._wd:
                _refuse("Momentum(weight_decay=...)")
            if optimizer._rescale_grad != 1.0:
                _refuse("Momentum(rescale_grad=...)")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
            _refuse(f"grad_clip {type(clip).__name__}")
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
        self._opt_state = optimizer.init_state(
            self._params, device_count=self._skip_nonfinite)

    def _place(self, a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device)

    def _loss_and_grads(self, batch):
        loss = self.loss_fn(self.model, *batch).sum()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self._params, grads)]

    def _state_tensors(self):
        """The parameters and every tensor of the optimizer state in a
        list (the step count aside)."""
        out = list(self._params)
        for v in self._opt_state.values():
            if isinstance(v, list):
                out.extend(v)
        return out

    def _step(self, batch, lr, include_grads=True):
        """One step: loss, gradients, the clip, the numerics pass and the
        (masked) update. Returns ``(loss, health-or-None)``."""
        loss, raw = self._loss_and_grads(batch)
        with torch.no_grad():
            return self._update(loss, raw, lr, include_grads)

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
        upd = self.optimizer.update(self._params, grads, self._opt_state, lr)
        if "update" in kinds:       # optax's update: -lr times the direction
            health["update"] = stats_tree(torch._foreach_mul(upd, -float(lr)))
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
        loss, health = self._step([self._place(a) for a in batch],
                                  self.optimizer.get_lr())
        if health is not None:
            self.last_numerics = health
        self.optimizer._lr_sched_step()
        return loss

    def multi_step(self, *stacked_batch):
        """K steps; each argument has a leading steps axis ``[K, ...]``.
        Returns the per-step losses as one ``[K]`` tensor. With numerics
        on, ``last_numerics`` is the window's verdict (no raw gradients,
        as the reference's scan)."""
        arrays = [self._place(a) for a in stacked_batch]
        k = int(arrays[0].shape[0])
        lrs = []
        for _ in range(k):
            lrs.append(self.optimizer.get_lr())
            self.optimizer._lr_sched_step()
        losses, healths = [], []
        for i in range(k):
            loss, health = self._step([a[i] for a in arrays], lrs[i],
                                      include_grads=False)
            losses.append(loss)
            healths.append(health)
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
        """``(loss, grads, None)`` without an update: the reference's
        triple, with no aux."""
        loss, grads = self._loss_and_grads([self._place(a) for a in batch])
        return loss, grads, None
