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

What the reference's step also does and the port does not yet (a mesh,
FSDP/ZeRO placements, the numerics pass, skipping non-finite steps,
extra state, aux outputs, gradient merge, ASP, an optimizer other than
AdamW and Momentum, a clip other than by global norm, eval-only steps)
raises ``NotImplementedError``, as do AdamW's ``apply_decay_param_fun``
and ``lr_ratio`` and Momentum's ``weight_decay`` and ``rescale_grad``,
which the reference's step silently ignores. The device
follows ``resolve_device``: CUDA unless ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn.clip import ClipGradByGlobalNorm
from ..optimizer.optimizer import AdamW, Momentum

__all__ = ["TrainStep"]


def _refuse(what):
    raise NotImplementedError(
        f"TrainStep: {what} is not ported to paddle_tpu_torch yet")


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, device=None, *, mesh=None,
                 fsdp_params=False, shard_opt=None, extra_state=None,
                 has_aux=False, numerics=None, skip_nonfinite=False):
        for what, on in (("mesh", mesh is not None),
                         ("fsdp_params", fsdp_params),
                         ("shard_opt", shard_opt is not None),
                         ("extra_state", extra_state is not None),
                         ("has_aux", has_aux),
                         ("numerics", numerics not in (None, "off")),
                         ("skip_nonfinite", skip_nonfinite),
                         ("an eval-only step (optimizer=None)",
                          optimizer is None)):
            if on:
                _refuse(what)
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
        self._opt_state = optimizer.init_state(self._params)

    def _place(self, a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return t.to(self.device)

    def _loss_and_grads(self, batch):
        loss = self.loss_fn(self.model, *batch).sum()
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self._params, grads)]

    def _apply(self, grads, lr):
        clip = self.optimizer._grad_clip
        if clip is not None:
            grads = clip.clip(grads)
        self.optimizer.update(self._params, grads, self._opt_state, lr)

    def __call__(self, *batch):
        loss, grads = self._loss_and_grads([self._place(a) for a in batch])
        self._apply(grads, self.optimizer.get_lr())
        self.optimizer._lr_sched_step()
        return loss

    def multi_step(self, *stacked_batch):
        """K steps; each argument has a leading steps axis ``[K, ...]``.
        Returns the per-step losses as one ``[K]`` tensor."""
        arrays = [self._place(a) for a in stacked_batch]
        k = int(arrays[0].shape[0])
        lrs = []
        for _ in range(k):
            lrs.append(self.optimizer.get_lr())
            self.optimizer._lr_sched_step()
        losses = []
        for i in range(k):
            loss, grads = self._loss_and_grads([a[i] for a in arrays])
            self._apply(grads, lrs[i])
            losses.append(loss)
        return torch.stack(losses)

    def grad_step(self, *batch):
        """``(loss, grads, None)`` without an update: the reference's
        triple, with no aux."""
        loss, grads = self._loss_and_grads([self._place(a) for a in batch])
        return loss, grads, None
