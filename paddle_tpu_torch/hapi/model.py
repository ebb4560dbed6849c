"""The high-level ``Model`` API — port of ``paddle_tpu/hapi/model.py``:
the core callbacks (``Callback``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``:15-128``) and ``Model``
(``:135-497``).

``Model(network)`` runs its train, eval and predict batches through the
port's ``TrainStep`` (``parallel/api.py``), built per (inputs, labels,
optimizer-or-not) signature with ``has_aux=True`` and
``auto_lr_step=False``, as the reference builds its compiled step
(``:161-216``): the loss function hands back the network's outputs and
the per-loss values, which feed the metrics. The reference falls back to
eager dispatch when tracing the user's network fails (``:243-257``); the
port has no trace, so it has no such fallback.

``train_batch(update=False)`` runs the forward and backward eagerly and
leaves the gradients accumulated in ``.grad``; the next update applies
the accumulated gradients through the train step's ``apply_grads``
(its optimizer state, one state for both paths; ``:262-280``), or
through the optimizer's eager ``step()`` before any train step exists.

``save(path)`` writes ``path.pdparams`` (the network's ``state_dict``)
and ``path.pdopt`` (the train step's optimizer state under
``__trainstep_opt__``, or the eager optimizer's ``state_dict``) with
``torch.save``; ``load`` restores both (a train-step state is held until
the train step exists). ``prepare(amp_configs=...)``, which the reference
accepts and ignores, is refused (ROADMAP caveat 17). The device follows
``resolve_device``: CUDA unless ``Model(..., device="cpu")``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import amp
from ..device import resolve_device
from ..io import DataLoader, Dataset

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "Model"]


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0

    def on_train_batch_end(self, step, logs=None):
        self.steps += 1
        if self.verbose and self.steps % self.log_freq == 0:
            msg = ", ".join(f"{k}: {v}" for k, v in (logs or {}).items()
                            if k != "batch_size")
            print(f"epoch {self.epoch} step {step}: {msg}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped = False
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        better = (self.best is None or
                  (cur < self.best - self.min_delta
                   if self.mode == "min" else
                   cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            opt = self.model._optimizer
            if opt is not None:
                opt._lr_sched_step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            opt = self.model._optimizer
            if opt is not None:
                opt._lr_sched_step()


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host(t):
    """A loss or output as numpy (float32 for a low-precision float)."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _add_n(losses):
    """The reference's ``add_n`` of several losses (one op under the
    autocast rule)."""
    losses = amp.cast_inputs("add_n", *losses)
    total = losses[0]
    for x in losses[1:]:
        total = total + x
    return total


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._ts_cache = {}
        self._pending_ts_opt = None

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "prepare(amp_configs=...) is accepted and ignored by the "
                "reference; paddle_tpu_torch refuses it (ROADMAP caveat "
                "17): use amp.decorate and amp.auto_cast")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        self._ts_cache = {}
        return self

    # -- the train step (TrainStep-backed) ---------------------------------
    def _hapi_loss(self, n_in):
        def hapi_loss(net, *batch):
            ins, labs = batch[:n_in], list(batch[n_in:])
            outs = _to_list(net(*ins))
            losses = []
            if self._loss is not None:
                # a labels-free loss gets self._loss(*outs)
                losses = _to_list(self._loss(*(outs + labs)))
            if losses:
                total = losses[0] if len(losses) == 1 else _add_n(losses)
            else:
                total = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
            return total, (outs, losses)
        return hapi_loss

    def _get_step(self, n_in, n_lab, need_opt=True):
        key = (n_in, n_lab, bool(need_opt))
        ts = self._ts_cache.get(key)
        if ts is None:
            from ..parallel.api import TrainStep
            # the numerics mode is stamped by NumericsCallback.set_model
            # before fit() builds the first step
            ts = TrainStep(self.network, self._hapi_loss(n_in),
                           self._optimizer if need_opt else None,
                           device=self.device, has_aux=True,
                           auto_lr_step=False,
                           numerics=(getattr(self, "_numerics_mode", None)
                                     if need_opt else None),
                           skip_nonfinite=getattr(self, "_numerics_skip",
                                                  False))
            if need_opt and self._pending_ts_opt is not None:
                # a checkpoint loaded before the step existed
                ts.set_opt_state_dict(self._pending_ts_opt)
                self._pending_ts_opt = None
            self._ts_cache[key] = ts
        return ts

    def _train_ts(self):
        """The train step whose optimizer state is authoritative (the one
        built with the optimizer), if one exists."""
        for (n_in, n_lab, opt), ts in self._ts_cache.items():
            if opt:
                return ts
        return None

    def _tensors(self, xs):
        return [x.to(self.device) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x), device=self.device)
                for x in _to_list(xs)]

    def _metric_values(self, outs, labels):
        metrics = []
        for m in self._metrics:
            m_in = m.compute(outs[0], labels[0]) if labels else outs[0]
            metrics.append(m.update(m_in))
        return metrics

    def train_batch(self, inputs, labels=None, update=True):
        """One train step: the train step's full update, or with
        ``update=False`` an eager forward and backward accumulating into
        ``.grad`` (applied by the next update)."""
        self.network.train()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        params = list(self.network.parameters())
        has_accum = any(p.grad is not None for p in params)
        if (update and not has_accum and self._optimizer is not None
                and self._loss is not None):
            ts = self._get_step(len(inputs), len(labels))
            _, (outs, loss_list) = ts(*(inputs + labels))
        else:
            outs = _to_list(self.network(*inputs))
            loss_list = _to_list(self._loss(*(outs + labels)))
            total = loss_list[0] if len(loss_list) == 1 else \
                _add_n(loss_list)
            total.backward()
            if update:
                ts = self._train_ts()
                if ts is not None:
                    # one optimizer state: the train step's
                    ts.apply_grads([p.grad for p in ts._params])
                else:
                    self._optimizer.step()
                for p in params:
                    p.grad = None
            outs = [o.detach() for o in outs]
            loss_list = [l.detach() for l in loss_list]
        metrics = self._metric_values(outs, labels)
        losses = [float(_host(l)) for l in loss_list]
        return (losses, metrics) if metrics else losses

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        # share the train step when one exists for this signature (same
        # loss function); otherwise an optimizer-free one
        need_opt = (len(inputs), len(labels), True) in self._ts_cache
        ts = self._get_step(len(inputs), len(labels), need_opt=need_opt)
        _, (outs, loss_list) = ts.eval_step(*(inputs + labels))
        metrics = self._metric_values(outs, labels)
        losses = [float(_host(l)) for l in loss_list]
        return (losses, metrics) if metrics else losses

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._tensors(inputs)
        ts = self._get_step(len(inputs), 0, need_opt=False)
        return [_host(o) for o in _to_list(ts.predict_step(*inputs))]

    # -- loops ----------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        raise TypeError(f"unsupported data {type(data)}")

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = self._make_loader(train_data, batch_size, shuffle)
        cbs = _to_list(callbacks) or [ProgBarLogger(log_freq, verbose)]
        for cb in cbs:
            cb.set_model(self)
        for cb in cbs:
            cb.on_train_begin()
        it_count = 0
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(loader):
                inputs, labels = self._split_batch(batch)
                for cb in cbs:
                    cb.on_train_batch_begin(step)
                res = self.train_batch(inputs, labels)
                losses = res[0] if isinstance(res, tuple) else res
                logs = {"loss": losses}
                bsz = self._batch_len(inputs)
                if bsz is not None:
                    logs["batch_size"] = bsz
                for m in self._metrics:
                    names = m.name() if isinstance(m.name(), list) else \
                        [m.name()]
                    vals = m.accumulate()
                    vals = vals if isinstance(vals, list) else [vals]
                    logs.update(dict(zip(names, vals)))
                for cb in cbs:
                    cb.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if eval_data is not None and epoch % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size,
                                          verbose=verbose,
                                          num_workers=num_workers)
                for cb in cbs:
                    cb.on_eval_end(eval_logs)
            if self.stop_training:
                break
        for cb in cbs:
            cb.on_train_end()

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return batch[0], batch[1]
        return batch, None

    @staticmethod
    def _batch_len(inputs):
        """Leading dim of the first input (examples a step), or None."""
        xs = _to_list(inputs)
        shape = getattr(xs[0], "shape", None) if xs else None
        if shape is not None and len(shape) >= 1:
            return int(shape[0])
        return None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None,
                 num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False)
        cbs = _to_list(callbacks)
        for cb in cbs:
            cb.set_model(self)
        for cb in cbs:
            cb.on_eval_begin()
        for m in self._metrics:
            m.reset()
        losses_all = []
        for step, batch in enumerate(loader):
            if num_iters is not None and step >= num_iters:
                break
            inputs, labels = self._split_batch(batch)
            for cb in cbs:
                cb.on_eval_batch_begin(step)
            res = self.eval_batch(inputs, labels)
            losses = res[0] if isinstance(res, tuple) else res
            if losses:
                losses_all.append(losses[0] if isinstance(losses, list)
                                  else losses)
            for cb in cbs:
                cb.on_eval_batch_end(step)
        logs = {"loss": float(np.mean(losses_all)) if losses_all else None}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            logs.update(dict(zip(names, vals)))
        for cb in cbs:
            cb.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch)
            outputs.append(self.predict_batch(inputs))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- checkpoints --------------------------------------------------------
    def save(self, path, training=True):
        torch.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            ts = self._train_ts()
            if ts is not None:
                torch.save({"__trainstep_opt__": ts.opt_state_dict()},
                           path + ".pdopt")
            else:
                torch.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = torch.load(path + ".pdparams", map_location=self.device)
        self.network.load_state_dict(state)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            opt_state = torch.load(path + ".pdopt", weights_only=False)
            if isinstance(opt_state, dict) and \
                    "__trainstep_opt__" in opt_state:
                ts = self._train_ts()
                if ts is not None:
                    ts.set_opt_state_dict(opt_state["__trainstep_opt__"])
                else:  # held until the train step is built
                    self._pending_ts_opt = opt_state["__trainstep_opt__"]
            else:
                self._optimizer.set_state_dict(opt_state)

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        info = {"total_params": n_params, "trainable_params": n_params}
        print(f"Total params: {n_params}")
        return info
