"""hapi callbacks — port of ``paddle_tpu/hapi/callbacks.py`` (``:26-612``):
``VisualDL`` (the ``visualdl`` writer where the package is installed,
else its JSONL record form, ``vdlrecords.jsonl``), ``ReduceLROnPlateau``,
``TelemetryCallback`` (the train-loop series on the port's metrics
registry, the fit trace on its tracer) and ``NumericsCallback`` (the
``TrainStep`` TensorHealth pass published per batch, driving a
``GradScaler`` given as ``scaler=``), over ``paddle_tpu_torch.observability``.
The core callbacks live in ``hapi/model.py`` next to the fit loop.

Differences from the reference, each because the port has no trace:
``train_jit_compiles{model,fn}`` and ``train_jit_compile_events_total``
are registered (their families exist, as the reference's exporters
expect) but take no series, since the port's train step compiles
nothing; ``device_memory_bytes{device,stat}`` reads
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` and the
card's total memory for a network on CUDA (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``), and nothing on the CPU.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .model import (  # noqa: F401
    Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping, LRScheduler,
)

__all__ = [
    "Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
    "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
    "TelemetryCallback", "NumericsCallback",
]


class VisualDL(Callback):
    """hapi/callbacks.py VisualDL — scalar logging per train/eval step.

    Uses the `visualdl` LogWriter when the package is installed; otherwise
    falls back to an append-only JSONL scalar log (`vdlrecords.jsonl` in
    `log_dir`) with the same (tag, step, value) records, so training
    telemetry survives in environments without the visualdl wheel."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.epoch = 0
        self._writer = None
        self._fh = None
        self._step = 0

    def _ensure_writer(self):
        if self._writer is not None or self._fh is not None:
            return
        try:
            from visualdl import LogWriter
            self._writer = LogWriter(self.log_dir)
        except ImportError:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir,
                                         "vdlrecords.jsonl"), "a")

    def _add_scalar(self, tag, value, step):
        self._ensure_writer()
        if self._writer is not None:
            self._writer.add_scalar(tag=tag, value=value, step=step)
        else:
            self._fh.write(json.dumps(
                {"tag": tag, "step": int(step),
                 "value": float(value), "ts": time.time()}) + "\n")
            self._fh.flush()

    def _updates(self, logs, mode, step):
        for k in sorted(logs):
            if k in ("batch_size", "step", "steps"):
                continue
            v = _scalar(logs.get(k))
            if v is None:
                continue
            self._add_scalar(f"{mode}/{k}", v, step)

    def on_train_begin(self, logs=None):
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._updates(logs or {}, "train", self._step)

    def on_eval_end(self, logs=None):
        self._updates(logs or {}, "eval", self._step)

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ReduceLROnPlateau(Callback):
    """hapi/callbacks.py ReduceLROnPlateau — shrink the optimizer LR by
    `factor` after `patience` evaluations without improvement on
    `monitor`."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        self.mode = mode
        self.cooldown_counter = 0
        self.best = None
        self.wait = 0

    def _is_better(self, cur):
        if self.best is None:
            return True
        mode = self.mode
        if mode == "auto":
            mode = "max" if "acc" in self.monitor else "min"
        if mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            import warnings
            warnings.warn(
                f"ReduceLROnPlateau: monitor '{self.monitor}' missing "
                f"from eval logs {sorted(logs)}", stacklevel=2)
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        # Keras/reference semantics: cooldown state is re-checked AFTER
        # the decrement, so the final cooldown eval already counts
        # toward patience
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._is_better(cur):
            self.best = cur
            self.wait = 0
            return
        if self.cooldown_counter > 0:
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = self.model._optimizer
            if opt is None:
                return
            old = float(opt.get_lr())
            new = max(old * self.factor, self.min_lr)
            if old - new > 1e-12:
                opt.set_lr(new)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr {old:.3e} -> {new:.3e}")
            self.cooldown_counter = self.cooldown
            self.wait = 0


class TelemetryCallback(Callback):
    """Publish the fit/eval loop into a metrics registry (the trainer
    series, the counterpart of the serving engine's ``serving_*``).

    Per train step: ``train_step_seconds`` histogram,
    ``train_steps_total`` / ``train_examples_total`` counters,
    ``train_examples_per_sec`` and ``train_loss`` gauges. The compile
    probe (``train_jit_compiles{fn=...}``, growth into
    ``train_jit_compile_events_total``) reads a train step's compiled
    executables; the port's are eager, so it publishes no series. Eval
    results land in ``eval_result{name=...}``. For a model on CUDA,
    ``device_memory_bytes{device=,stat=}`` gauges are refreshed every
    ``memory_every`` steps. ``step_log`` (path or StepLogger) appends a
    JSONL record per step.

    Tracing: each ``fit()`` becomes one trace (``m<model>:fit<n>``) on
    the process tracer (override with ``tracer=``, disable with
    ``tracing=False``) with a ``train_step`` span per batch and ``eval``
    spans — the trainer lane of the merged chrome timeline
    (``observability.export_merged_chrome_trace``)."""

    _model_ids = iter(range(1 << 62))  # "model" label for gauge series

    def __init__(self, registry=None, step_log=None, device_memory=True,
                 memory_every=10, tracer=None, tracing=True):
        from ..observability import StepLogger, get_registry
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        # one trace per fit() lifecycle with a train_step span per
        # batch (and eval spans),
        # so the trainer shows up as its own lane in the merged
        # chrome timeline next to serving requests and compile events
        self._tracer = None
        if tracing:
            from ..observability import tracing as _tracing
            self._tracer = tracer if tracer is not None else \
                _tracing.get_tracer()
        self._fit_trace = None
        self._fit_no = 0
        self._span_step = None
        # counters/histograms aggregate across models on a shared
        # registry; point-in-time gauges carry a "model" label so two
        # TelemetryCallbacks don't clobber each other (mirrors the
        # serving side's engine label). Families are held and labeled
        # series re-resolved per update — reset()-safe.
        self.model_id = str(next(TelemetryCallback._model_ids))
        self._m_step_s = reg.histogram(
            "train_step_seconds", "wall time of one train step")
        self._m_steps = reg.counter("train_steps_total", "train steps run")
        self._m_examples = reg.counter(
            "train_examples_total", "training examples consumed")
        self._g_eps = reg.gauge(
            "train_examples_per_sec", "examples/sec of the last step",
            labels=("model",))
        self._g_loss = reg.gauge(
            "train_loss", "loss of the last step", labels=("model",))
        self._g_compiles = reg.gauge(
            "train_jit_compiles",
            "compiled executables per TrainStep signature",
            labels=("model", "fn"))
        self._m_compile_events = reg.counter(
            "train_jit_compile_events_total",
            "observed growth of any TrainStep's executable cache")
        self._g_eval = reg.gauge(
            "eval_result", "latest evaluate() results",
            labels=("model", "name"))
        self._g_mem = reg.gauge(
            "device_memory_bytes", "CUDA allocator and card memory",
            labels=("device", "stat"))
        self._device_memory = device_memory
        self._memory_every = max(int(memory_every), 1)
        self._logger, self._owns_logger = StepLogger.coerce(step_log)
        self._step_log_path = step_log if self._owns_logger else None
        self._closed = False
        self._last_compiles = {}
        self._t0 = None
        self._step_no = 0

    # -- probes --------------------------------------------------------------
    def _publish_compiles(self):
        from ..observability.compile_tracker import (cache_size,
                                                     record_compile_event)
        for key, ts in list(getattr(self.model, "_ts_cache", {}).items()):
            n = cache_size(getattr(ts, "_compiled", None))
            if n is None:
                continue
            n_in, n_lab, opt = key
            name = (f"train_step(in={n_in},lab={n_lab}"
                    f"{',opt' if opt else ''})")
            self._g_compiles.labels(model=self.model_id, fn=name).set(n)
            prev = self._last_compiles.get(name, 0)
            if n > prev:
                self._m_compile_events.inc(n - prev)
                # land on the merged timeline's compile lane too
                record_compile_event(name, count=n, source="probe",
                                     model=self.model_id)
            self._last_compiles[name] = n

    def _publish_memory(self):
        if not self._device_memory:
            return
        dev = getattr(getattr(self, "model", None), "device", None)
        if dev is None or dev.type != "cuda":
            return
        try:
            idx = dev.index if dev.index is not None else \
                torch.cuda.current_device()
            stats = {
                "bytes_in_use": torch.cuda.memory_allocated(idx),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(idx),
                "bytes_limit": torch.cuda.get_device_properties(
                    idx).total_memory}
        except Exception:
            return
        for k, v in stats.items():
            self._g_mem.labels(device=str(idx), stat=k).set(v)

    # -- callback hooks ------------------------------------------------------
    def _ensure_logger(self):
        """Reopen (append) an owned logger a prior fit()'s
        on_train_end closed, so resumed fits and post-fit evaluate()
        calls keep logging instead of silently dropping records."""
        if self._owns_logger and self._logger.closed:
            from ..observability import StepLogger
            self._logger = StepLogger(self._step_log_path)
        return self._logger

    def _end_fit_trace(self, status="ok"):
        if self._tracer is not None and self._fit_trace is not None:
            try:
                if self._span_step is not None:
                    self._span_step.end()
                self._tracer.end_trace(self._fit_trace.trace_id,
                                       status=status,
                                       steps=self._step_no)
            except Exception:
                pass
        self._fit_trace = None
        self._span_step = None

    def on_train_begin(self, logs=None):
        if self._closed:  # a retired callback must not reopen its
            return        # logger (on_train_end would never close it)
        # end a leftover trace BEFORE the step counter resets, so an
        # interrupted fit's postmortem keeps its real step count
        self._end_fit_trace("abandoned")
        self._step_no = 0
        self._ensure_logger()
        if self._tracer is not None:
            try:
                self._fit_no += 1
                self._fit_trace = self._tracer.start_trace(
                    "fit",
                    trace_id=f"m{self.model_id}:fit{self._fit_no}",
                    model=self.model_id)
            except Exception:
                self._fit_trace = None
        self._publish_memory()

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()
        if self._tracer is not None and self._fit_trace is not None \
                and not self._closed:
            try:
                self._span_step = self._tracer.start_span(
                    "train_step", trace_id=self._fit_trace.trace_id,
                    step=self._step_no + 1)
            except Exception:
                self._span_step = None

    def on_train_batch_end(self, step, logs=None):
        if self._closed:  # never resurrect series close() retired
            return
        logs = logs or {}
        dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
        self._t0 = None
        self._step_no += 1
        self._m_step_s.observe(dt)
        self._m_steps.inc()
        loss = _scalar(logs.get("loss"))
        if loss is not None:
            self._g_loss.labels(model=self.model_id).set(loss)
        eps = None
        bsz = logs.get("batch_size")
        if bsz:
            self._m_examples.inc(bsz)
            if dt > 0:
                eps = bsz / dt
                self._g_eps.labels(model=self.model_id).set(eps)
        self._publish_compiles()
        if self._step_no % self._memory_every == 0:
            self._publish_memory()
        if self._span_step is not None:
            self._span_step.end(loss=loss, batch_size=bsz,
                                examples_per_sec=eps)
            self._span_step = None
        if self._logger is not None:
            self._logger.log("train_step", step=self._step_no,
                             dt_s=round(dt, 6), loss=loss,
                             batch_size=bsz, examples_per_sec=eps)

    def on_eval_end(self, logs=None):
        if self._closed:
            return
        if self._tracer is not None and self._fit_trace is not None:
            try:
                self._tracer.start_span(
                    "eval", trace_id=self._fit_trace.trace_id,
                    **{k: _f(v) for k, v in (logs or {}).items()
                       if k not in ("batch_size", "steps")}).end()
            except Exception:
                pass
        for k, v in (logs or {}).items():
            if v is None or k in ("batch_size", "step", "steps"):
                continue
            s = _scalar(v)
            if s is not None:
                self._g_eval.labels(model=self.model_id, name=k).set(s)
        if self._logger is not None:
            self._ensure_logger().log("eval", **{
                k: _f(v) for k, v in (logs or {}).items()})

    def on_train_end(self, logs=None):
        if self._closed:  # same no-resurrection rule as the other hooks
            return
        self._publish_compiles()
        self._publish_memory()
        self._end_fit_trace("ok")
        if self._owns_logger and self._logger is not None:
            self._logger.close()

    def close(self):
        """Retire this callback's model-labeled gauge series and close
        an owned StepLogger — a sweep rebuilding Model+callback pairs on
        the shared registry must not accumulate dead series (the
        trainer-side analogue of ServingEngine.close()). Shared
        counters/histograms keep their totals; device_memory_bytes is
        process-wide and stays."""
        self._closed = True
        self._end_fit_trace("abandoned")
        if self._owns_logger and self._logger is not None:
            self._logger.close()
        for fam in (self._g_loss, self._g_eps, self._g_compiles,
                    self._g_eval):
            fam.remove_matching(model=self.model_id)


class NumericsCallback(Callback):
    """Train-loop consumer of the TrainStep TensorHealth pass (the
    training-side counterpart of TelemetryCallback).

    Attach it to ``fit(callbacks=[...])`` and the train step computes
    per-tensor NaN/Inf counts, abs-max, L2 and zero-fraction for
    grads/params/updates on the device (one ``tensor_health`` launch a
    kind on CUDA, no host sync until this callback reads). Each batch
    this callback:

    - publishes ``train_grad_norm{model=,layer=}`` (global under
      ``layer="__global__"`` — the SAME norm the in-graph grad clip
      uses) and ``train_nonfinite_total{tensor=,kind=}``;
    - stamps ``grad_norm``/``found_inf``/``loss_scale`` attributes on
      the TelemetryCallback's ``train_step`` span when ``telemetry=``
      is passed;
    - appends a ``numerics`` StepLogger record (``step_log=`` path or
      logger), including the GradScaler's scale when ``scaler=`` is
      given;
    - feeds the :class:`~observability.numerics.AnomalyWatchdog`
      (``mode="watch"``): first nonfinite grad / loss spike (> k·EMA)
      / loss-scale collapse fires a postmortem bundle through the
      ``register_postmortem`` machinery, then applies the policy —
      ``halt`` raises :class:`NumericsAnomalyError`, ``skip_step``
      relies on the step's found-inf masking on the device (params
      stay bit-identical) and keeps training, ``continue`` records only.

    A ``scaler`` handed in is also *driven*: the hapi train step
    never calls ``scaler.unscale_``, so on a found-inf step the
    callback calls ``scaler.notify_found_inf()`` and ``update()`` each
    batch — the dynamic loss scale reacts exactly as on the eager
    path, and ``amp_loss_scale`` / ``amp_found_inf_total`` stay live.

    Must be attached before the first train step is built (it stamps
    the numerics mode the TrainStep is built with); attaching to a
    Model that already trained logs a warning and disables itself."""

    _model_ids = iter(range(1 << 62))

    def __init__(self, registry=None, mode="stats", policy=None,
                 watchdog=None, scaler=None, step_log=None,
                 telemetry=None, layer_gauges=True):
        from ..observability import StepLogger, get_registry
        from ..observability import numerics as _numerics
        if mode not in ("stats", "watch"):
            raise ValueError(f"mode must be 'stats'|'watch', got {mode!r}")
        self.mode = mode
        if policy is not None and watchdog is not None:
            raise ValueError(
                "pass policy= OR a prebuilt watchdog=, not both (the "
                "watchdog already carries its policy)")
        self.watchdog = watchdog
        if mode == "watch" and watchdog is None:
            self.watchdog = _numerics.watch(policy)
        elif policy is not None and watchdog is None:
            raise ValueError("policy= needs mode='watch'")
        self.scaler = scaler
        self.telemetry = telemetry
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self.model_id = str(next(NumericsCallback._model_ids))
        self._layer_gauges = bool(layer_gauges)
        self._g_gnorm = reg.gauge(
            "train_grad_norm",
            "global (layer=__global__) and per-tensor L2 grad norm",
            labels=("model", "layer"))
        self._m_nonfinite = reg.counter(
            "train_nonfinite_total",
            "nonfinite (NaN+Inf) values seen per tensor and kind",
            labels=("tensor", "kind"))
        self._logger, self._owns_logger = StepLogger.coerce(step_log)
        self._disabled = False
        self._warned = False
        self._step_no = 0

    def set_model(self, model):
        super().set_model(model)
        existing = model._train_ts() is not None
        if existing and getattr(model, "_numerics_mode", None) is None:
            import warnings
            warnings.warn(
                "NumericsCallback attached after the train step was "
                "built without numerics; re-prepare() the model to "
                "enable the TensorHealth pass. Disabling.",
                RuntimeWarning, stacklevel=2)
            self._disabled = True
            return
        model._numerics_mode = self.mode
        model._numerics_skip = bool(
            self.watchdog is not None
            and self.watchdog.policy.action == "skip_step")
        if self.watchdog is not None and \
                self.watchdog.params_provider is None:
            net = model.network
            self.watchdog.params_provider = \
                lambda: list(net.named_parameters())

    def on_train_begin(self, logs=None):
        self._step_no = 0

    def _train_step(self):
        ts = self.model._train_ts()
        if ts is not None and getattr(ts, "_numerics", None) is not None:
            return ts
        return None

    def _span(self):
        """The current train_step span (open, or just ended by a
        TelemetryCallback that ran before us — Span.set_attr works
        either way)."""
        tel = self.telemetry
        if tel is None:
            return None
        if tel._span_step is not None:
            return tel._span_step
        tr = tel._fit_trace
        if tr is not None:
            spans = tr.find("train_step")
            if spans:
                return spans[-1]
        return None

    def on_train_batch_end(self, step, logs=None):
        if self._disabled:
            return
        self._step_no += 1
        ts = self._train_step()
        health = ts.numerics_view(step=self._step_no) \
            if ts is not None else None
        if health is None:
            if not self._warned and self._step_no >= 2:
                self._warned = True
                import warnings
                warnings.warn(
                    "NumericsCallback: no TensorHealth stats available "
                    "(eager fallback or grad-merge path?) — numerics "
                    "series will stay empty", RuntimeWarning,
                    stacklevel=2)
            return
        if health.grad_norm is not None:
            self._g_gnorm.labels(model=self.model_id,
                                 layer="__global__").set(health.grad_norm)
        if self._layer_gauges and "grad" in health.stats:
            sq = health.stats["grad"]["sq_sum"]
            for i, name in enumerate(health.names):
                self._g_gnorm.labels(model=self.model_id, layer=name) \
                    .set(float(np.sqrt(sq[i])))
        for kind, name, n_nan, n_inf in health.nonfinite():
            self._m_nonfinite.labels(tensor=name, kind=kind) \
                .inc(n_nan + n_inf)
        scale = None
        if self.scaler is not None:
            # record the scale the step RAN at — update() below may
            # halve it on this very found-inf, and triage needs the
            # pre-event value on the span/record
            scale = self.scaler._scale
            if health.found_inf:
                self.scaler.notify_found_inf()
            self.scaler.update()
        sp = self._span()
        if sp is not None:
            first = health.first_nonfinite()
            sp.set_attr(grad_norm=health.grad_norm,
                        found_inf=health.found_inf,
                        **({"loss_scale": scale} if scale is not None
                           else {}),
                        **({"first_nonfinite": f"{first[0]}:{first[1]}"}
                           if first else {}))
        if self._logger is not None and not self._logger.closed:
            first = health.first_nonfinite()
            self._logger.log(
                "numerics", step=self._step_no, loss=health.loss,
                grad_norm=health.grad_norm, found_inf=health.found_inf,
                loss_scale=scale,
                scale_history=(list(self.scaler._scale_history)[-4:]
                               if self.scaler is not None else None),
                first_nonfinite=(f"{first[0]}:{first[1]}" if first
                                 else None))
        if self.watchdog is not None:
            from ..observability.numerics import NumericsAnomalyError
            try:
                self.watchdog.check(health, step=self._step_no,
                                    scaler=self.scaler)
            except NumericsAnomalyError:
                # graceful for loops that catch-and-resume; the raise
                # still aborts this fit()
                self.model.stop_training = True
                raise

    def on_train_end(self, logs=None):
        if self._owns_logger and self._logger is not None:
            self._logger.close()

    def close(self):
        """Retire this callback's model-labeled gauge series (shared
        counters keep their totals) and close an owned StepLogger."""
        if self._owns_logger and self._logger is not None:
            self._logger.close()
        self._g_gnorm.remove_matching(model=self.model_id)


def _scalar(v):
    """First element of ``v`` as a float (hapi logs carry losses as
    one-element lists), or None when it does not coerce."""
    if v is None:
        return None
    try:
        return float(np.asarray(v).reshape(-1)[0])
    except (TypeError, ValueError, IndexError):
        return None


def _f(v):
    s = _scalar(v)
    return str(v) if s is None else s
