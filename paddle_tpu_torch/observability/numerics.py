"""Training numerics — port of ``paddle_tpu/observability/numerics.py``.

The reference framework's ``FLAGS_check_nan_inf`` walks every op output
on the host, a sync a step. The reference replaces it with a
TensorHealth pass computed inside its compiled step (one fused
reduction a tensor, the stats returned as a small pytree beside the
loss, no host sync until someone reads). The port computes the same
pass in one launch of a hand kernel over the whole tensor list
(``kernels/tensor_health.py``), on the device, with no host sync until
:meth:`TensorHealth.from_device`:

- :func:`tensor_stats` / :func:`stats_tree` — NaN count, Inf count,
  abs-max, sum of squares and exact-zero fraction (the bf16
  underflow-to-zero signal), one tensor / stacked ``[n]`` over a list.
- :class:`TensorHealth` — the host view of one step's stats:
  per-tensor lookup, ``first_nonfinite()`` provenance (layer + kind),
  worst-offender ranking, strict-JSON ``to_dict()``.
- :class:`AnomalyWatchdog` (built by :func:`watch`) — EMA loss-spike /
  nonfinite / loss-scale-collapse detection with a
  ``halt | skip_step | continue`` policy. On the first anomaly it writes
  a **postmortem bundle**: flight-recorder dumps of every registered
  tracer, the step's full stats, and ``np.save`` of the worst tensors.

The producer is ``parallel/api.py`` (``TrainStep(numerics=...)``;
``skip_nonfinite=`` masks the parameter and optimizer-state update with
``torch.where(found_inf, old, new)``). The bundle format
(``NUMERICS_BUNDLE_FORMAT``) is the reference's, so the reference's
``tools/numerics_check.py`` validates the port's bundles.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..kernels.tensor_health import (STAT_NAMES, tensor_health,
                                     tensor_stats_ref)

__all__ = [
    "STAT_NAMES", "NUMERICS_BUNDLE_FORMAT", "NumericsAnomalyError",
    "tensor_stats", "stats_tree", "TensorHealth", "WatchPolicy",
    "AnomalyWatchdog", "watch",
]

NUMERICS_BUNDLE_FORMAT = "paddle_tpu-numerics-postmortem-v1"


class NumericsAnomalyError(RuntimeError):
    """Raised by the ``halt`` policy after the postmortem bundle is on
    disk — the run stops, but the evidence survives."""

    def __init__(self, msg, bundle=None):
        super().__init__(msg)
        self.bundle = bundle  # path of the bundle dir, or None


# -- device stats -------------------------------------------------------------

def tensor_stats(arr):
    """One tensor's health stats as a dict of 0-d tensors on its device
    (the plain version: a handful of reductions). ``absmax`` is NaN when
    the tensor holds a NaN — itself a signal; ``zero_frac`` is the
    exact-zero fraction, the bf16 underflow-to-zero symptom."""
    return tensor_stats_ref(arr)


def stats_tree(arrays, sq_sums=None):
    """Stats for a list of tensors, stacked: ``{stat: [n]}`` — five
    small device tensors however many tensors, from one launch of the
    ``tensor_health`` kernel on CUDA (the plain version on the CPU).
    ``sq_sums`` (per-tensor sums of squares already computed, by the
    global-norm clip) replace the pass's own, so turning numerics on
    cannot change what the clip computes."""
    out = tensor_health(list(arrays))
    if sq_sums is not None:
        out["sq_sum"] = torch.stack(list(sq_sums))
    return out


def _host(v):
    """A device tensor (or anything numpy takes) as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy() if v.is_floating_point() \
            else v.detach().cpu().numpy()
    return np.asarray(v)


# -- host view ----------------------------------------------------------------

def _f(v):
    """float that survives strict JSON (NaN/Inf -> exposition strings,
    the same convention as registry.snapshot / StepLogger)."""
    from .registry import _json_num
    return _json_num(float(v))


class TensorHealth:
    """Host-side view of one step's numerics stats.

    ``names`` is the tensor-name list (parameter order, the reference's
    names); ``stats`` maps kind (``grad``/``param``/``update``) to
    ``{stat: np.ndarray[n]}``. ``loss``, ``grad_norm`` and ``found_inf``
    are step-level scalars. Construction from the device stats
    (:meth:`from_device`) is the one host sync of the whole pass."""

    __slots__ = ("names", "stats", "loss", "grad_norm", "found_inf",
                 "step", "grad_arrays")

    #: provenance priority: a corrupt parameter explains bad grads, a
    #: bad grad explains a bad update — report the most causal kind
    KIND_ORDER = ("param", "grad", "update")

    def __init__(self, names, stats, loss=None, grad_norm=None,
                 found_inf=False, step=None, grad_arrays=None):
        self.names = list(names)
        self.stats = stats
        self.loss = loss
        self.grad_norm = grad_norm
        self.found_inf = bool(found_inf)
        self.step = step
        self.grad_arrays = grad_arrays  # device tensors (watch mode)

    @classmethod
    def from_device(cls, names, tree, step=None):
        """Materialize the device stats (5 small tensors a kind + 3
        scalars): the one host sync of the pass. ``tree`` is what
        TrainStep hands back in ``last_numerics``."""
        stats = {}
        for kind, st in tree.items():
            if kind in ("loss", "grad_norm", "found_inf",
                        "grad_arrays"):
                continue
            stats[kind] = {s: _host(a) for s, a in st.items()}
        loss = tree.get("loss")
        gn = tree.get("grad_norm")
        fi = tree.get("found_inf")
        return cls(
            names, stats,
            loss=None if loss is None else float(_host(loss)),
            grad_norm=None if gn is None else float(_host(gn)),
            found_inf=False if fi is None else bool(_host(fi)),
            step=step, grad_arrays=tree.get("grad_arrays"))

    def kinds(self):
        return tuple(self.stats)

    def nonfinite(self):
        """Every (kind, name, nan_count, inf_count) with a nonzero
        count, kinds in causal order, tensors in parameter order."""
        out = []
        for kind in self.KIND_ORDER:
            st = self.stats.get(kind)
            if st is None:
                continue
            nan, inf = st["nan"], st["inf"]
            for i, name in enumerate(self.names):
                n, f = int(nan[i]), int(inf[i])
                if n or f:
                    out.append((kind, name, n, f))
        return out

    def first_nonfinite(self):
        """(name, kind) of the most causal nonfinite tensor, or None.
        ``param`` beats ``grad`` beats ``update`` (KIND_ORDER): a
        corrupt weight explains every NaN downstream of it."""
        bad = self.nonfinite()
        if not bad:
            return None
        kind, name, _, _ = bad[0]
        return name, kind

    def per_tensor(self, kind="grad"):
        """{name: {nan, inf, absmax, l2, zero_frac}} for one kind."""
        st = self.stats[kind]
        out = {}
        for i, name in enumerate(self.names):
            out[name] = {
                "nan": int(st["nan"][i]), "inf": int(st["inf"][i]),
                "absmax": float(st["absmax"][i]),
                "l2": float(np.sqrt(st["sq_sum"][i])),
                "zero_frac": float(st["zero_frac"][i])}
        return out

    def worst(self, k=4):
        """The k worst (kind, name, index) offenders: nonfinite tensors
        first (most nonfinite values wins), then largest abs-max.
        Drives which tensors a postmortem saves to disk."""
        scored = []
        for kind, st in self.stats.items():
            nan, inf, am = st["nan"], st["inf"], st["absmax"]
            for i, name in enumerate(self.names):
                bad = int(nan[i]) + int(inf[i])
                mag = float(am[i])
                if np.isnan(mag):
                    mag = float("inf")
                scored.append((bad, mag, kind, name, i))
        scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
        return [(kind, name, i) for _, _, kind, name, i in scored[:k]]

    def to_dict(self):
        """Strict-JSON-safe dict (NaN/Inf floats become their
        exposition strings) — the ``health`` section of a bundle."""
        stats = {}
        for kind, st in self.stats.items():
            stats[kind] = {
                s: [(_f(v) if s in ("absmax", "sq_sum", "zero_frac")
                     else int(v)) for v in a]
                for s, a in st.items()}
        first = self.first_nonfinite()
        return {
            "names": list(self.names), "stats": stats,
            "loss": None if self.loss is None else _f(self.loss),
            "grad_norm": (None if self.grad_norm is None
                          else _f(self.grad_norm)),
            "found_inf": self.found_inf, "step": self.step,
            "first_nonfinite": (None if first is None else
                                {"tensor": first[0], "kind": first[1]}),
            "nonfinite": [
                {"kind": k, "tensor": n, "nan": a, "inf": b}
                for k, n, a, b in self.nonfinite()],
        }


# -- anomaly watchdog ---------------------------------------------------------

_ACTIONS = ("halt", "skip_step", "continue")


class WatchPolicy:
    """Knobs for the watchdog.

    - ``action`` — what a *nonfinite* anomaly does: ``halt`` raises
      :class:`NumericsAnomalyError` after the bundle is written,
      ``skip_step`` relies on the TrainStep's found-inf masking (the
      update never happened — params stay bit-identical, exactly a
      GradScaler found-inf step) and keeps training,
      ``continue`` records and moves on. Loss spikes and scale
      collapse always record-and-continue unless ``action='halt'``.
    - ``spike_k`` — loss > ``spike_k`` x EMA(loss) is an anomaly
      (after ``warmup_steps``; None disables).
    - ``ema_alpha`` — EMA smoothing for the spike baseline.
    - ``scale_floor`` — a GradScaler scale at/below this (having been
      above it) is a loss-scale collapse.
    - ``dump_dir`` / ``max_dumps`` / ``save_tensors`` — where bundles
      land, how many to write per run, how many worst tensors to
      ``np.save`` into each.
    """

    def __init__(self, action="halt", spike_k=8.0, ema_alpha=0.1,
                 warmup_steps=5, scale_floor=4.0,
                 dump_dir="numerics_postmortems", max_dumps=1,
                 save_tensors=4):
        if action not in _ACTIONS:
            raise ValueError(
                f"action must be one of {_ACTIONS}, got {action!r}")
        self.action = action
        self.spike_k = None if spike_k is None else float(spike_k)
        self.ema_alpha = float(ema_alpha)
        self.warmup_steps = int(warmup_steps)
        self.scale_floor = float(scale_floor)
        self.dump_dir = str(dump_dir)
        self.max_dumps = int(max_dumps)
        self.save_tensors = int(save_tensors)

    def to_dict(self):
        return {"action": self.action, "spike_k": self.spike_k,
                "ema_alpha": self.ema_alpha,
                "warmup_steps": self.warmup_steps,
                "scale_floor": self.scale_floor,
                "dump_dir": self.dump_dir, "max_dumps": self.max_dumps,
                "save_tensors": self.save_tensors}


class AnomalyWatchdog:
    """Inspects each step's :class:`TensorHealth` and fires a
    postmortem bundle on the first anomaly.

    >>> dog = watch(WatchPolicy(action="skip_step", dump_dir=tmp))
    >>> act = dog.check(health, step=i, scaler=scaler)
    >>> if act == "halt": ...   # bundle already on disk

    ``check`` returns the action taken: ``"ok"`` or one of the policy
    actions. ``params_provider`` (optional) returns ``[(name, array)]``
    so param-kind offenders can be saved even when the health stats
    carry no raw tensors."""

    def __init__(self, policy=None, params_provider=None):
        import collections
        self.policy = policy if policy is not None else WatchPolicy()
        self.params_provider = params_provider
        self.ema_loss = None
        self._steps_seen = 0
        self._scale_peak = None
        self._collapsed = False  # edge-trigger for scale collapse
        self.dumps = []          # bundle dirs written
        # bounded: a persistent anomaly under action="continue" must
        # not grow host memory for the rest of a million-step run
        self.anomalies = collections.deque(maxlen=256)
        self.anomalies_total = 0
        self.last_bundle = None

    # -- detection -----------------------------------------------------------
    def check(self, health, step=None, scaler=None):
        """One step's verdict. Updates the EMA with *finite* losses
        only (a spiked loss must not drag the baseline up and mask the
        next spike)."""
        self._steps_seen += 1
        reason = None
        if health.found_inf or health.nonfinite() or (
                health.loss is not None and not np.isfinite(health.loss)):
            reason = "nonfinite"
        loss = health.loss
        if reason is None and loss is not None and np.isfinite(loss):
            p = self.policy
            if (p.spike_k is not None and self.ema_loss is not None
                    and self._steps_seen > p.warmup_steps
                    and loss > p.spike_k * max(self.ema_loss, 1e-12)):
                reason = "loss_spike"
        if reason is None and scaler is not None:
            scale = float(getattr(scaler, "_scale", 0.0))
            peak = self._scale_peak = max(self._scale_peak or scale,
                                          scale)
            below = (peak > self.policy.scale_floor
                     and scale <= self.policy.scale_floor)
            if below and not self._collapsed:
                # edge-triggered: one anomaly per collapse, not one
                # per step the scale stays on the floor
                reason = "loss_scale_collapse"
            self._collapsed = below
        if reason != "loss_spike" and loss is not None \
                and np.isfinite(loss):
            # only a SPIKED loss is kept out of the baseline (it must
            # not drag the EMA up and mask the next spike); a finite
            # loss during any other anomaly still tracks
            a = self.policy.ema_alpha
            self.ema_loss = loss if self.ema_loss is None else \
                (1 - a) * self.ema_loss + a * loss
        if reason is None:
            return "ok"
        self.anomalies.append((reason, step))
        self.anomalies_total += 1
        bundle = None
        if len(self.dumps) < self.policy.max_dumps:
            bundle = self.fire(health, reason, step=step, scaler=scaler)
        action = self.policy.action
        if action == "skip_step" and reason != "nonfinite":
            # nothing to skip — the spike/collapse already happened
            action = "continue"
        if action == "halt":
            raise NumericsAnomalyError(
                f"numerics anomaly at step {step}: {reason}"
                + (f" (bundle: {bundle})" if bundle else ""),
                bundle=bundle)
        return action

    # -- postmortem ----------------------------------------------------------
    def fire(self, health, reason, step=None, scaler=None):
        """Write one postmortem bundle dir and return its path:
        ``bundle.json`` (schema ``NUMERICS_BUNDLE_FORMAT``, validated
        by ``tools/numerics_check.py``), ``<n>_<kind>_<tensor>.npy`` worst
        offenders, plus a flight-recorder dump of every tracer
        registered through ``tracing.register_postmortem``. Never
        raises — a postmortem must not take down the training loop it
        documents."""
        try:
            return self._fire(health, reason, step, scaler)
        except Exception:
            return None

    def _fire(self, health, reason, step, scaler):
        from .tracing import dump_all_postmortems
        tag = f"step{step if step is not None else self._steps_seen}"
        d = os.path.join(self.policy.dump_dir, f"{tag}_{reason}")
        os.makedirs(d, exist_ok=True)
        flight = dump_all_postmortems(reason=f"numerics:{reason}")

        dumps = []
        params = None
        candidates = health.worst(self.policy.save_tensors)
        first = health.first_nonfinite()
        if first is not None:
            # the causal tensor is always a candidate, even when whole
            # NaN'd grad tensors out-rank it in the worst() ordering
            name, kind = first
            cand = (kind, name, health.names.index(name))
            if cand not in candidates:
                candidates.insert(0, cand)
        seen = set()
        for kind, name, idx in candidates:
            if (kind, name) in seen:
                continue
            seen.add((kind, name))
            arr = None
            if kind == "grad" and health.grad_arrays is not None:
                arr = health.grad_arrays[idx]
            elif kind == "param":
                if params is None and self.params_provider is not None:
                    params = dict(self.params_provider())
                arr = None if params is None else params.get(name)
            if arr is None:
                continue
            fname = f"{idx}_{kind}_{name.replace('.', '_')}.npy"
            np.save(os.path.join(d, fname),
                    _host(arr).astype(np.float32))
            dumps.append({"tensor": name, "kind": kind, "file": fname})

        doc = {
            "format": NUMERICS_BUNDLE_FORMAT,
            "reason": reason, "step": step, "ts": time.time(),
            "ema_loss": (None if self.ema_loss is None
                         else _f(self.ema_loss)),
            "policy": self.policy.to_dict(),
            "scaler": scaler.state_dict() if scaler is not None else None,
            "health": health.to_dict(),
            "tensor_dumps": dumps,
            "flight_dumps": list(flight),
        }
        path = os.path.join(d, "bundle.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        self.dumps.append(d)
        self.last_bundle = d
        return d


def watch(policy=None, **kw):
    """Build an :class:`AnomalyWatchdog`. ``policy`` may be a
    :class:`WatchPolicy` or None; keyword arguments build one
    (``watch(action="skip_step", dump_dir=...)``)."""
    if policy is None:
        policy = WatchPolicy(**kw)
    elif kw:
        raise ValueError("pass a WatchPolicy or keywords, not both")
    return AnomalyWatchdog(policy=policy)
