"""Profiler — port of ``paddle_tpu/profiler/__init__.py`` (reference:
paddle/fluid/platform/profiler.h RecordEvent + profiler_helper.h summary
tables + fluid/profiler.py:314).

HOST scopes are :class:`RecordEvent` spans collected here, summarized
in the reference's sorted table format and exportable as
chrome://tracing JSON; each span also opens a
``torch.profiler.record_function`` range (where the reference opens a
``jax.profiler.TraceAnnotation``), so a ``torch.profiler`` trace shows
the serving dispatches next to the kernels they launch. DEVICE time is
a ``torch.profiler`` trace with CUDA activity (``start_trace`` /
``stop_trace``), the reference's ``jax.profiler`` trace."""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch

# name -> [total_s, count, max_s, min_s]
_host_events = defaultdict(lambda: [0.0, 0, 0.0, float("inf")])
_spans = []           # (name, t0_s, t1_s, tid) — for timeline export
_SPAN_CAP = 1_000_000
_spans_dropped = 0
_enabled = False
# the serving scheduler and client threads record concurrently; every
# mutation/read of _host_events/_spans goes through this lock
_lock = threading.Lock()
# optional bridge into the observability registry (set by feed_registry):
# a histogram family labeled by span name that every RecordEvent feeds
_span_histogram = None
# counter incremented when the span buffer overflows (a truncated
# timeline must be detectable). Bound by feed_registry, or
# lazily to the default registry on the first drop.
_drop_counter = None


def feed_registry(registry, name="host_span_seconds", buckets=None):
    """Feed every RecordEvent span into ``registry`` as a labeled
    histogram ``name{name=<event>}`` (seconds), independent of whether
    the summary profiler is enabled — and bind the
    ``host_spans_dropped_total`` overflow counter to the same registry.
    Pass ``registry=None`` to disconnect. Returns the histogram family
    (or None)."""
    global _span_histogram, _drop_counter
    if registry is None:
        _span_histogram = None
        _drop_counter = None
        return None
    _span_histogram = registry.histogram(
        name, "host RecordEvent span duration", labels=("name",),
        buckets=buckets)
    _drop_counter = registry.counter(
        "host_spans_dropped_total",
        "RecordEvent spans dropped after the span buffer filled "
        "(counted in the summary, missing from the timeline)")
    return _span_histogram


def _count_drop():
    """Bump host_spans_dropped_total (default registry unless
    feed_registry bound one) — never raises from the hot path."""
    global _drop_counter
    try:
        c = _drop_counter
        if c is None:
            from ..observability.registry import get_registry
            c = _drop_counter = get_registry().counter(
                "host_spans_dropped_total",
                "RecordEvent spans dropped after the span buffer "
                "filled (counted in the summary, missing from the "
                "timeline)")
        c.inc()
    except Exception:
        pass


class RecordEvent:
    """Host event scope (reference: platform/profiler.h:127).

    ``histogram``: optionally an observability Histogram (family or
    labeled series) that receives this span's duration in seconds —
    live telemetry even when the summary profiler is off."""

    def __init__(self, name, event_type=None, histogram=None):
        self.name = name
        self._histogram = histogram

    def __enter__(self):
        self.begin()
        return self

    def begin(self):
        self._t0 = time.perf_counter()
        # the range only while a torch.profiler session records: opening
        # one costs a dispatcher call a span
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        span_hist = _span_histogram
        if not (_enabled or self._histogram is not None
                or span_hist is not None):
            return
        t1 = time.perf_counter()
        dt = t1 - self._t0
        if self._histogram is not None:
            self._histogram.observe(dt)
        if span_hist is not None:
            span_hist.labels(name=self.name).observe(dt)
        if not _enabled:
            return
        global _spans_dropped
        warn_full = dropped = False
        with _lock:
            ev = _host_events[self.name]
            ev[0] += dt
            ev[1] += 1
            ev[2] = max(ev[2], dt)
            ev[3] = min(ev[3], dt)
            if len(_spans) < _SPAN_CAP:
                _spans.append((self.name, self._t0, t1,
                               threading.get_ident()))
            else:
                warn_full = _spans_dropped == 0
                _spans_dropped += 1
                dropped = True
        if dropped:
            _count_drop()
        if warn_full:
            import warnings
            warnings.warn(
                f"profiler span buffer full ({_SPAN_CAP}); further "
                "spans are counted in the summary but omitted from "
                "the exported timeline", RuntimeWarning)

    def __exit__(self, *exc):
        self.end()
        return False


def summary_table(sorted_key="total") -> str:
    """The reference profiler_helper.h sorted event table: calls, total,
    max/min/avg and the share of wall time per event."""
    with _lock:
        events = {k: list(v) for k, v in _host_events.items()}
    wall = sum(v[0] for v in events.values()) or 1.0
    rows = []
    for name, (total, count, mx, mn) in events.items():
        ave = total / max(count, 1)
        rows.append((name, total, count, mx,
                     0.0 if mn == float("inf") else mn, ave,
                     total / wall))
    idx = {"total": 1, "calls": 2, "max": 3, "min": 4,
           "ave": 5}.get(sorted_key, 1)
    rows.sort(key=lambda r: -r[idx])
    lines = ["------------------------->  Profiling Report  "
             "<-------------------------", "",
             f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Max(ms)':>10}"
             f"{'Min(ms)':>10}{'Ave(ms)':>10}{'Ratio':>8}"]
    for name, total, count, mx, mn, ave, ratio in rows:
        lines.append(
            f"{name[:39]:<40}{count:>8}{total * 1e3:>12.3f}"
            f"{mx * 1e3:>10.3f}{mn * 1e3:>10.3f}{ave * 1e3:>10.3f}"
            f"{ratio:>8.1%}")
    return "\n".join(lines)


def get_spans():
    """``(spans, dropped)``: a snapshot of the recorded host spans
    (``(name, t0_s, t1_s, tid)`` tuples on the perf_counter clock) and
    the overflow count — what the merged timeline exporter
    (``observability.tracing.export_merged_chrome_trace``) reads."""
    with _lock:
        return list(_spans), _spans_dropped


def export_chrome_trace(path: str):
    """Write collected spans as chrome://tracing JSON (what the
    reference's tools/timeline.py produces from its protobuf profile)."""
    with _lock:
        spans = list(_spans)
    events = []
    for name, t0, t1, tid in spans:
        events.append({
            "name": name, "ph": "X", "cat": "host",
            "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
            "pid": os.getpid(), "tid": tid % (1 << 31),
        })
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if _spans_dropped:
        trace["metadata"] = {"dropped_spans": _spans_dropped}
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def start_profiler(state="All", tracer_option="Default"):
    global _enabled, _spans_dropped
    with _lock:
        _host_events.clear()
        _spans.clear()
        _spans_dropped = 0
    _enabled = True


def stop_profiler(sorted_key="total", profile_path=None):
    """Stop + print the summary table; with ``profile_path``, also write
    the span log (chrome-trace JSON — open in chrome://tracing or
    Perfetto, or post-process with tools/timeline.py).

    Returns a summary dict: ``table`` (the printed text), ``spans``
    (recorded span count) and ``spans_dropped`` (buffer overflow —
    nonzero means the exported timeline is truncated)."""
    global _enabled
    _enabled = False
    table = summary_table(sorted_key)
    print(table)
    if profile_path:
        export_chrome_trace(profile_path)
    with _lock:
        summary = {"table": table, "spans": len(_spans),
                   "spans_dropped": _spans_dropped}
    return summary


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


_trace_prof = None


def _default_trace_dir():
    import tempfile
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_trace")


def start_trace(log_dir=None):
    """Device-level trace: a ``torch.profiler`` session with CPU and
    (when a card is present) CUDA activity, the reference's
    ``jax.profiler`` trace. ``stop_trace`` writes it to ``log_dir``."""
    global _trace_prof
    if _trace_prof is not None:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    prof.log_dir = log_dir or _default_trace_dir()
    _trace_prof = prof


def stop_trace():
    """End the device trace and write it as chrome-trace JSON into its
    ``log_dir``; returns the file's path (None without a trace)."""
    global _trace_prof
    prof, _trace_prof = _trace_prof, None
    if prof is None:
        return None
    prof.stop()
    os.makedirs(prof.log_dir, exist_ok=True)
    path = os.path.join(prof.log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir=None):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


class Profiler:
    """paddle.profiler.Profiler-style API over both collectors (host
    RecordEvent spans + the torch.profiler device trace)."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False):
        self.timer_only = timer_only
        self._log_dir = _default_trace_dir()
        self._on_trace_ready = on_trace_ready
        self._step_marker = None

    def start(self):
        start_profiler()
        if not self.timer_only:
            try:
                start_trace(self._log_dir)
            except Exception:
                pass

    def stop(self):
        if self._step_marker is not None:
            self._step_marker.end()
            self._step_marker = None
        if not self.timer_only:
            try:
                stop_trace()
            except Exception:
                pass
        global _enabled
        _enabled = False
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)

    def step(self):
        """Mark a train-step boundary (shows as ProfileStep spans)."""
        if self._step_marker is not None:
            self._step_marker.end()
        self._step_marker = RecordEvent("ProfileStep")
        self._step_marker.begin()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def summary(self, sorted_by="total", **kw):
        """Print + return the host-event summary table (reference
        Profiler.summary op table analogue)."""
        table = summary_table(sorted_by)
        print(table)
        return table

    def export(self, path="profiler_trace.json", format="json"):
        return export_chrome_trace(path)
