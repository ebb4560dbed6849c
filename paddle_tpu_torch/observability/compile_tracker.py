"""The graph-capture census — port of
``paddle_tpu/observability/compile_tracker.py``.

The reference counts the compiled XLA executables behind each jitted
serving function (``fn._cache_size()``) and publishes them as
``serving_jit_compiles{engine,fn}``: a count that grows on a steady
stream means a shape leaked into a jit key. The port compiles nothing
per shape. Its engine captures each program it dispatches as a CUDA
graph in its constructor (``inference/graphs.py``) and replays it; a
program that runs eagerly (the CPU, ``_capture=False``, the first-token
sample) builds nothing ahead. So the census counts, per program,

- ``captures``: the CUDA graphs captured for it, or, for an eagerly
  dispatched program, 1 from its first dispatch on (where an eager
  program first loads its kernels, as a jit compiles at its first
  call). On the CPU the counts thus equal the reference's executable
  counts on the same traffic; on the card they are fixed by the
  constructor (a fused decode block counts one graph per bucket above
  1, captured whether or not the traffic reaches it);
- ``replays``: the dispatches of it.

:class:`CompileTracker` publishes both: the gauge keeps the reference's
family name, ``serving_jit_compiles{engine,fn}``, and ``fn`` takes the
reference's function names, so a consumer of the reference's series
reads the port's; replays go to ``serving_graph_replays_total{fn}``.
The bounded module-level event log (``compile_events()``) holds one
record per capture, with its start and end on the ``perf_counter``
clock, which the merged timeline renders as its ``graph-capture`` lane.

There is no XLA executable, so the reference's ``analyze()`` (the AOT
``cost_analysis()`` / ``memory_analysis()`` pass) and its
``xla_cost_flops`` / ``xla_cost_bytes_accessed`` / ``xla_memory_bytes``
gauges have no counterpart here, and the engine takes no
``cost_analysis=``. The serving ledger (``observability/ledger.py``)
gives each dispatch's FLOPs and bytes analytically instead.

The reference's ``hlo_collective_stats`` (the collectives a compiled
mesh program holds, ``engine.xla_costs[fn]["collective_bytes"]`` and
``["collective_by_op"]``) has a counted counterpart: a tensor-parallel
engine's programs call their collectives through one counting wrapper
(``inference/tp.py``, ``TPContext._all_reduce`` / ``_all_gather``), and
the engine arms it around each program's first run, keeping the bytes
by op (``"all-reduce"``, ``"all-gather"``: each op's result, the
reference's payload convention) under the same keys in
``engine.xla_costs``. A fused decode block and the propose scan run K
steps in one program; their entries are per step, as the reference's
census counts a scan body once.
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["cache_size", "CompileTracker", "record_compile_event",
           "compile_events", "clear_compile_events"]


def cache_size(prog):
    """Graphs captured behind a serving program (``captures``: 1 for a
    ``GraphProgram``, 0 or 1 for an ``EagerProgram`` by whether it has
    run), or None for an object that carries no count."""
    n = getattr(prog, "captures", None)
    return None if n is None else int(n)


# -- module capture-event log ------------------------------------------------
# One record per capture: {"fn", "t0", "t1", "ts", **attrs}. t0/t1 are
# perf_counter (the shared timeline clock), ts is wall time. Bounded.

_events = deque(maxlen=1024)
_events_lock = threading.Lock()


def record_compile_event(fn, t0=None, t1=None, **attrs):
    """Append one capture event; returns the record. ``t0``/``t1``
    default to now (a zero-duration marker)."""
    now = time.perf_counter()
    ev = {"fn": str(fn), "t0": now if t0 is None else float(t0),
          "t1": (t1 if t1 is not None else t0 if t0 is not None
                 else now), "ts": time.time()}
    ev["t1"] = float(ev["t1"])
    ev.update(attrs)
    with _events_lock:
        _events.append(ev)
    return ev


def compile_events():
    """The recorded capture events, oldest first."""
    with _events_lock:
        return [dict(e) for e in _events]


def clear_compile_events():
    with _events_lock:
        _events.clear()


class CompileTracker:
    """Track the serving programs of one engine under the reference's
    function names and publish their capture counts as a labeled gauge
    (one series per name) and their replays as a counter. A name may
    hold several programs (``decode_block``: one per bucket) or none (a
    mixed-step engine's ``decode_step``), which publishes 0, as the
    reference's never-called jit does."""

    def __init__(self, registry=None, gauge_name="jit_compiles",
                 help="CUDA graphs captured per serving program",
                 extra_labels=None, replay_counter_name=None):
        """``extra_labels``: constant labels stamped on every gauge
        series (``{"engine": "0"}``) so trackers sharing one registry
        don't clobber each other's values."""
        self._progs = {}         # name -> [program]
        self._extra = dict(extra_labels or {})
        self._gauge = self._replays = None
        self._last_replays = {}  # name -> replays already counted
        if registry is not None:
            self._gauge = registry.gauge(
                gauge_name, help, labels=(*self._extra, "fn"))
            if replay_counter_name:
                self._replays = registry.counter(
                    replay_counter_name,
                    "dispatches of each serving program (CUDA-graph "
                    "replays, or eager calls)", labels=("fn",))

    def track(self, name, prog=None, t0=None, t1=None):
        """Register ``prog`` under ``name`` (``None``: the name alone, at
        0). With ``t0``/``t1``, the program's capture interval is logged
        as a capture event. Returns ``prog``."""
        progs = self._progs.setdefault(str(name), [])
        if prog is not None:
            progs.append(prog)
            if t0 is not None:
                record_compile_event(name, t0=t0, t1=t1, source="capture",
                                     count=self._count(name),
                                     **self._extra)
        return prog

    def _count(self, name):
        return sum(cache_size(p) or 0 for p in self._progs[name])

    def counts(self):
        """{name: captures} for every tracked name."""
        return {name: self._count(name) for name in self._progs}

    def replays(self):
        """{name: dispatches} for every tracked name."""
        return {name: sum(int(getattr(p, "replays", 0)) for p in progs)
                for name, progs in self._progs.items()}

    def publish(self):
        """Push the capture counts into the gauge and the replays since
        the last publish into the counter. Returns the counts."""
        counts = self.counts()
        if self._gauge is not None:
            for name, n in counts.items():
                self._gauge.labels(**self._extra, fn=name).set(n)
        if self._replays is not None:
            for name, n in self.replays().items():
                last = self._last_replays.get(name)
                if last is None or n > last:   # materialized at 0 once
                    self._replays.labels(fn=name).inc(n - (last or 0))
                    self._last_replays[name] = n
        return counts

    def remove_series(self):
        """Retire this tracker's gauge series (engine shutdown) so a
        shared registry doesn't accumulate dead {fn=...} series; the
        replay counter keeps its aggregable totals."""
        if self._gauge is not None:
            for name in self._progs:
                self._gauge.remove(**self._extra, fn=name)
