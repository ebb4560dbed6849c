"""Request-level tracing: span trees + flight recorder + unified
Chrome-trace export — port of ``paddle_tpu/observability/tracing.py``
(stdlib only, kept as the port's own copy).

The registry answers *what is TTFT p99 right now*; this module answers
*why was request #4217 slow*: every request gets an explicit trace id
and a tree of named spans (queued -> prefill chunk k -> decode segment
-> finish), each carrying attributes (token counts, slot/page ids), so
tail latency decomposes into its causal phases the aggregate
histograms cannot separate.

Three pieces:

- :class:`Tracer` — thread-safe span/trace collector. Traces are
  created with explicit ids (``start_trace``), spans attach to a trace
  from ANY thread (``start_span(trace_id=...)`` / the ``span(...)``
  context manager, which also supports implicit same-thread nesting),
  and completed traces land in a bounded ring buffer.
- **flight recorder** — the ring buffer of the last N completed traces
  plus every in-flight trace, serialized by ``dump(path)`` as a JSON
  postmortem. The ServingEngine dumps automatically on an engine
  exception, on ``close()``, and on SIGUSR1
  (``install_signal_handler`` + ``register_postmortem``) — the
  "engine is hung, what was it doing" tool.
- :func:`export_merged_chrome_trace` — one chrome://tracing JSON with
  one ``pid`` lane per component: host-profiler RecordEvent spans
  (``paddle_tpu_torch.profiler``), each tracer's request span trees
  (one ``tid`` row per trace), and the CUDA-graph capture events of
  ``observability.compile_tracker`` (the reference's XLA-compile
  lane). All three collectors share the ``time.perf_counter`` clock,
  so the merged file lines up in Perfetto.

Cross-process propagation: ``Tracer.inject()`` emits the
current span's context as a plain JSON-safe dict (trace id + span id
+ tracer/replica/pid provenance) ready to ride an RPC header;
``extract_context()`` validates it on the receiving side, and
``start_trace(parent_ctx=...)`` records the caller's span as the new
trace's cross-process parent. Tracers carry a ``replica`` identity
and flight-recorder dumps carry ``replica``/``pid`` metadata, so
``export_merged_chrome_trace(dumps=[...])`` merges dumps from many
processes into one Perfetto file with a ``<tracer>@<replica>`` lane
each (fresh pids — no collisions) and flow arrows from every caller
span to its engine-side child trace roots.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "Span", "Trace", "Tracer", "get_tracer", "extract_context",
    "export_merged_chrome_trace", "dump_chrome_events",
    "register_postmortem", "unregister_postmortem",
    "install_signal_handler", "FLIGHT_RECORDER_FORMAT",
    "TRACE_CONTEXT_KEYS",
]

FLIGHT_RECORDER_FORMAT = "paddle_tpu-flight-recorder-v1"

# the wire shape of an injected trace context: a plain
# JSON-safe dict ready to ride an RPC header from router to engine.
# trace_id + span_id name the caller's span; tracer/replica/pid are
# provenance the merged timeline uses to find the parent's lane.
TRACE_CONTEXT_KEYS = ("trace_id", "span_id", "tracer", "replica", "pid")


def extract_context(ctx):
    """Validate an injected trace context (the receiving side of
    ``Tracer.inject``): returns ``(trace_id, span_id)`` or ``None``
    when ``ctx`` is missing/malformed — a garbled header must degrade
    to an unparented trace, never take down the request."""
    if not isinstance(ctx, dict):
        return None
    trace_id = ctx.get("trace_id")
    span_id = ctx.get("span_id", 0)
    if not trace_id or not isinstance(span_id, int) \
            or isinstance(span_id, bool) or span_id < 0:
        return None
    return str(trace_id), span_id

_now = time.perf_counter  # the profiler's span clock — merged lanes align


class Span:
    """One named interval inside a trace. ``end()`` is idempotent;
    ``set_attr`` may be called before or after end. Spans created past
    the trace's span cap get ``dropped=True`` and are not recorded."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs",
                 "tid", "dropped", "_trace")

    def __init__(self, trace, name, span_id, parent_id, attrs,
                 dropped=False):
        self.name = str(name)
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = _now()
        self.t1 = None
        self.attrs = dict(attrs)
        self.tid = threading.get_ident()
        self.dropped = dropped
        self._trace = trace

    @property
    def trace_id(self):
        return self._trace.trace_id

    @property
    def duration(self):
        return None if self.t1 is None else self.t1 - self.t0

    def set_attr(self, **kv):
        self.attrs.update(kv)
        return self

    def end(self, **attrs):
        if attrs:
            self.attrs.update(attrs)
        if self.t1 is None:
            self.t1 = _now()
        return self

    def to_dict(self):
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t0": self.t0, "t1": self.t1,
                "tid": self.tid, "attrs": dict(self.attrs)}

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        if exc is not None:
            self.attrs["error"] = repr(exc)
        self.end()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, trace={self.trace_id!r})")


class Trace:
    """One trace: a root span (span_id 0) plus its recorded children.
    ``spans_dropped`` counts spans refused past ``max_spans`` (the
    per-trace analogue of the profiler's ``_SPAN_CAP``)."""

    __slots__ = ("trace_id", "name", "attrs", "t0", "t1", "ts0",
                 "status", "spans", "spans_dropped", "tid", "_next_sid",
                 "parent_ctx")

    def __init__(self, name, trace_id, attrs, tid, parent_ctx=None):
        self.trace_id = trace_id
        self.name = str(name)
        self.attrs = dict(attrs)
        self.t0 = _now()
        self.ts0 = time.time()     # wall clock, for postmortem readers
        self.t1 = None
        self.status = "in_flight"  # "in_flight" | "ok" | "error" | ...
        self.tid = tid             # chrome-trace row for this trace
        self.parent_ctx = parent_ctx  # validated inject() dict or None
        self._next_sid = itertools.count(1)
        root = Span(self, name, 0, None, attrs)
        root.t0 = self.t0
        if parent_ctx is not None:
            # cross-process parentage: the caller's span in
            # ANOTHER process's tracer — recorded as attrs here, turned
            # into a real parent link when dumps are merged
            root.attrs["parent_trace_id"] = parent_ctx["trace_id"]
            root.attrs["parent_span_id"] = parent_ctx.get("span_id", 0)
        self.spans = [root]
        self.spans_dropped = 0

    @property
    def root(self):
        return self.spans[0]

    def find(self, name):
        """Recorded spans with this name (lifecycle-phase lookup)."""
        return [s for s in self.spans if s.name == name]

    def to_dict(self):
        d = {"trace_id": self.trace_id, "name": self.name,
             "status": self.status, "t0": self.t0, "t1": self.t1,
             "ts0": self.ts0, "attrs": dict(self.attrs),
             "spans_dropped": self.spans_dropped,
             "spans": [s.to_dict() for s in self.spans]}
        if self.parent_ctx is not None:
            d["parent_ctx"] = dict(self.parent_ctx)
        return d


class Tracer:
    """Thread-safe trace/span collector with a bounded flight recorder.

    >>> tracer = Tracer("requests")
    >>> tr = tracer.start_trace("request", trace_id="req7", uid=7)
    >>> with tracer.span("prefill", trace_id="req7", chunks=2) as sp:
    ...     sp.set_attr(first_token=42)
    >>> tracer.end_trace("req7", finish_reason="eos")

    Completed traces occupy a ``deque(maxlen=max_traces)`` ring; live
    traces are held until ``end_trace`` (a stuck request stays visible
    to ``dump()`` forever — that is the point). If live traces leak
    past ``4 * max_traces`` the oldest are force-completed with status
    ``"abandoned"`` so an ill-behaved caller cannot grow memory without
    bound."""

    def __init__(self, name="tracer", max_traces=256,
                 max_spans_per_trace=4096, replica=None):
        self.name = str(name)
        # replica identity: rides injected contexts and
        # flight-recorder dumps so a merged multi-process timeline can
        # name per-replica lanes; defaults to this process's pid
        self.replica = str(replica) if replica is not None \
            else f"pid{os.getpid()}"
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._lock = threading.RLock()
        self._live = {}                       # trace_id -> Trace
        self._done = deque(maxlen=max_traces)
        self._local = threading.local()       # ctx-manager span stack
        self._auto_ids = itertools.count()
        self._tids = itertools.count()

    # -- cross-process context propagation -----------------------------------
    def inject(self, trace_id=None, span_id=None):
        """The trace context of a live span as a plain JSON-safe dict —
        ready to ride an RPC header to another process, whose tracer
        then parents a new trace under it via
        ``start_trace(..., parent_ctx=ctx)``. ``trace_id=None`` uses
        the innermost context-manager span on this thread;
        ``span_id=None`` uses that span (or the trace root). Raises on
        an unknown trace — injecting a dead context is a caller bug."""
        stack = self._stack()
        with self._lock:
            if trace_id is None:
                if not stack:
                    raise ValueError(
                        "inject() without trace_id needs an enclosing "
                        "tracer.span(...) context on this thread")
                sp = stack[-1]
                tr = sp._trace
                if span_id is None:
                    span_id = sp.span_id
            else:
                tr = self._live.get(str(trace_id))
                if tr is None:
                    raise KeyError(f"no live trace {trace_id!r}")
                if span_id is None:
                    span_id = 0
            return {"trace_id": tr.trace_id, "span_id": int(span_id),
                    "tracer": self.name, "replica": self.replica,
                    "pid": os.getpid()}

    # -- traces --------------------------------------------------------------
    def start_trace(self, name, trace_id=None, parent_ctx=None, **attrs):
        """Open a trace. ``parent_ctx`` — a dict produced by another
        process's ``inject()`` — records the caller's (trace_id,
        span_id) so the merged multi-process timeline parents this
        trace's span tree under the caller's span. A malformed ctx is
        dropped (see :func:`extract_context`), never raises."""
        if parent_ctx is not None:
            ext = extract_context(parent_ctx)
            parent_ctx = None if ext is None else dict(parent_ctx)
        with self._lock:
            if trace_id is None:
                trace_id = f"{self.name}-{next(self._auto_ids)}"
            trace_id = str(trace_id)
            if trace_id in self._live:
                raise ValueError(f"trace {trace_id!r} already live")
            tr = Trace(name, trace_id, attrs, next(self._tids),
                       parent_ctx=parent_ctx)
            self._live[trace_id] = tr
            # leak guard: force-retire the oldest live traces
            while len(self._live) > 4 * self.max_traces:
                old_id = next(iter(self._live))
                self._end_trace_locked(old_id, status="abandoned")
            return tr

    def _end_trace_locked(self, trace_id, status="ok", **attrs):
        tr = self._live.pop(str(trace_id), None)
        if tr is None:
            return None
        tr.t1 = _now()
        tr.status = status
        tr.attrs.update(attrs)
        tr.root.attrs.update(attrs)
        for s in tr.spans:
            if s.t1 is None:
                s.t1 = tr.t1
                if s.span_id != 0:
                    s.attrs.setdefault("auto_ended", True)
        self._done.append(tr)
        return tr

    def end_trace(self, trace_id, status="ok", **attrs):
        """Complete a trace and move it into the flight-recorder ring.
        Open spans are closed at the trace end (``auto_ended`` marks
        them). Unknown ids are a no-op (idempotent finish paths)."""
        with self._lock:
            return self._end_trace_locked(trace_id, status, **attrs)

    def get(self, trace_id):
        """The live or completed trace with this id, or None."""
        trace_id = str(trace_id)
        with self._lock:
            tr = self._live.get(trace_id)
            if tr is not None:
                return tr
            for t in reversed(self._done):
                if t.trace_id == trace_id:
                    return t
        return None

    def live_traces(self):
        with self._lock:
            return list(self._live.values())

    def completed_traces(self):
        with self._lock:
            return list(self._done)

    def reset(self):
        with self._lock:
            self._live.clear()
            self._done.clear()

    # -- spans ---------------------------------------------------------------
    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def start_span(self, name, trace_id=None, parent_id=None, **attrs):
        """Open a span. ``trace_id=None`` attaches to the innermost
        context-manager span on THIS thread; ``parent_id=None`` nests
        under that span when it belongs to the same trace, else under
        the root (span_id 0)."""
        stack = self._stack()
        with self._lock:
            if trace_id is None:
                if not stack:
                    raise ValueError(
                        "start_span without trace_id needs an enclosing "
                        "tracer.span(...) context on this thread")
                tr = stack[-1]._trace
            else:
                tr = self._live.get(str(trace_id))
                if tr is None:
                    raise KeyError(f"no live trace {trace_id!r}")
            if parent_id is None:
                parent_id = (stack[-1].span_id
                             if stack and stack[-1]._trace is tr else 0)
            if len(tr.spans) >= self.max_spans_per_trace:
                tr.spans_dropped += 1
                return Span(tr, name, next(tr._next_sid), parent_id,
                            attrs, dropped=True)
            sp = Span(tr, name, next(tr._next_sid), parent_id, attrs)
            tr.spans.append(sp)
            return sp

    @contextlib.contextmanager
    def span(self, name, trace_id=None, parent_id=None, **attrs):
        """Context-managed span; nests implicitly on the same thread,
        records ``error=repr(exc)`` when the body raises."""
        sp = self.start_span(name, trace_id=trace_id,
                             parent_id=parent_id, **attrs)
        stack = self._stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.attrs["error"] = repr(exc)
            raise
        finally:
            stack.pop()
            sp.end()

    # -- flight recorder -----------------------------------------------------
    def to_dict(self, reason="manual"):
        with self._lock:
            return {
                "format": FLIGHT_RECORDER_FORMAT,
                "tracer": self.name,
                # process/replica provenance: merged
                # multi-process timelines name lanes and resolve
                # cross-process parent links from these
                "replica": self.replica,
                "pid": os.getpid(),
                "reason": str(reason),
                "ts": time.time(),
                "perf_now": _now(),
                "completed": [t.to_dict() for t in self._done],
                "in_flight": [t.to_dict() for t in self._live.values()],
            }

    _dump_seq = itertools.count()

    def dump(self, path, reason="manual"):
        """Write the postmortem JSON atomically (write + rename — a
        SIGUSR1 arriving mid-dump must not leave a torn file; the tmp
        name is unique PER CALL so a reentrant signal-handler dump of
        the same path cannot truncate the one in progress). Returns
        the path."""
        doc = self.to_dict(reason)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{next(Tracer._dump_seq)}"
        with open(tmp, "w") as f:
            # default=str: attrs are caller-chosen — an exotic attr
            # value must not take down the postmortem path
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path

    # -- chrome export -------------------------------------------------------
    def chrome_events(self, pid=0, t_end=None):
        """This tracer's traces as chrome-trace events on one ``pid``
        lane: one ``tid`` row per trace (named by thread_name
        metadata), one X event per span. Open spans extend to
        ``t_end`` (default: now)."""
        if t_end is None:
            t_end = _now()
        with self._lock:
            traces = list(self._done) + list(self._live.values())
            events = []
            for tr in traces:
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tr.tid,
                    "args": {"name": f"{tr.name} {tr.trace_id}"}})
                for sp in tr.spans:
                    t1 = sp.t1 if sp.t1 is not None else \
                        (tr.t1 if tr.t1 is not None else t_end)
                    args = {"trace_id": tr.trace_id,
                            "span_id": sp.span_id,
                            "parent_id": sp.parent_id}
                    args.update(sp.attrs)
                    events.append({
                        "name": sp.name, "ph": "X", "cat": self.name,
                        "ts": sp.t0 * 1e6,
                        "dur": max(t1 - sp.t0, 0.0) * 1e6,
                        "pid": pid, "tid": tr.tid, "args": args})
        return events


def dump_chrome_events(doc, pid=0, t_end=None):
    """A flight-recorder dump dict as chrome-trace events on one
    ``pid`` lane — the offline twin of ``Tracer.chrome_events`` (one
    ``tid`` row per trace, one X event per span). ``time.perf_counter``
    is CLOCK_MONOTONIC on Linux — system-wide since boot — so dumps
    from different processes on ONE host line up when merged."""
    if t_end is None:
        t_end = doc.get("perf_now") or _now()
    events = []
    for tr in list(doc.get("completed", [])) \
            + list(doc.get("in_flight", [])):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": tr.get("tid", 0),
            "args": {"name": f"{tr.get('name')} {tr.get('trace_id')}"}})
        tr_t1 = tr.get("t1")
        for sp in tr.get("spans", []):
            t1 = sp.get("t1")
            if t1 is None:
                t1 = tr_t1 if tr_t1 is not None else t_end
            args = {"trace_id": tr.get("trace_id"),
                    "span_id": sp.get("span_id"),
                    "parent_id": sp.get("parent_id")}
            args.update(sp.get("attrs") or {})
            events.append({
                "name": sp.get("name"), "ph": "X",
                "cat": doc.get("tracer", "tracer"),
                "ts": sp.get("t0", 0.0) * 1e6,
                "dur": max(t1 - sp.get("t0", 0.0), 0.0) * 1e6,
                "pid": pid, "tid": tr.get("tid", 0), "args": args})
    return events


def _doc_replica(doc):
    """A dump's replica identity (falls back to its pid) — the lane
    key that disambiguates colliding per-process trace ids (every
    process's first engine emits ``e0:req0``)."""
    return str(doc.get("replica") or f"pid{doc.get('pid', '?')}")


def _cross_process_flows(docs_with_pids):
    """Chrome flow-event pairs (``ph: s``/``f``) linking every trace
    that carries a ``parent_ctx`` to its caller's span in ANOTHER
    lane of the same merge — the Perfetto arrow that makes "the
    engine-side tree parents under the router's span" visible.
    ``docs_with_pids``: [(dump-doc, chrome pid)]. Spans are indexed
    by (replica, trace_id, span_id) — trace ids are only unique
    per process, and the injected ctx names its replica — so
    colliding ids across dumps never bind an arrow to the wrong
    lane. Parents outside the merge are skipped (their dump was not
    collected — the attrs on the child root still record the link)."""
    index = {}   # (replica, trace_id, span_id) -> (pid, tid, t0, t1)
    children = []  # (child trace dict, pid)
    for doc, pid in docs_with_pids:
        rep = _doc_replica(doc)
        for tr in list(doc.get("completed", [])) \
                + list(doc.get("in_flight", [])):
            tid = tr.get("tid", 0)
            for sp in tr.get("spans", []):
                index[(rep, tr.get("trace_id"),
                       sp.get("span_id"))] = (
                    pid, tid, sp.get("t0", 0.0),
                    sp.get("t1") or tr.get("t1") or sp.get("t0", 0.0))
            if tr.get("parent_ctx"):
                children.append((tr, pid))
    events = []
    for i, (tr, pid) in enumerate(children):
        ctx = tr["parent_ctx"]
        want = (ctx.get("trace_id"), ctx.get("span_id", 0))
        if ctx.get("replica"):
            parent = index.get((str(ctx["replica"]),) + want)
        else:
            # legacy ctx without replica provenance: match any lane,
            # ambiguous only if ids collide
            matches = [v for k, v in index.items() if k[1:] == want]
            parent = matches[0] if len(matches) == 1 else None
        if parent is None:
            continue
        ppid, ptid, pt0, pt1 = parent
        child_t0 = tr.get("t0", 0.0)
        # flow start pinned inside the parent span's interval (chrome
        # binds flow events to the enclosing slice at that timestamp)
        ts_s = min(max(child_t0, pt0), pt1)
        events.append({"name": "trace_parent", "ph": "s",
                       "cat": "xproc", "id": i + 1, "pid": ppid,
                       "tid": ptid, "ts": ts_s * 1e6})
        events.append({"name": "trace_parent", "ph": "f", "bp": "e",
                       "cat": "xproc", "id": i + 1, "pid": pid,
                       "tid": tr.get("tid", 0), "ts": child_t0 * 1e6})
    return events


_default_tracer = Tracer(name="requests")


def get_tracer() -> Tracer:
    """The process-wide default tracer (what instrumented subsystems
    bind when not handed an explicit one)."""
    return _default_tracer


# -- merged chrome-trace export ----------------------------------------------

def export_merged_chrome_trace(path, tracers=None, include_profiler=True,
                               include_compile=True, dumps=None):
    """One chrome://tracing JSON with a ``pid`` lane per component:

    - ``host-profiler`` — ``paddle_tpu_torch.profiler`` RecordEvent
      spans (one ``tid`` per OS thread, as the profiler recorded them),
    - one lane per tracer (default: the process tracer) — one ``tid``
      row per trace,
    - ``graph-capture`` — the CUDA-graph capture events of
      ``observability.compile_tracker`` (program key, engine, count),
      where the reference draws its ``xla-compile`` lane,
    - one lane per flight-recorder dump in ``dumps`` (paths or
      already-loaded dicts) — OTHER processes'/replicas' traces, named
      ``<tracer>@<replica>`` so per-replica lanes never collide, with
      cross-process ``parent_ctx`` links drawn as Perfetto flow arrows
      from the caller's span to each child trace's root.

    Returns the path."""
    events = []
    pid = 0
    t_end = _now()
    if include_profiler:
        from .. import profiler
        spans, dropped = profiler.get_spans()
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": "host-profiler"}})
        for name, t0, t1, tid in spans:
            events.append({"name": name, "ph": "X", "cat": "host",
                           "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                           "pid": pid, "tid": tid % (1 << 31)})
        if dropped:
            events.append({"name": "host_spans_dropped", "ph": "M",
                           "pid": pid, "args": {"count": dropped}})
        pid += 1
    docs_with_pids = []
    for tracer in (tracers if tracers is not None else [get_tracer()]):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": tracer.name}})
        events.extend(tracer.chrome_events(pid=pid, t_end=t_end))
        docs_with_pids.append((tracer.to_dict(), pid))
        pid += 1
    for dump in (dumps or ()):
        doc = dump
        if isinstance(dump, (str, os.PathLike)):
            with open(dump) as f:
                doc = json.load(f)
        lane = f"{doc.get('tracer', 'tracer')}" \
               f"@{doc.get('replica') or 'pid' + str(doc.get('pid'))}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": lane}})
        events.extend(dump_chrome_events(doc, pid=pid, t_end=t_end))
        docs_with_pids.append((doc, pid))
        pid += 1
    events.extend(_cross_process_flows(docs_with_pids))
    if include_compile:
        from .compile_tracker import compile_events
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": "graph-capture"}})
        for ev in compile_events():
            args = {k: v for k, v in ev.items()
                    if k not in ("t0", "t1", "fn")}
            events.append({
                "name": f"graph_capture:{ev['fn']}", "ph": "X",
                "cat": "capture", "ts": ev["t0"] * 1e6,
                "dur": max(ev["t1"] - ev["t0"], 1e-6) * 1e6,
                "pid": pid, "tid": 0, "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                  default=str)
    return path


# -- postmortem registry + SIGUSR1 -------------------------------------------
# (tracer, path) pairs dumped by the signal handler and available to
# "dump everything" callers. Engines register themselves and
# unregister on close().

_postmortems = []          # list of dicts {tracer, path}
_pm_lock = threading.Lock()
_prev_handler = None
_signal_installed = False


def register_postmortem(tracer, path):
    """Register ``tracer`` to be dumped to ``path`` on SIGUSR1 (and by
    :func:`dump_all_postmortems`). Returns a handle for
    :func:`unregister_postmortem`. The tracer is held by WEAK
    reference — a registration does not keep an abandoned tracer (and
    every trace in it) alive; dead entries are pruned at dump time."""
    import weakref
    handle = {"tracer": weakref.ref(tracer), "path": str(path)}
    with _pm_lock:
        _postmortems.append(handle)
    return handle


def unregister_postmortem(handle):
    with _pm_lock:
        try:
            _postmortems.remove(handle)
        except ValueError:
            pass


def dump_all_postmortems(reason="manual"):
    """Dump every registered (tracer, path) pair; returns the paths
    written. Failures are swallowed — a postmortem must never take
    down the process it is documenting."""
    with _pm_lock:
        items = list(_postmortems)
    written = []
    dead = []
    for h in items:
        tracer = h["tracer"]()
        if tracer is None:
            dead.append(h)
            continue
        try:
            written.append(tracer.dump(h["path"], reason=reason))
        except Exception:
            pass
    if dead:
        with _pm_lock:
            for h in dead:
                try:
                    _postmortems.remove(h)
                except ValueError:
                    pass
    return written


def _on_signal(signum, frame):
    dump_all_postmortems(reason="signal")
    prev = _prev_handler
    if callable(prev):
        prev(signum, frame)


def install_signal_handler(signum=None):
    """Install the flight-recorder dump on SIGUSR1 (chaining to any
    previous handler). Idempotent; returns True when installed. Safe
    to call from non-main threads (returns False — only the main
    thread may set signal handlers) and on platforms without SIGUSR1."""
    global _prev_handler, _signal_installed
    import signal as _signal
    if signum is None:
        signum = getattr(_signal, "SIGUSR1", None)
        if signum is None:
            return False
    if _signal_installed:
        return True
    try:
        prev = _signal.signal(signum, _on_signal)
    except ValueError:       # not the main thread
        return False
    if prev not in (_signal.SIG_DFL, _signal.SIG_IGN, _on_signal):
        _prev_handler = prev
    _signal_installed = True
    return True
