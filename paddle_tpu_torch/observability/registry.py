"""Process-wide metrics registry: Counter / Gauge / Histogram with
labeled series, thread-safe, zero-dep — port of
``paddle_tpu/observability/registry.py`` (stdlib only, kept as the
port's own copy; the same operations give byte-identical
``expose_text()`` and equal ``snapshot()``).

A serving system needs *live* counters ("what is TTFT p99 / queue
depth / page utilization right now"), so this module provides the
Prometheus data model in stdlib Python:

- ``MetricsRegistry.counter/gauge/histogram(name, help, labels=())``
  get-or-create a metric family; re-registering an existing name with
  the same type/labels returns the SAME family (so two ServingEngines
  sharing the default registry aggregate instead of colliding), while
  a type or label mismatch raises.
- Families with ``labels`` hand out per-series children via
  ``.labels(reason="eos")``; unlabeled families proxy ``inc/set/
  observe`` straight to their single anonymous series.
- ``expose_text()`` renders Prometheus text exposition (HELP/TYPE
  lines, escaped label values, ``_bucket``/``_sum``/``_count`` for
  histograms); ``snapshot()`` returns a point-in-time dict that
  round-trips through ``json.dumps``.

Histogram buckets are fixed at family creation (cumulative ``le``
upper bounds plus implicit ``+Inf``), and ``quantile(q)`` gives the
standard bucket-interpolated estimate (what PromQL's
``histogram_quantile`` computes server-side) so tools can report
p50/p99 without keeping raw samples.
"""
from __future__ import annotations

import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-oriented default boundaries (seconds): sub-ms dispatch floors
# up through multi-second prefill/compile tails
DEFAULT_BUCKETS = (0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02,
                   0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v):
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v):
    f = float(v)
    # Prometheus explicitly allows non-finite samples (a NaN loss gauge
    # must not take down the scrape endpoint)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(bound):
    return "+Inf" if bound == float("inf") else _fmt(bound)


def _json_num(v):
    """A float as a STRICT-JSON-safe value: non-finite floats become
    their exposition strings ("NaN"/"+Inf"/"-Inf") because RFC 8259
    parsers (JSON.parse, jq) reject python json's bare NaN token."""
    f = float(v)
    if f != f or f in (float("inf"), float("-inf")):
        return _fmt(f)
    return f


class _CounterSeries:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount


class _GaugeSeries:
    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


class _HistogramSeries:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds          # ascending, ends with +Inf
        self.counts = [0] * len(bounds)  # per-bucket (NON-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value, n=1):
        """Record ``value`` (``n`` times: the same as ``n`` calls, the
        sum accumulated one addition at a time)."""
        v = float(value)
        with self._lock:
            lo, hi = 0, len(self._bounds) - 1
            while lo < hi:              # first bound >= v
                mid = (lo + hi) // 2
                if v <= self._bounds[mid]:
                    hi = mid
                else:
                    lo = mid + 1
            self.counts[lo] += n
            for _ in range(n):
                self.sum += v
            self.count += n

    def cumulative(self):
        return self.stats()[0]

    def stats(self):
        """(cumulative counts, sum, count) captured under ONE lock
        acquisition, so a concurrent observe() cannot make a scrape
        report _count != the +Inf bucket."""
        out, acc = [], 0
        with self._lock:
            for c in self.counts:
                acc += c
                out.append(acc)
            return out, self.sum, self.count

    def quantile(self, q):
        """Bucket-interpolated quantile estimate (histogram_quantile
        semantics): locate the bucket where the cumulative count crosses
        ``q * count`` and interpolate linearly inside it. Returns 0.0
        with no observations; the top bucket clamps to its lower bound
        (an unbounded +Inf bucket has no width to interpolate)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            rank = q * total
            acc = 0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if acc + c >= rank:
                    lo = self._bounds[i - 1] if i else 0.0
                    hi = self._bounds[i]
                    if hi == float("inf"):
                        return lo
                    return lo + (hi - lo) * max(rank - acc, 0.0) / c
                acc += c
            return self._bounds[-2] if len(self._bounds) > 1 else 0.0


_SERIES_CLS = {"counter": _CounterSeries, "gauge": _GaugeSeries,
               "histogram": _HistogramSeries}


class _MetricFamily:
    """One named metric: help text, label names, and the per-labelset
    series. Unlabeled families proxy series methods directly."""

    type = None  # "counter" | "gauge" | "histogram"

    def __init__(self, name, help, labels=(), lock=None, buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        if self.type == "histogram" and "le" in labels:
            raise ValueError("'le' is reserved for histogram buckets")
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self._lock = lock if lock is not None else threading.RLock()
        if self.type == "histogram":
            bounds = sorted(float(b) for b in (
                DEFAULT_BUCKETS if buckets is None else buckets))
            if not bounds:
                raise ValueError("histogram needs >= 1 bucket bound")
            if bounds[-1] != float("inf"):
                bounds.append(float("inf"))
            self._bounds = tuple(bounds)
        self._series = {}

    def _make_series(self):
        cls = _SERIES_CLS[self.type]
        if self.type == "histogram":
            return cls(self._lock, self._bounds)
        return cls(self._lock)

    def labels(self, **kv):
        names = self.labelnames
        key = None
        if len(kv) == len(names):
            try:
                key = tuple([str(kv[n]) for n in names])
            except KeyError:
                pass
        if key is None:
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        # an existing series is one dict read (atomic under the GIL): the
        # serving loop resolves several a step; creation takes the lock
        s = self._series.get(key)
        if s is not None:
            return s
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._make_series()
            return s

    def _default_series(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use "
                ".labels(...) to pick a series")
        return self.labels()

    def series_items(self):
        with self._lock:
            return list(self._series.items())

    def remove(self, **kv):
        """Drop the series for this exact labelset (e.g. a retired
        engine instance) so scrapes and registry memory don't grow
        without bound as instances come and go."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            self._series.pop(key, None)

    def remove_matching(self, **kv):
        """Drop every series whose labels match ALL the given pairs —
        retire one instance's series across a multi-label family (e.g.
        ``remove_matching(model="3")`` on a {model, fn} gauge)."""
        unknown = set(kv) - set(self.labelnames)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown labels {tuple(sorted(unknown))}")
        idx = [(self.labelnames.index(n), str(v)) for n, v in kv.items()]
        with self._lock:
            for key in [k for k in self._series
                        if all(k[i] == v for i, v in idx)]:
                del self._series[key]

    def reset(self):
        with self._lock:
            self._series.clear()


class Counter(_MetricFamily):
    type = "counter"

    def inc(self, amount=1.0):
        self._default_series().inc(amount)

    @property
    def value(self):
        return self._default_series().value


class Gauge(_MetricFamily):
    type = "gauge"

    def set(self, value):
        self._default_series().set(value)

    def inc(self, amount=1.0):
        self._default_series().inc(amount)

    def dec(self, amount=1.0):
        self._default_series().dec(amount)

    @property
    def value(self):
        return self._default_series().value


class Histogram(_MetricFamily):
    type = "histogram"

    def observe(self, value, n=1):
        self._default_series().observe(value, n)

    def quantile(self, q):
        return self._default_series().quantile(q)

    @property
    def sum(self):
        return self._default_series().sum

    @property
    def count(self):
        return self._default_series().count


_FAMILY_CLS = {"counter": Counter, "gauge": Gauge,
               "histogram": Histogram}


class MetricsRegistry:
    """Named collection of metric families sharing one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families = {}  # name -> family (insertion-ordered)

    def _get_or_create(self, kind, name, help, labels, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}, not {kind}")
                if fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labels)}")
                if kind == "histogram" and buckets is not None:
                    want = sorted(float(b) for b in buckets)
                    if not want:
                        raise ValueError(
                            "histogram needs >= 1 bucket bound")
                    if want[-1] != float("inf"):
                        want.append(float("inf"))
                    if tuple(want) != fam._bounds:
                        raise ValueError(
                            f"histogram {name!r} already registered "
                            f"with buckets {fam._bounds}, not "
                            f"{tuple(want)}")
                return fam
            fam = _FAMILY_CLS[kind](name, help, labels, lock=self._lock,
                                    buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labels=()):
        return self._get_or_create("counter", name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create("gauge", name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        return self._get_or_create("histogram", name, help, labels,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def families(self):
        with self._lock:
            return list(self._families.values())

    def reset(self):
        """Drop every series (families/helps/buckets survive) — lets a
        bench flush its warmup phase without rebuilding metric handles."""
        for fam in self.families():
            fam.reset()

    def unregister(self, name):
        with self._lock:
            self._families.pop(name, None)

    # -- exporters -----------------------------------------------------------
    def expose_text(self):
        """Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for key, s in fam.series_items():
                pairs = [f'{n}="{_escape_label(v)}"'
                         for n, v in zip(fam.labelnames, key)]
                base = "{" + ",".join(pairs) + "}" if pairs else ""
                if fam.type == "histogram":
                    cums, total, count = s.stats()
                    for bound, cum in zip(fam._bounds, cums):
                        bp = pairs + [f'le="{_fmt_le(bound)}"']
                        lines.append(f"{fam.name}_bucket"
                                     "{" + ",".join(bp) + "}" f" {cum}")
                    lines.append(f"{fam.name}_sum{base} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{base} {count}")
                else:
                    lines.append(f"{fam.name}{base} {_fmt(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """Point-in-time JSON-serializable view of every series."""
        out = {}
        for fam in self.families():
            series = []
            for key, s in fam.series_items():
                rec = {"labels": dict(zip(fam.labelnames, key))}
                if fam.type == "histogram":
                    cums, total, count = s.stats()
                    rec["buckets"] = {
                        _fmt_le(b): c
                        for b, c in zip(fam._bounds, cums)}
                    rec["sum"] = _json_num(total)
                    rec["count"] = count
                else:
                    rec["value"] = _json_num(s.value)
                series.append(rec)
            out[fam.name] = {"type": fam.type, "help": fam.help,
                             "series": series}
        return out


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what instrumented subsystems
    bind to when not handed an explicit one)."""
    return _default_registry
