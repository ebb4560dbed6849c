"""Cross-process metric aggregation — the port's own copy of
``paddle_tpu/observability/aggregate.py`` (standard library only; the
port imports nothing of ``paddle_tpu``). The snapshot formats are the
reference's strings, so a snapshot from either package merges in the
other's aggregator.

The registry answers "what is THIS process doing"; a fleet
of engine replicas — the multi-engine router arc — needs ONE view:
fleet queue depth, fleet tokens/s, a p99 TTFT computed over every
replica's traffic. This module defines the versioned, mergeable
snapshot format and the merge semantics that make that view exact:

- :func:`wrap_snapshot` — a registry ``snapshot()`` stamped with
  ``format`` / ``replica`` / wall-clock ``ts`` / monotonic
  ``uptime_s`` (the denominator aggregator-side rates need).
- :func:`aggregate_snapshots` — merge N snapshots per metric family:

  * **counters sum** (series-exact: the fleet total equals what one
    combined registry would have counted),
  * **histograms merge bucket-wise** — both sides carry the same
    fixed boundaries, and cumulative counts are additive, so the
    merged buckets are EXACTLY the combined registry's buckets and
    post-merge ``histogram_quantile`` p50/p99 are the combined run's
    quantiles (no resolution lost beyond the buckets themselves),
  * **gauges keep a ``replica`` label** — "pages free" summed across
    replicas is a lie the router's placement logic would act on; the
    per-replica series IS the scale signal.

- :class:`FleetAggregator` — pulls N sources (``MetricsServer``
  endpoints over HTTP, snapshot files for test determinism, live
  registries, or callables) and re-exports one fleet-level
  Prometheus/JSON view (duck-typed like a registry, so
  ``MetricsServer(registry=aggregator)`` serves the fleet view live).

A type/label/bucket mismatch between replicas raises — two replicas
disagreeing about a metric's shape is a deploy bug the aggregator
must surface, not paper over.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

__all__ = [
    "SNAPSHOT_FORMAT", "FLEET_FORMAT", "wrap_snapshot",
    "aggregate_snapshots", "merged_quantile", "series_quantile",
    "fleet_expose_text", "FleetAggregator",
]

SNAPSHOT_FORMAT = "paddle_tpu-metrics-snapshot-v1"
FLEET_FORMAT = "paddle_tpu-fleet-snapshot-v1"

_NONFINITE = {"NaN": float("nan"), "+Inf": float("inf"),
              "-Inf": float("-inf")}


def _num(v):
    """A snapshot sample back to float (non-finite values ride JSON as
    their exposition strings — see registry._json_num)."""
    if isinstance(v, str):
        return _NONFINITE.get(v, float(v))
    return float(v)


def _fmt(v):
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def wrap_snapshot(registry, replica, ts=None, uptime_s=None):
    """``registry.snapshot()`` (or an already-taken snapshot dict) in
    the versioned mergeable envelope. Idempotent: a dict that already
    carries ``format`` passes through (its own stamps win)."""
    metrics = registry if isinstance(registry, dict) \
        else registry.snapshot()
    if metrics.get("format") in (SNAPSHOT_FORMAT, FLEET_FORMAT):
        return metrics
    return {
        "format": SNAPSHOT_FORMAT,
        "replica": str(replica),
        "ts": time.time() if ts is None else float(ts),
        "uptime_s": None if uptime_s is None else float(uptime_s),
        "metrics": metrics,
    }


def _parse_le(s):
    return float("inf") if s == "+Inf" else float(s)


def merged_quantile(buckets, count, q):
    """``histogram_quantile`` over a snapshot's ``buckets`` dict
    ({le-string: cumulative count}) — the registry's bucket-
    interpolated estimate, computable AFTER a merge (where no
    live Histogram object exists)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = int(count)
    if total == 0:
        return 0.0
    items = sorted(((_parse_le(k), int(v)) for k, v in buckets.items()))
    rank = q * total
    acc = 0
    prev_bound = 0.0
    last_finite = 0.0
    for bound, cum in items:
        c = cum - acc
        if c > 0:
            if cum >= rank:
                if bound == float("inf"):
                    return prev_bound
                return prev_bound + (bound - prev_bound) \
                    * max(rank - acc, 0.0) / c
            acc = cum
        if bound != float("inf"):
            last_finite = bound
            prev_bound = bound
    return last_finite


def series_quantile(series_rec, q):
    """Quantile of one snapshot histogram series record
    (``{"buckets": ..., "count": ...}``)."""
    return merged_quantile(series_rec["buckets"], series_rec["count"], q)


def _label_key(labels):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def aggregate_snapshots(snaps, fleet_name="fleet"):
    """Merge N wrapped snapshots into one fleet-level snapshot.

    Per-family semantics: counters sum, histograms merge bucket-wise
    (identical boundaries required), gauges gain a ``replica`` label
    and are kept per replica. Returns the ``FLEET_FORMAT`` doc; raises
    ``ValueError`` on a type/label/bucket disagreement between
    replicas (and on a ``replica`` label already present on a gauge —
    the aggregator owns that label)."""
    merged = {}     # name -> {"type", "help", series-map}
    replicas = []
    ts_max = None
    for snap in snaps:
        if snap.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"not a {SNAPSHOT_FORMAT} snapshot: "
                f"format={snap.get('format')!r}")
        replica = str(snap.get("replica", len(replicas)))
        replicas.append(replica)
        if snap.get("ts") is not None:
            ts_max = snap["ts"] if ts_max is None \
                else max(ts_max, snap["ts"])
        for name, fam in (snap.get("metrics") or {}).items():
            out = merged.get(name)
            if out is None:
                out = merged[name] = {"type": fam["type"],
                                      "help": fam.get("help", ""),
                                      "_series": {}}
            elif out["type"] != fam["type"]:
                raise ValueError(
                    f"metric {name!r}: replica {replica!r} reports type "
                    f"{fam['type']!r}, previously {out['type']!r}")
            for rec in fam.get("series", []):
                labels = dict(rec.get("labels") or {})
                if fam["type"] == "gauge":
                    if "replica" in labels:
                        raise ValueError(
                            f"gauge {name!r} already carries a "
                            "'replica' label — the aggregator owns it")
                    labels["replica"] = replica
                key = _label_key(labels)
                cur = out["_series"].get(key)
                if fam["type"] == "histogram":
                    if cur is None:
                        out["_series"][key] = {
                            "labels": labels,
                            "buckets": dict(rec["buckets"]),
                            "sum": _num(rec["sum"]),
                            "count": int(rec["count"])}
                    else:
                        if set(cur["buckets"]) != set(rec["buckets"]):
                            raise ValueError(
                                f"histogram {name!r}: replica "
                                f"{replica!r} has buckets "
                                f"{sorted(rec['buckets'])}, previously "
                                f"{sorted(cur['buckets'])} — fixed "
                                "boundaries must match to merge")
                        for le, c in rec["buckets"].items():
                            cur["buckets"][le] += int(c)
                        cur["sum"] += _num(rec["sum"])
                        cur["count"] += int(rec["count"])
                elif fam["type"] == "counter":
                    if cur is None:
                        out["_series"][key] = {
                            "labels": labels, "value": _num(rec["value"])}
                    else:
                        cur["value"] += _num(rec["value"])
                else:  # gauge: replica label makes every key unique
                    out["_series"][key] = {
                        "labels": labels, "value": _num(rec["value"])}
    metrics = {}
    for name, fam in merged.items():
        metrics[name] = {
            "type": fam["type"], "help": fam["help"],
            "series": [fam["_series"][k]
                       for k in sorted(fam["_series"])]}
    return {"format": FLEET_FORMAT, "fleet": str(fleet_name),
            "replicas": replicas, "ts": ts_max, "metrics": metrics}


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def fleet_expose_text(fleet_doc):
    """Prometheus text exposition of a merged fleet snapshot (the
    re-export surface a fleet-level scrape reads)."""
    lines = []
    for name, fam in (fleet_doc.get("metrics") or {}).items():
        help_ = str(fam.get("help", "")).replace("\\", "\\\\") \
            .replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for rec in fam["series"]:
            pairs = [f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(rec["labels"].items())]
            base = "{" + ",".join(pairs) + "}" if pairs else ""
            if fam["type"] == "histogram":
                for le, cum in sorted(
                        rec["buckets"].items(),
                        key=lambda kv: _parse_le(kv[0])):
                    bp = pairs + [f'le="{le}"']
                    lines.append(f"{name}_bucket"
                                 "{" + ",".join(bp) + "}" f" {cum}")
                lines.append(f"{name}_sum{base} {_fmt(rec['sum'])}")
                lines.append(f"{name}_count{base} {rec['count']}")
            else:
                lines.append(f"{name}{base} {_fmt(rec['value'])}")
    return "\n".join(lines) + "\n"


class FleetAggregator:
    """Pull N replica snapshots and re-export one fleet view.

    Sources (``add_source`` / constructor): an ``http://`` URL (a
    ``MetricsServer``'s ``/snapshot.json`` — a bare host:port URL gets
    the path appended), a snapshot FILE path (test determinism: no
    network in the loop), a ``MetricsRegistry`` (in-process replica),
    or a zero-arg callable returning a snapshot dict. ``collect()``
    fetches everything (per-source failures are recorded in
    ``last_errors`` and skipped — one dead replica must not blind the
    fleet view); ``aggregate()`` merges; ``expose_text()`` /
    ``snapshot()`` re-export, registry-duck-typed so
    ``MetricsServer(registry=FleetAggregator(...))`` serves the live
    fleet view. ``quantile()`` / ``total()`` are the router-facing
    scale-signal reads (fleet p99 TTFT, fleet queue depth)."""

    def __init__(self, sources=(), fleet_name="fleet", timeout=5.0,
                 max_errors=64):
        self._lock = threading.Lock()
        self._sources = []          # (replica, fetch) pairs
        self.fleet_name = str(fleet_name)
        self.timeout = float(timeout)
        # replica -> repr(exc) of the last pull, BOUNDED:
        # at most ``max_errors`` entries, each error string truncated —
        # a fleet of flapping replicas with long tracebacks must not
        # grow the aggregator without bound
        self.max_errors = int(max_errors)
        self.last_errors = {}
        self.sources_ok = 0         # sources that answered last collect
        self.sources_total = 0      # sources asked last collect
        self._fleet = None
        for src in sources:
            self.add_source(src)

    def add_source(self, src, replica=None):
        """Register a source; returns the replica name it will report
        under (overridable via ``replica=`` — URLs/files default to
        themselves, registries to their index)."""
        if isinstance(src, str) and src.startswith(("http://",
                                                    "https://")):
            url = src if src.rstrip("/").endswith("snapshot.json") \
                else src.rstrip("/") + "/snapshot.json"
            name = replica or src

            def fetch(url=url):
                with urllib.request.urlopen(
                        url, timeout=self.timeout) as resp:
                    return json.loads(resp.read().decode())
        elif isinstance(src, str):
            name = replica or src

            def fetch(path=src):
                with open(path) as f:
                    return json.load(f)
        elif callable(getattr(src, "snapshot", None)):
            # a MetricsRegistry, MetricsServer, or anything else
            # exposing snapshot() (wrap_snapshot stamps raw dicts)
            name = replica if replica is not None else \
                f"replica{len(self._sources)}"

            def fetch(obj=src):
                return obj.snapshot()
        elif callable(src):
            name = replica if replica is not None else \
                f"replica{len(self._sources)}"
            fetch = src
        else:
            raise TypeError(f"unsupported source {src!r}")
        with self._lock:
            self._sources.append((str(name), fetch))
        return str(name)

    def collect(self):
        """Fetch every source; returns the list of wrapped snapshots
        (failed sources skipped, error recorded — bounded to
        ``max_errors`` entries of truncated reprs)."""
        with self._lock:
            sources = list(self._sources)
        snaps, errors = [], {}
        for name, fetch in sources:
            try:
                snaps.append(wrap_snapshot(fetch(), replica=name))
            except Exception as e:
                if len(errors) < self.max_errors:
                    errors[name] = repr(e)[:512]
        self.last_errors = errors
        self.sources_ok = len(snaps)
        self.sources_total = len(sources)
        return snaps

    def aggregate(self):
        """Pull + merge; returns (and caches) the fleet snapshot,
        stamped with ``fleet_sources_ok`` / ``fleet_sources_total``
        gauges: a replica dying silently shows up as
        ok < total in the FLEET view itself — the reader of the
        merged numbers learns they are partial without consulting the
        aggregator's process state."""
        fleet = aggregate_snapshots(self.collect(),
                                    fleet_name=self.fleet_name)
        labels = {"fleet": self.fleet_name}
        fleet.setdefault("metrics", {})
        fleet["metrics"]["fleet_sources_ok"] = {
            "type": "gauge",
            "help": "sources that answered the last fleet collect "
                    "(ok < total means the merged numbers are "
                    "PARTIAL — a replica is dead or unreachable)",
            "series": [{"labels": dict(labels),
                        "value": self.sources_ok}]}
        fleet["metrics"]["fleet_sources_total"] = {
            "type": "gauge",
            "help": "sources the last fleet collect asked",
            "series": [{"labels": dict(labels),
                        "value": self.sources_total}]}
        fleet["sources_ok"] = self.sources_ok
        fleet["sources_total"] = self.sources_total
        with self._lock:
            self._fleet = fleet
        return fleet

    # registry-duck-typed re-export surface --------------------------------
    def snapshot(self):
        return self.aggregate()

    def expose_text(self):
        return fleet_expose_text(self.aggregate())

    # router-facing scale-signal reads -------------------------------------
    def _family(self, name, fleet=None):
        fleet = fleet if fleet is not None else \
            (self._fleet or self.aggregate())
        return (fleet.get("metrics") or {}).get(name)

    def total(self, name, labels=None, refresh=False):
        """Summed value of a counter/gauge family's series matching
        ``labels`` (None = all series). Uses the cached fleet view
        unless ``refresh``."""
        fam = self._family(name, self.aggregate() if refresh else None)
        if fam is None:
            return 0.0
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        return sum(_num(s["value"]) for s in fam["series"]
                   if all(s["labels"].get(k) == v
                          for k, v in want.items()))

    def quantile(self, name, q, labels=None, refresh=False):
        """Merged-histogram quantile over every series of ``name``
        matching ``labels`` — the fleet p99 is computed over the
        SUMMED buckets, not averaged per-replica quantiles.

        Returns ``None`` when the merged count is 0 (family missing,
        no matching series, or no observations yet): "no samples" is
        NOT "all fast" — an autoscaler or SLO engine reading an empty
        histogram as a perfect p99 of 0.0 would scale in on silence."""
        fam = self._family(name, self.aggregate() if refresh else None)
        if fam is None or fam["type"] != "histogram":
            return None
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        buckets, count = {}, 0
        for s in fam["series"]:
            if not all(s["labels"].get(k) == v
                       for k, v in want.items()):
                continue
            for le, c in s["buckets"].items():
                buckets[le] = buckets.get(le, 0) + int(c)
            count += int(s["count"])
        if not buckets or count <= 0:
            return None
        return merged_quantile(buckets, count, q)
