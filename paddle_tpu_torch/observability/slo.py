"""Tenant SLO burn rates and the serving watchdog — the port's own copy
of ``paddle_tpu/observability/slo.py`` (which has no JAX in it; the port
imports nothing of ``paddle_tpu``).

The ledger and the cost attribution say what a tenant's traffic costs;
this module says whether its experience is healthy, and notices the
serving-quality regressions a latency histogram alone hides:

- :class:`SLOSpec` — a declarative per-tenant / per-tier objective:
  TTFT p99, per-token latency p99, a goodput fraction and/or a success
  fraction, each with an error budget implied by the quantile (p99 =>
  1% budget) or the target fraction.
- :class:`SLOEngine` — evaluates the specs as **multi-window burn
  rates** from the registry's histograms and counters
  (``serving_tenant_ttft_seconds`` / ``serving_tenant_token_latency_
  seconds`` / ``serving_tenant_goodput_tokens_total`` /
  ``serving_tenant_requests_total`` for tenants,
  ``serving_goodput_tokens_total{tier}`` for priority tiers): burn =
  (observed error rate) / (error budget rate) over each configured
  window from snapshot deltas, alerting only when EVERY window burns
  past the threshold (the fast+slow multiwindow rule: a blip does not
  page, a sustained violation does). Exports
  ``serving_slo_burn_rate{slo,window}`` / ``serving_slo_healthy{slo}``
  gauges and a ``serving_slo_alerts_total{slo}`` counter, and stamps an
  ``slo_alert`` decision trace (triggering series, window, threshold,
  burn rate, the worst request anatomies as exemplars). The source is
  anything with ``snapshot()`` (a MetricsRegistry or a MetricsServer);
  ``clock=`` replaces the monotonic clock, so a step clock gives the
  same burn rates from run to run.
- :class:`ServingWatchdog` — between engine steps (host arithmetic on
  the step boundary: no dispatch, no capture) it watches windowed
  deltas of the spec-acceptance rate, the prefix-cache hit rate, the
  measured quantization logit error and page-pool thrash (preemptions +
  prefix-cache evictions a step) against **rolling baselines** learned
  from the stream itself. A collapse (below ``collapse_frac`` of the
  baseline) or a spike (above ``spike_factor`` x the baseline) fires the
  flight-recorder postmortems of every registered tracer
  (``tracing.dump_all_postmortems``), bumps
  ``serving_watchdog_trips_total{kind}`` and stamps a ``watchdog``
  decision trace naming the triggering series, window, threshold,
  observed value and baseline.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass

__all__ = ["SLOSpec", "SLOEngine", "ServingWatchdog",
           "WATCHDOG_KINDS"]


def _parse_le(s):
    return float("inf") if s == "+Inf" else float(s)


def _num(v):
    if isinstance(v, str):
        return {"NaN": float("nan"), "+Inf": float("inf"),
                "-Inf": float("-inf")}.get(v, float(v))
    return float(v)


@dataclass(frozen=True)
class SLOSpec:
    """One declarative SLO. Objectives (set at least one):

    - ``ttft_p99_s`` — 99% of the tenant's requests must see first
      token within this many seconds (error budget 1%),
    - ``token_p99_s`` — 99% of the tenant's tokens within this
      per-token latency,
    - ``goodput_frac`` — at least this fraction of the selected
      traffic's tokens must be goodput (eos/length completions),
    - ``success_frac`` — at least this fraction of the tenant's
      FINISHED requests must end eos/length (a shed or deadline
      casualty emits few or no tokens, so token-denominated
      objectives cannot see it — this one counts requests, the
      signal that burns when admission control is eating a tenant).

    ``tenant`` selects the ``serving_tenant_*`` series; ``tier``
    selects the per-priority-tier goodput counters — latency
    and success objectives need a tenant, the goodput objective
    takes either.
    ``windows`` are the multi-window burn horizons in seconds (alert
    only when EVERY window burns past ``burn_threshold``);
    ``min_count`` is the traffic floor below which a window reads
    burn 0 (no traffic is not an outage)."""
    name: str
    tenant: str = None
    tier: str = None
    ttft_p99_s: float = None
    token_p99_s: float = None
    goodput_frac: float = None
    success_frac: float = None
    windows: tuple = (5.0, 30.0)
    burn_threshold: float = 2.0
    min_count: int = 4

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLOSpec needs a name")
        objs = [self.ttft_p99_s, self.token_p99_s, self.goodput_frac,
                self.success_frac]
        if all(o is None for o in objs):
            raise ValueError(
                f"SLO {self.name!r}: set at least one objective "
                "(ttft_p99_s / token_p99_s / goodput_frac / "
                "success_frac)")
        if (self.ttft_p99_s is not None or self.token_p99_s is not None
                or self.success_frac is not None) and not self.tenant:
            raise ValueError(
                f"SLO {self.name!r}: latency/success objectives are "
                "evaluated from the serving_tenant_* series — set "
                "tenant=")
        for frac in (self.goodput_frac, self.success_frac):
            if frac is not None and not 0.0 < float(frac) < 1.0:
                raise ValueError(
                    f"SLO {self.name!r}: fraction objectives must be "
                    f"in (0, 1), got {frac}")
        if self.goodput_frac is not None \
                and not (self.tenant or self.tier):
            raise ValueError(
                f"SLO {self.name!r}: goodput_frac needs tenant= "
                "or tier=")
        for o in (self.ttft_p99_s, self.token_p99_s):
            if o is not None and float(o) <= 0:
                raise ValueError(
                    f"SLO {self.name!r}: latency objectives must be "
                    f"> 0, got {o}")
        if not self.windows or \
                any(float(w) <= 0 for w in self.windows):
            raise ValueError(
                f"SLO {self.name!r}: windows must be positive "
                f"seconds, got {self.windows}")
        if float(self.burn_threshold) <= 0:
            raise ValueError(
                f"SLO {self.name!r}: burn_threshold must be > 0")

    def objectives(self):
        out = []
        if self.ttft_p99_s is not None:
            out.append(("ttft_p99", "serving_tenant_ttft_seconds",
                        float(self.ttft_p99_s)))
        if self.token_p99_s is not None:
            out.append(("token_p99",
                        "serving_tenant_token_latency_seconds",
                        float(self.token_p99_s)))
        if self.goodput_frac is not None:
            out.append(("goodput_frac", None,
                        float(self.goodput_frac)))
        if self.success_frac is not None:
            out.append(("success_frac",
                        "serving_tenant_requests_total",
                        float(self.success_frac)))
        return out


def _series(metrics, family, want_labels):
    fam = (metrics or {}).get(family)
    if fam is None:
        return []
    want = {str(k): str(v) for k, v in want_labels.items()}
    return [s for s in fam.get("series", [])
            if all(s.get("labels", {}).get(k) == v
                   for k, v in want.items())]


def _hist_delta(cur, old, family, labels):
    """(count_delta, {le: cum_delta}) of a histogram family's series
    matching ``labels`` between two snapshots (series summed — on a
    fleet snapshot that is the exact merged histogram)."""
    buckets, count = {}, 0
    for snap, sign in ((cur, 1), (old, -1)):
        for s in _series(snap, family, labels):
            count += sign * int(s.get("count", 0))
            for le, c in (s.get("buckets") or {}).items():
                buckets[le] = buckets.get(le, 0) + sign * int(c)
    return count, buckets


def _counter_delta(cur, old, family, labels):
    tot = 0.0
    for snap, sign in ((cur, 1), (old, -1)):
        for s in _series(snap, family, labels):
            tot += sign * _num(s.get("value", 0))
    return tot


def _frac_over(count, buckets, threshold_s):
    """Fraction of a histogram delta's observations ABOVE
    ``threshold_s``, using the smallest bucket bound >= the threshold
    (the objective effectively snaps to the next boundary — pick SLO
    targets on (or near) bucket bounds for exact accounting)."""
    if count <= 0:
        return 0.0
    bounds = sorted((_parse_le(le), le) for le in buckets)
    below = count  # +Inf bucket == count
    for b, le in bounds:
        if b >= threshold_s:
            below = buckets[le]
            break
    return max(count - below, 0) / count


class SLOEngine:
    """Evaluate :class:`SLOSpec` objectives as multi-window burn
    rates over a metrics source (registry / server / fleet
    aggregator). Call :meth:`evaluate` periodically — each call takes
    one snapshot, windows it against the retained history, updates
    the ``serving_slo_*`` series, and (on an alert transition past
    the cooldown) stamps an ``slo_alert`` decision trace."""

    _ids = itertools.count()

    def __init__(self, specs, source=None, registry=None, tracer=None,
                 max_history=512, cooldown_s=10.0,
                 clock=time.monotonic, anatomy=None,
                 exemplar_k=3):
        from .registry import MetricsRegistry, get_registry
        self.specs = []
        seen = set()
        for sp in specs:
            sp = sp if isinstance(sp, SLOSpec) else SLOSpec(**sp)
            if sp.name in seen:
                raise ValueError(f"duplicate SLO name {sp.name!r}")
            seen.add(sp.name)
            self.specs.append(sp)
        if not self.specs:
            raise ValueError("SLOEngine needs at least one spec")
        self._source = source if source is not None else registry
        if self._source is None:
            self._source = get_registry()
        if registry is None:
            registry = self._source if isinstance(
                self._source, MetricsRegistry) else get_registry()
        self.registry = registry
        self._tracer = tracer
        self._clock = clock
        self._history = []          # (t, metrics dict), oldest first
        self._max_history = int(max_history)
        # the retention horizon: one snapshot at-or-older than the
        # longest configured window must survive as that window's
        # base — count-capped retention alone would silently shorten
        # the slow window at high evaluate() frequency and defeat the
        # fast+slow multiwindow rule
        self._max_window = max(float(w) for sp in self.specs
                               for w in sp.windows)
        # only the families the specs actually read are retained per
        # history entry — a fleet registry snapshot carries EVERY
        # series of every replica, and the windows would otherwise
        # hold dozens of full-registry copies for a handful of
        # tenant-histogram deltas
        fams = set()
        for sp in self.specs:
            for _, family, _ in sp.objectives():
                if family:
                    fams.add(family)
            if sp.goodput_frac is not None:
                if sp.tenant:
                    fams.update(("serving_tenant_goodput_tokens_total",
                                 "serving_tenant_tokens_total"))
                else:
                    fams.update(("serving_goodput_tokens_total",
                                 "serving_tier_tokens_total"))
        self._families = fams
        self.cooldown_s = float(cooldown_s)
        self._alert_state = {}      # name -> (alerting, last_alert_t)
        self._last_report = None
        # ``anatomy`` is a zero-arg callable returning
        # completed anatomy records (``engine.anatomy.request_records``
        # or ``router.anatomy.request_records``) — each fired alert
        # then carries the k WORST request anatomies (trace ids +
        # segment breakdown) as exemplars, so 'p99 is on fire' arrives
        # with the receipts that say why
        self._anatomy = anatomy
        self.exemplar_k = int(exemplar_k)
        self._g_burn = registry.gauge(
            "serving_slo_burn_rate",
            "SLO error-budget burn rate over each configured window "
            "(1.0 = burning budget exactly as fast as the objective "
            "allows; alerting needs EVERY window past the spec's "
            "threshold)",
            labels=("slo", "window"))
        self._g_healthy = registry.gauge(
            "serving_slo_healthy",
            "1 when the SLO is within budget on at least one window, "
            "0 while every window burns past the threshold",
            labels=("slo",))
        self._c_alerts = registry.counter(
            "serving_slo_alerts_total",
            "burn-rate alerts fired (multi-window: every window past "
            "threshold, cooldown-limited), by SLO",
            labels=("slo",))
        for sp in self.specs:
            self._c_alerts.labels(slo=sp.name).inc(0)
            self._g_healthy.labels(slo=sp.name).set(1)
            for w in sp.windows:
                self._g_burn.labels(slo=sp.name, window=str(w)).set(0)

    # -- snapshot plumbing ---------------------------------------------------
    def _snapshot(self):
        src = self._source
        doc = src.snapshot() if hasattr(src, "snapshot") else src()
        if isinstance(doc, dict) and "metrics" in doc \
                and doc.get("format"):
            doc = doc["metrics"]      # wrapped / fleet snapshot
        doc = doc or {}
        # retain only the spec-referenced families (see __init__)
        return {k: doc[k] for k in self._families if k in doc}

    def _window_base(self, now, w):
        """The history entry to diff against for window ``w``: the
        newest snapshot at least ``w`` old, else the oldest retained
        (a young engine burns over its whole life)."""
        base = self._history[0]
        for t, snap in self._history:
            if t <= now - w:
                base = (t, snap)
            else:
                break
        return base

    # -- burn math -----------------------------------------------------------
    def _objective_burn(self, spec, obj, cur, old):
        kind, family, target = obj
        if kind in ("ttft_p99", "token_p99"):
            count, buckets = _hist_delta(
                cur, old, family, {"tenant": spec.tenant})
            if count < spec.min_count:
                return 0.0, {"kind": kind, "series": family,
                             "count": count}
            err = _frac_over(count, buckets, target)
            burn = err / 0.01     # p99 => 1% error budget
            return burn, {"kind": kind, "series": family,
                          "count": count, "frac_over": err,
                          "target_s": target}
        if kind == "success_frac":
            # request-denominated: sheds/deadline casualties count in
            # full even though they emitted no tokens
            from .ledger import GOODPUT_REASONS
            good = total = 0.0
            fam = "serving_tenant_requests_total"
            for snap, sign in ((cur, 1), (old, -1)):
                for s in _series(snap, fam,
                                 {"tenant": spec.tenant}):
                    v = sign * _num(s.get("value", 0))
                    total += v
                    if s.get("labels", {}).get("outcome") \
                            in GOODPUT_REASONS:
                        good += v
            if total < spec.min_count:
                return 0.0, {"kind": kind, "series": fam,
                             "count": total}
            frac = good / total
            burn = (1.0 - frac) / (1.0 - target)
            return burn, {"kind": kind, "series": fam,
                          "count": total, "success_frac": frac,
                          "target_frac": target}
        # goodput_frac
        if spec.tenant:
            fam_good = "serving_tenant_goodput_tokens_total"
            fam_all = "serving_tenant_tokens_total"
            labels = {"tenant": spec.tenant}
        else:
            fam_good = "serving_goodput_tokens_total"
            fam_all = "serving_tier_tokens_total"
            labels = {"tier": spec.tier}
        good = _counter_delta(cur, old, fam_good, labels)
        raw = _counter_delta(cur, old, fam_all, labels)
        if raw < spec.min_count:
            return 0.0, {"kind": kind, "series": fam_good,
                         "count": raw}
        frac = good / raw
        burn = (1.0 - frac) / (1.0 - target)
        return burn, {"kind": kind, "series": fam_good, "count": raw,
                      "goodput_frac": frac, "target_frac": target}

    def evaluate(self):
        """One evaluation pass; returns (and retains for
        :meth:`report`) the per-spec burn/alert state."""
        now = self._clock()
        cur = self._snapshot()
        self._history.append((now, cur))
        # time-based trim: keep the NEWEST entry at least max_window
        # old (the slow window's base) and everything after it
        cut = 0
        for i, (t, _) in enumerate(self._history):
            if t <= now - self._max_window:
                cut = i
            else:
                break
        if cut:
            self._history = self._history[cut:]
        if len(self._history) > self._max_history:
            # memory backstop: DOWNSAMPLE the middle instead of
            # dropping the oldest — the base of the slow window must
            # survive; window bases lose granularity, never reach
            keep = [self._history[0]]
            rest = self._history[1:]
            stride = -(-len(rest) // max(self._max_history - 1, 1))
            keep.extend(rest[::stride])
            if keep[-1] is not self._history[-1]:
                keep.append(self._history[-1])
            self._history = keep
        out = []
        for spec in self.specs:
            windows = {}
            worst = None
            for w in spec.windows:
                t0, old = self._window_base(now, float(w))
                burn = 0.0
                for obj in spec.objectives():
                    b, detail = self._objective_burn(
                        spec, obj, cur, old)
                    if b >= burn:
                        burn = b
                        if worst is None or b >= worst[0]:
                            worst = (b, detail, float(w))
                windows[float(w)] = burn
                self._g_burn.labels(slo=spec.name,
                                    window=str(w)).set(burn)
            alerting = all(b >= spec.burn_threshold
                           for b in windows.values())
            self._g_healthy.labels(slo=spec.name).set(
                0 if alerting else 1)
            was, last_t = self._alert_state.get(spec.name,
                                                (False, None))
            fired = False
            if alerting and (not was) and (
                    last_t is None
                    or now - last_t >= self.cooldown_s):
                fired = True
                self._c_alerts.labels(slo=spec.name).inc()
                self._alert_state[spec.name] = (True, now)
                self._stamp_alert(spec, windows, worst)
            elif not alerting:
                self._alert_state[spec.name] = (False, last_t)
            rec = {"slo": spec.name, "tenant": spec.tenant,
                   "tier": spec.tier,
                   "burn": {str(w): b for w, b in windows.items()},
                   "threshold": spec.burn_threshold,
                   "alerting": alerting, "fired": fired,
                   "worst": None if worst is None else {
                       "burn": worst[0], "window_s": worst[2],
                       **worst[1]}}
            out.append(rec)
        self._last_report = {"ts": time.time(), "slos": out}
        return out

    def exemplars(self, spec=None):
        """The k worst request anatomies for ``spec``'s tenant (all
        tenants when ``spec`` is None or tenant-less) — empty without
        an anatomy source."""
        if self._anatomy is None:
            return []
        from .anatomy import exemplars as _exemplars
        try:
            recs = self._anatomy()
        except Exception:
            return []
        tenant = spec.tenant if spec is not None else None
        ex = _exemplars(recs, k=self.exemplar_k, tenant=tenant)
        if not ex and tenant is not None:
            # the burning tenant has no completed anatomy yet — the
            # fleet-wide worst are still better receipts than none
            ex = _exemplars(recs, k=self.exemplar_k)
        return ex

    def _stamp_alert(self, spec, windows, worst):
        """The ``slo_alert`` decision trace (schema validated by
        tools/trace_check.py): triggering series, window, threshold
        and burn rate as attrs — plus the exemplars (the k
        worst request anatomies: trace ids + segment breakdown)."""
        if self._tracer is None:
            return
        burn, detail, win = worst if worst is not None \
            else (0.0, {"series": ""}, 0.0)
        try:
            tid = f"slo:{spec.name}:{next(SLOEngine._ids)}"
            self._tracer.start_trace(
                "slo_alert", trace_id=tid, slo=spec.name,
                tenant=spec.tenant or "", tier=spec.tier or "",
                series=detail.get("series") or "",
                window_s=win, threshold=spec.burn_threshold,
                burn_rate=burn,
                burn_by_window={str(w): b
                                for w, b in windows.items()},
                objective=detail.get("kind", ""),
                exemplars=self.exemplars(spec))
            self._tracer.end_trace(tid)
        except Exception:
            pass   # an alerting bug must never take down serving

    def report(self):
        """The /slo.json payload: declared specs + the last
        evaluation (evaluates once if never evaluated)."""
        if self._last_report is None:
            self.evaluate()
        return {
            "specs": [{
                "name": sp.name, "tenant": sp.tenant, "tier": sp.tier,
                "ttft_p99_s": sp.ttft_p99_s,
                "token_p99_s": sp.token_p99_s,
                "goodput_frac": sp.goodput_frac,
                "success_frac": sp.success_frac,
                "windows": list(sp.windows),
                "burn_threshold": sp.burn_threshold}
                for sp in self.specs],
            "exemplars": self.exemplars(),
            **self._last_report}


# ---------------------------------------------------------------------------

WATCHDOG_KINDS = ("spec_accept", "prefix_hit", "quant_logit_err",
                  "page_thrash")

# the registry series each watchdog kind is derived from — stamped on
# the decision trace so a postmortem reader knows what to plot
_WATCHDOG_SERIES = {
    "spec_accept": "serving_spec_tokens_total",
    "prefix_hit": "serving_prefix_cache_hits_total",
    "quant_logit_err": "serving_quant_logit_err",
    "page_thrash": "serving_preemptions_total",
}


class ServingWatchdog:
    """Rolling-baseline anomaly detection over a live engine's
    serving-quality signals. ``observe(engine)``
    rides the engine's step boundary (the engine calls it when
    constructed with ``watchdog=``); every ``interval_steps`` steps it
    computes windowed deltas of the watched signals and compares each
    against a baseline learned from the stream itself (EMA over
    healthy windows — :meth:`seed_baseline` lets a harness or a
    deploy bootstrap one deterministically):

    - ``spec_accept`` — draft acceptance rate; trips when a window
      falls below ``collapse_frac`` x baseline (the draft has
      diverged from the target: speculation is now pure overhead),
    - ``prefix_hit`` — prefix-cache page hit rate; same collapse rule
      (an affinity regression or cache-sizing bug),
    - ``quant_logit_err`` — the measured quantization logit error
      (``serving_quant_logit_err``, harness-published); trips above
      ``spike_factor`` x max(baseline, ``spike_floor``),
    - ``page_thrash`` — preemptions + prefix-cache evictions per
      step; same spike rule (the pool is churning instead of
      serving).

    A trip fires every registered flight recorder
    (``tracing.dump_all_postmortems(reason="watchdog:<kind>")``),
    bumps ``serving_watchdog_trips_total{kind}`` and stamps a
    ``watchdog`` decision trace with the triggering series/window/
    threshold/value/baseline. Per-kind cooldown stops a sustained
    anomaly from re-firing every window."""

    _ids = itertools.count()

    def __init__(self, registry=None, tracer=None, interval_steps=8,
                 collapse_frac=0.5, spike_factor=3.0, min_samples=16,
                 min_events=4, baseline_alpha=0.3, spike_floor=0.02,
                 cooldown_steps=64, postmortem=True):
        from .registry import get_registry
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        self._tracer = tracer
        self.interval_steps = int(interval_steps)
        self.collapse_frac = float(collapse_frac)
        self.spike_factor = float(spike_factor)
        self.min_samples = int(min_samples)
        self.min_events = int(min_events)
        self.baseline_alpha = float(baseline_alpha)
        self.spike_floor = float(spike_floor)
        self.cooldown_steps = int(cooldown_steps)
        self.postmortem = bool(postmortem)
        # window/cooldown state is PER ENGINE (one watchdog may be
        # shared across engines — deltas must never mix two engines'
        # counters); the learned baselines are deliberately shared:
        # a healthy acceptance/hit rate is a property of the model +
        # traffic, and a fleet-shared baseline is the point of
        # sharing the instance
        self._last = {}                    # engine_id -> stats snap
        self._baseline = {}
        self._cooldown = {}                # (engine_id, kind) -> step
        # bounded like every sibling store (ledger's completed ring,
        # the aggregator's max_errors): a chronically degraded signal
        # trips every cooldown window forever, and each trip retains
        # postmortem path lists — an unbounded list is a slow leak
        self.trips = deque(maxlen=256)     # trip dicts, for harnesses
        self._c_trips = reg.counter(
            "serving_watchdog_trips_total",
            "serving-watchdog anomaly trips by kind (spec-acceptance "
            "collapse / prefix-hit collapse / quant-logit-err drift / "
            "page-pool thrash); each fires the registered flight "
            "recorders and stamps a watchdog decision trace",
            labels=("kind",))
        for k in WATCHDOG_KINDS:
            self._c_trips.labels(kind=k).inc(0)
        self._g_value = reg.gauge(
            "serving_watchdog_value",
            "last windowed value of each watched serving-quality "
            "signal",
            labels=("kind",))
        self._g_baseline = reg.gauge(
            "serving_watchdog_baseline",
            "rolling healthy baseline of each watched signal (EMA "
            "over non-anomalous windows)",
            labels=("kind",))

    def seed_baseline(self, kind, value):
        """Bootstrap a healthy baseline deterministically (what a
        deploy that knows its steady-state acceptance/hit rate does —
        and what tests use to force a trip without minutes of
        warmup). Returns the value."""
        if kind not in WATCHDOG_KINDS:
            raise ValueError(f"unknown watchdog kind {kind!r} "
                             f"(one of {WATCHDOG_KINDS})")
        self._baseline[kind] = float(value)
        self._g_baseline.labels(kind=kind).set(value)
        return float(value)

    # -- the step hook -------------------------------------------------------
    def _stats(self, engine):
        return {
            "steps": engine.stats["steps"],
            "spec_proposed": engine.stats["spec_proposed"],
            "spec_accepted": engine.stats["spec_accepted"],
            "prefix_hits": engine.stats["prefix_hits"],
            "prefix_misses": engine.stats["prefix_misses"],
            "preemptions": engine.stats["preemptions"],
            "evictions": engine.kv.cache_stats["evictions"],
        }

    def observe(self, engine):
        """One watchdog pass (cheap host arithmetic; a no-op until
        ``interval_steps`` engine steps have elapsed since this
        ENGINE's last pass — per-engine windows, shared baselines)."""
        eid = engine.engine_id
        cur = self._stats(engine)
        last = self._last.get(eid)
        if last is None:
            self._last[eid] = cur
            return []
        d = {k: cur[k] - last[k] for k in cur}
        if d["steps"] < self.interval_steps:
            return []
        self._last[eid] = cur
        fired = []
        if d["spec_proposed"] >= self.min_samples:
            r = d["spec_accepted"] / d["spec_proposed"]
            t = self._check_low("spec_accept", r, d["steps"], engine)
            if t:
                fired.append(t)
        pages = d["prefix_hits"] + d["prefix_misses"]
        if pages >= self.min_samples:
            r = d["prefix_hits"] / pages
            t = self._check_low("prefix_hit", r, d["steps"], engine)
            if t:
                fired.append(t)
        err = self._quant_err()
        if err is not None:
            t = self._check_high("quant_logit_err", err, d["steps"],
                                 engine)
            if t:
                fired.append(t)
        events = d["preemptions"] + d["evictions"]
        rate = events / max(d["steps"], 1)
        if events >= self.min_events:
            t = self._check_high("page_thrash", rate, d["steps"],
                                 engine)
            if t:
                fired.append(t)
        else:
            # calm window: the thrash baseline learns the quiet rate
            self._learn("page_thrash", rate)
        return fired

    def _quant_err(self):
        fam = self.registry.get("serving_quant_logit_err")
        if fam is None:
            return None
        vals = [s.value for _, s in fam.series_items()]
        return max(vals) if vals else None

    def _learn(self, kind, value):
        b = self._baseline.get(kind)
        a = self.baseline_alpha
        b = value if b is None else (1 - a) * b + a * value
        self._baseline[kind] = b
        self._g_baseline.labels(kind=kind).set(b)
        self._g_value.labels(kind=kind).set(value)

    def _check_low(self, kind, value, window_steps, engine):
        """Collapse detector: trip when the windowed rate falls below
        ``collapse_frac`` of the rolling baseline; healthy windows
        feed the baseline EMA instead."""
        b = self._baseline.get(kind)
        if b is None:
            self._learn(kind, value)
            return None
        threshold = self.collapse_frac * b
        if value < threshold:
            self._g_value.labels(kind=kind).set(value)
            return self._trip(kind, value, b, threshold,
                              window_steps, engine)
        self._learn(kind, value)
        return None

    def _check_high(self, kind, value, window_steps, engine):
        """Spike detector: trip above ``spike_factor`` x
        max(baseline, ``spike_floor``) — the floor stops a pristine
        zero baseline from paging on the first nonzero reading."""
        b = self._baseline.get(kind)
        if b is None:
            self._learn(kind, value)
            return None
        threshold = self.spike_factor * max(b, self.spike_floor)
        if value > threshold:
            self._g_value.labels(kind=kind).set(value)
            return self._trip(kind, value, b, threshold,
                              window_steps, engine)
        self._learn(kind, value)
        return None

    def _trip(self, kind, value, baseline, threshold, window_steps,
              engine):
        steps = engine.stats["steps"]
        key = (engine.engine_id, kind)
        last = self._cooldown.get(key)
        if last is not None and steps - last < self.cooldown_steps:
            return None
        self._cooldown[key] = steps
        self._c_trips.labels(kind=kind).inc()
        paths = []
        if self.postmortem:
            from . import tracing as _tracing
            paths = _tracing.dump_all_postmortems(
                reason=f"watchdog:{kind}")
        trip = {"kind": kind, "series": _WATCHDOG_SERIES[kind],
                "value": float(value), "baseline": float(baseline),
                "threshold": float(threshold),
                "window_steps": int(window_steps),
                "engine": engine.engine_id,
                "postmortems": list(paths)}
        self.trips.append(trip)
        tracer = self._tracer
        if tracer is not None:
            try:
                tid = f"wd:{engine.engine_id}:" \
                      f"{next(ServingWatchdog._ids)}"
                tracer.start_trace(
                    "watchdog", trace_id=tid, kind=kind,
                    series=trip["series"], value=trip["value"],
                    baseline=trip["baseline"],
                    threshold=trip["threshold"],
                    window_steps=trip["window_steps"],
                    engine=engine.engine_id,
                    postmortems=len(paths))
                tracer.end_trace(tid)
            except Exception:
                pass   # a watchdog bug must never take down serving
        return trip
