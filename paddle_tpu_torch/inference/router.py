"""The fleet router — the port's own copy of
``paddle_tpu/inference/router.py`` (host code, no JAX in either; the port
imports nothing of ``paddle_tpu``): N serving engines, one service.

The router is pure policy over the signals the engines export, and its
admission tier IS ``inference/scheduler.py``'s :class:`RequestQueue`
(same ordering, same shed policies — the engine and the fleet turn
overload into explicit decisions with one mechanism).

Four capabilities:

- **Prefix-affinity placement.** Each submitted prompt is digested
  with the SAME chained-blake2b page scheme ``PagedKVCache`` registers
  (``serving._page_digests``), and every placement records
  ``digest -> replica``. A later prompt sharing a page-aligned prefix
  routes to the replica whose cache already holds it (longest match
  wins), so a shared system prompt's prefill saving multiplies across
  the fleet instead of diluting 1/N. Affinity falls back to
  least-loaded — ``(queue_depth, -free_pages)`` over the live
  replicas — when the map is cold or the target is saturated
  (``queue_depth >= saturation_depth``).
- **Cross-replica preemption.** When the queue head outranks running
  work but no live replica can take it, the router picks the
  lowest-value victim across the WHOLE fleet — strictly lower
  priority first, then the tenant with the lowest SLO burn rate (most
  error budget left: evicting it does the least SLO damage; one
  fleet-level burn per tenant via ``SLOEngine(source=FleetAggregator)``),
  then the latest arrival (least sunk cost) — ejects it through
  :meth:`ServingEngine.eject` (the preemption path: emitted tokens and
  the slot's generator state ride along), places the high-tier request
  on the freed replica, and requeues the victim for re-placement
  elsewhere. The migrated continuation resumes through a prefill of the
  prompt plus the emitted tokens, the same machinery as same-engine
  preempt/resume.
- **Drain / join.** ``drain(name)`` stops new placements, requeues the
  replica's QUEUED work through the router, and lets in-flight work
  finish (status ``draining`` -> ``drained`` when empty); ``join()``
  adds capacity live. Both are decision traces in the merged timeline;
  the aggregated queue-depth/goodput signals that should drive them
  are served by :meth:`scale_signals`.
- **Replica-death survival.** A replica whose ``step()`` raises — any
  exception: ``FaultInjector``'s ``replica_down`` is the deterministic
  driver, but a failing kernel launch inside one replica counts the
  same, so the ``replica_dead`` journal event and decision trace carry
  the exception as their ``reason``, and :attr:`FleetRouter.deaths`
  keeps every death's replica, step and reason, journal or not — or
  whose metrics source goes
  stale in :meth:`poll_health` (``fleet_sources_ok <
  fleet_sources_total``) is marked dead; every request placed on it is
  requeued and re-placed from scratch. Engines are deterministic given
  (prompt, seed, temperature), so the rerun's output is token-identical
  to an unfailed run, greedy and fixed-seed sampled alike.

Every decision is a span in the merged Perfetto timeline: ``route``
spans (chosen replica, affinity digest, candidate scores) live on the
per-request ``routed_request`` trace and their injected context
parents the engine-side request trace under them (cross-process link,
validated by ``tools/trace_check.py``); ``preempt_remote`` spans name
the victim; ``drain`` / ``join`` / ``replica_dead`` are fleet-level
decision traces.

On one card: the reference puts one replica on each chip. Here N
captured engines share one card; each has its own KV pool and CUDA-graph
pool, and engines built from one parameter dict share its weight
tensors (``ServingEngine`` moves params with ``.to(...)``, which copies
nothing already on the device in the dtype). :meth:`FleetRouter.step`
steps the replicas one after another on the one stream, as the
reference steps them.
"""
from __future__ import annotations

import itertools
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np

from .scheduler import QueueFullError, RequestQueue
from .serving import Completion, Request, _page_digests

__all__ = ["ReplicaDeadError", "EngineReplica", "FleetRouter",
           "ROUTE_DECISIONS", "REPLICA_STATES"]

ROUTE_DECISIONS = ("affinity", "least_loaded", "preempt_remote",
                   "random")
REPLICA_STATES = ("live", "draining", "drained", "dead")


class ReplicaDeadError(RuntimeError):
    """Raised by a dead replica's gated aggregator source — the fleet
    view then shows ``fleet_sources_ok < fleet_sources_total`` for
    exactly the replicas the router has stopped routing to."""


class EngineReplica:
    """The router-facing surface of ONE serving replica, wrapping an
    in-process :class:`ServingEngine` (test determinism: no RPC in the
    loop). A real deployment duck-types this exact surface over
    ``add_request``-shaped RPCs: ``add_request(**kw) -> uid``,
    ``admit_migrated(req, trace_ctx=) -> uid``, ``eject(uid) -> req``,
    ``cancel(uid)``, ``step() -> [Completion]``, ``inflight()``,
    ``queue_depth`` / ``free_pages`` / ``num_slots`` / ``has_work``,
    ``snapshot()`` (the aggregator source) and ``close()``.

    Weights: the reference fetches a weights pytree once, caches it and
    hands it to every ``engine.step(params)``. The port's engine holds
    its weights — a captured engine's graphs read its own weight tensors
    — so :meth:`step` calls ``engine.step()``. A weight publish writes
    into those tensors in place; :meth:`refresh_params` stays on the
    surface for callers of the reference's, with nothing to drop."""

    def __init__(self, engine, name):
        self.engine = engine
        self.name = str(name)

    def refresh_params(self):
        """No-op in the port: the engine serves its own weight tensors,
        so nothing is cached here (see the class docstring)."""

    # -- request plumbing ----------------------------------------------------
    def add_request(self, **kw):
        return self.engine.add_request(**kw)

    def admit_migrated(self, req, trace_ctx=None):
        return self.engine.admit_migrated(req, trace_ctx=trace_ctx)

    def eject(self, uid):
        return self.engine.eject(uid)

    def cancel(self, uid):
        return self.engine.cancel(uid)

    def step(self):
        return self.engine.step()

    def inflight(self):
        return self.engine.inflight()

    # -- load signals --------------------------------------------------------
    @property
    def queue_depth(self):
        return self.engine.queue_depth

    @property
    def free_pages(self):
        return self.engine.free_pages

    @property
    def num_slots(self):
        return self.engine.num_slots

    @property
    def page_size(self):
        return self.engine.page_size

    @property
    def has_work(self):
        return self.engine.has_work

    def snapshot(self):
        return self.engine.metrics.snapshot()

    def close(self):
        self.engine.close()


@dataclass
class _RouterRequest:
    """The router's shadow record of one submitted request — enough to
    re-place it from scratch after a replica death (determinism makes
    the rerun token-identical) or resume it after a migration."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    eos_id: object              # None or int (add_request convention)
    seed: int
    priority: int
    deadline_s: object
    tenant: str
    seq: int
    digests: tuple
    t_submit: float
    trace_id: str = ""
    replica: object = None      # name of the current placement
    engine_uid: object = None
    migrations: int = 0         # cross-replica moves (preempt/drain/death)
    affinity_hit: object = None  # first placement: landed on an affine
    #                              replica? (None until placed)
    resume: object = None       # ejected engine Request (mid-flight state)
    cancel_requested: bool = False  # a cancel must survive migration


@dataclass
class _ReplicaState:
    handle: object
    name: str
    status: str = "live"        # one of REPLICA_STATES


class FleetRouter:
    """Front N serving replicas as one service (module docstring has
    the policy story).

    >>> router = FleetRouter([EngineReplica(e0, "r0"),
    ...                       EngineReplica(e1, "r1")],
    ...                      registry=reg, tracer=Tracer("router"))
    >>> uid = router.submit(prompt, 32, priority=2, tenant="gold")
    >>> done = router.run()          # or step() in a serving loop

    ``policy`` — ``"affinity"`` (the default: prefix-affinity with
    least-loaded fallback) or ``"random"`` (uniform placement — the
    bench baseline affinity hit-rates are scored against).
    ``saturation_depth`` — an affinity target with this many queued
    requests is considered saturated and the request falls back to
    least-loaded (None: 2x the replica's slot count). ``slo`` — an
    ``SLOEngine`` (ideally over this router's aggregator) whose
    per-tenant burn rates order preemption victims."""

    def __init__(self, replicas=(), registry=None, tracer=None,
                 max_queue=None, shed_policy="reject",
                 policy="affinity", saturation_depth=None,
                 dispatch_lookahead=4, preemption=True,
                 aggregator=None, slo=None, name="router0", seed=0,
                 affinity_capacity=65536, journal=None):
        from .scheduler import SHED_POLICIES
        from ..observability.aggregate import FleetAggregator
        from ..observability.registry import get_registry
        if policy not in ("affinity", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed_policy!r}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.name = str(name)
        self.policy = policy
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.saturation_depth = saturation_depth
        self.dispatch_lookahead = int(dispatch_lookahead)
        self.preemption = bool(preemption)
        self.metrics = registry if registry is not None \
            else get_registry()
        self._tracer = tracer
        self.slo = slo
        self.aggregator = aggregator if aggregator is not None \
            else FleetAggregator(fleet_name=self.name)
        self._agg_sources = set()   # replica names already added
        self.page_size = None       # set by the first join()
        self.replicas = {}          # name -> _ReplicaState
        self._queue = RequestQueue()
        self._requests = {}         # router uid -> _RouterRequest
        self._by_engine = {}        # (replica, engine uid) -> router uid
        # page digest -> replica name, LRU-bounded: high-entropy
        # traffic would otherwise grow one entry per request-page
        # forever. The map is a HINT — evicting (or an engine-side
        # cache eviction making an entry stale) costs one ordinary
        # cache miss at the engine, never correctness.
        self._affinity = OrderedDict()
        self.affinity_capacity = int(affinity_capacity)
        self._early_done = []       # completions minted outside step()
        self.completed = deque(maxlen=1024)  # placement post-mortems
        self._next_uid = 0
        self._next_seq = 0
        self._ids = itertools.count()
        self._rng = np.random.RandomState(int(seed))
        self.stats = {"submitted": 0, "completed": 0, "placements": 0,
                      "affinity_hits": 0, "affinity_misses": 0,
                      "preempts_remote": 0, "requeued": 0,
                      "drains": 0, "joins": 0, "replica_deaths": 0,
                      "sheds": 0, "expired": 0, "cancelled": 0}
        # every death as it happened ({replica, step, reason, error}):
        # what a caller holds deaths against, with no journal or tracer
        self.deaths = []
        # the fleet journal: every source of external
        # nondeterminism this router consumes — arrivals, fault arms,
        # membership changes, config fingerprints — stamped with
        # ``steps_taken``, the replayable clock. ``journal`` is a
        # JournalWriter (shared) or a path (owned: closed with the
        # router).
        self.steps_taken = 0
        self._seed = int(seed)
        self._owns_journal = False
        if journal is not None and not hasattr(journal, "event"):
            from ..observability.journal import JournalWriter
            journal = JournalWriter(
                str(journal), name=f"{self.name}-journal",
                registry=self.metrics,
                meta={"recorder": "FleetRouter", "router": self.name})
            self._owns_journal = True
        self.journal = journal
        # the router's own levers are outcome-relevant too (shed /
        # saturation / preemption decide who completes at all) — they
        # ride the journal as a router-kind config event so
        # tools/replay.py rebuilds the SAME admission tier
        # latency anatomy: the fleet-level segment ledger —
        # engine runs spliced in at unplacement/completion, router-held
        # intervals (handoff / migrated / rerun) closed arithmetically
        from ..observability.anatomy import RouterAnatomy
        self.anatomy = RouterAnatomy()
        self._journal_event("config", replica=self.name, step=0,
                            fingerprint={
                                "kind": "router", "name": self.name,
                                "policy": self.policy,
                                "max_queue": self.max_queue,
                                "shed_policy": self.shed_policy,
                                "saturation_depth":
                                    self.saturation_depth,
                                "dispatch_lookahead":
                                    self.dispatch_lookahead,
                                "preemption": self.preemption,
                                "seed": self._seed,
                                "affinity_capacity":
                                    self.affinity_capacity})
        self._init_metrics()
        for r in replicas:
            self.join(r)

    def _journal_event(self, kind, **fields):
        """Recording never breaks serving — same contract as traces."""
        if self.journal is None:
            return
        try:
            self.journal.event(kind, **fields)
        except Exception:
            pass

    # -- telemetry -----------------------------------------------------------
    def _init_metrics(self):
        reg = self.metrics
        self._m_requests = reg.counter(
            "router_requests_total",
            "requests placed on a replica, by routing decision",
            labels=("replica", "decision"))
        self._m_aff_hits = reg.counter(
            "router_affinity_hits_total",
            "first placements that landed on a replica already "
            "holding one of the prompt's page digests")
        self._m_aff_miss = reg.counter(
            "router_affinity_misses_total",
            "first placements with no usable affinity (cold prefix "
            "or saturated/dead target)")
        self._g_qdepth = reg.gauge(
            "router_replica_queue_depth",
            "per-replica engine queue depth as last read by the router",
            labels=("replica",))
        self._g_fpages = reg.gauge(
            "router_replica_free_pages",
            "per-replica claimable KV pages as last read by the router",
            labels=("replica",))
        self._m_drains = reg.counter(
            "router_drains_total", "drain(replica) calls")
        self._m_deaths = reg.counter(
            "router_replica_deaths_total",
            "replicas marked dead (step exception or stale source)")
        self._m_requeued = reg.counter(
            "router_requeued_total",
            "requests pulled back into the router queue (remote "
            "preemption, drain, replica death)")
        for m in (self._m_aff_hits, self._m_aff_miss, self._m_drains,
                  self._m_deaths, self._m_requeued):
            m.inc(0)
        # the SAME family the engines feed — the router
        # contributes the segments only it can see (router-held
        # windows); engine-side segments are observed engine-side
        from ..observability.anatomy import (ROUTER_SEGMENTS,
                                             SEGMENT_STEP_BUCKETS)
        self._h_segment = reg.histogram(
            "serving_segment_steps",
            "per-request anatomy segment sizes in engine steps, by "
            "segment (all eight observed per finished request, zeros "
            "included, so counts stay comparable across segments)",
            labels=("segment",), buckets=SEGMENT_STEP_BUCKETS)
        for seg in ROUTER_SEGMENTS:
            self._h_segment.labels(segment=seg)

    def _decision_trace(self, kind, **attrs):
        """A fleet-level decision as its own completed trace (the
        slo_alert/watchdog pattern) — drain/join/replica_dead land in
        the merged timeline without a per-request trace to ride."""
        if self._tracer is None:
            return
        try:
            tid = f"{self.name}:{kind}:{next(self._ids)}"
            self._tracer.start_trace(kind, trace_id=tid, **attrs)
            self._tracer.end_trace(tid)
        except Exception:
            pass

    def _update_gauges(self, st):
        alive = st.status in ("live", "draining")
        self._g_qdepth.labels(replica=st.name).set(
            st.handle.queue_depth if alive else 0)
        self._g_fpages.labels(replica=st.name).set(
            st.handle.free_pages if alive else 0)

    # -- latency anatomy -----------------------------------------------------
    def _engine_segments(self, st, engine_uid):
        """The engine-local segment run for a placement that just
        ended: the completed engine record (eject / completion /
        post-crash teardown), falling back to extracting the live one
        (a death that never tore down). Empty for duck-typed replicas
        without an anatomy ledger."""
        eng = getattr(st.handle, "engine", st.handle)
        anat = getattr(eng, "anatomy", None)
        if anat is None:
            return ()
        try:
            segs = anat.sequence_of(engine_uid)
            if segs is None and hasattr(anat, "extract"):
                segs = anat.extract(engine_uid)
        except Exception:
            segs = None
        return segs or ()

    def _anat_finish(self, rr, outcome, engine_segments=None):
        """Close the fleet-level record and observe the router-held
        segments (engine-side segments were observed engine-side —
        the sums stay exact, nothing is counted twice)."""
        from ..observability.anatomy import ROUTER_SEGMENTS
        rec = self.anatomy.finish(rr.uid, self.steps_taken, outcome,
                                  engine_segments=engine_segments)
        for seg in ROUTER_SEGMENTS:
            self._h_segment.labels(segment=seg).observe(
                rec["totals"].get(seg, 0))
        return rec

    def anatomy_report(self):
        """The fleet latency-anatomy view — what ``MetricsServer``'s
        ``/anatomy.json`` serves under a router: every completed
        request's fleet-level segment ledger (engine runs spliced in),
        the per-tenant/per-tier decomposition, the conservation tally
        (``frac`` must read 1.0) and each replica's cumulative
        ``decode_blocked_frac``."""
        from ..observability.anatomy import summarize
        recs = self.anatomy.request_records()
        per_replica = {}
        for name, st in self.replicas.items():
            anat = getattr(getattr(st.handle, "engine", st.handle),
                           "anatomy", None)
            if anat is not None:
                per_replica[name] = {
                    "decode_blocked_frac": anat.blocked_frac(),
                    "conservation": anat.conservation_check()}
        return {"router": self.name, "records": recs,
                "summary": summarize(recs),
                "conservation": self.anatomy.conservation_check(),
                "replicas": per_replica}

    # -- membership ----------------------------------------------------------
    def join(self, target, name=None, source=None):
        """Add a replica live. ``target``: an :class:`EngineReplica`,
        a duck-typed equivalent, or a bare ``ServingEngine`` (wrapped,
        named ``r<i>`` unless ``name`` is given). ``source`` tags the
        journal event with who decided (``"autoscaler"`` joins are
        re-driven by a replayed controller, not applied from the
        schedule). Returns the name."""
        if not hasattr(target, "add_request"):
            raise TypeError(f"unsupported replica {target!r}")
        if not hasattr(target, "step") or not hasattr(target, "name"):
            # a bare ServingEngine (it has add_request/step but no
            # .name) — wrap it
            target = EngineReplica(
                target, name if name is not None
                else f"r{len(self.replicas)}")
        elif name is not None and str(name) != target.name:
            raise ValueError(
                f"replica is named {target.name!r}, join(name={name!r})")
        nm = target.name
        old = self.replicas.get(nm)
        if old is not None and old.status in ("live", "draining"):
            raise ValueError(f"replica {nm!r} already joined")
        ps = getattr(target, "page_size", None)
        if ps is not None:
            if self.page_size is None:
                self.page_size = int(ps)
            elif int(ps) != self.page_size:
                raise ValueError(
                    f"replica {nm!r} page_size {ps} != fleet's "
                    f"{self.page_size} (affinity digests are "
                    "page-aligned — mixed page sizes cannot share a "
                    "digest map)")
        self.replicas[nm] = _ReplicaState(handle=target, name=nm)
        if nm not in self._agg_sources and \
                hasattr(target, "snapshot"):
            # resolve the CURRENT state by name at fetch time: a
            # replica rejoined under a dead/drained predecessor's name
            # must be read through its NEW handle, not a closure over
            # the old state (which would re-kill it on poll_health)
            def fetch(name=nm):
                st = self.replicas[name]
                if st.status == "dead":
                    raise ReplicaDeadError(
                        f"replica {name} is dead")
                snap = st.handle.snapshot()
                # a replica sharing the ROUTER's registry would feed
                # the router's own replica-labeled gauges back into
                # the merge (the aggregator owns that label) — the
                # fleet view is the ENGINES' series
                return {k: v for k, v in snap.items()
                        if not k.startswith("router_")}

            self.aggregator.add_source(fetch, replica=nm)
            self._agg_sources.add(nm)
        for d in ROUTE_DECISIONS:
            self._m_requests.labels(replica=nm, decision=d).inc(0)
        self._update_gauges(self.replicas[nm])
        self.stats["joins"] += 1
        self._decision_trace("join", replica=nm,
                             replicas=len(self.live_replicas()))
        if self.journal is not None:
            eng = getattr(target, "engine", target)
            fp = None
            if hasattr(eng, "config_fingerprint"):
                try:
                    fp = eng.config_fingerprint()
                except Exception:
                    fp = None
            self._journal_event("config", replica=nm,
                                step=self.steps_taken, fingerprint=fp)
            jkw = {} if source is None else {"source": str(source)}
            self._journal_event("join", replica=nm,
                                step=self.steps_taken, **jkw)
            inj = getattr(eng, "faults", None)
            if inj is not None and hasattr(inj, "bind_journal"):
                # existing ``engine.faults.inject(...)`` call sites
                # now record their arms on the router's step clock
                inj.bind_journal(self.journal,
                                 lambda: self.steps_taken, nm)
        return nm

    def live_replicas(self):
        return [st for st in self.replicas.values()
                if st.status == "live"]

    def drain(self, name, requeue_queued=True, source=None):
        """Stop placing on ``name``: its QUEUED engine work is pulled
        back into the router (``requeue_queued``), in-flight work
        finishes where it runs, and the replica transitions
        ``draining -> drained`` once empty (checked each step).
        ``source`` tags the journal event with who decided (see
        :meth:`join`). Returns the number of requests requeued."""
        st = self.replicas[str(name)]
        if st.status != "live":
            raise ValueError(
                f"replica {name!r} is {st.status}, cannot drain")
        st.status = "draining"
        n = 0
        if requeue_queued:
            for v in [v for v in st.handle.inflight() if v["queued"]]:
                if self._requeue_from(st, v["uid"], "drain"):
                    n += 1
        self.stats["drains"] += 1
        self._m_drains.inc()
        jkw = {} if source is None else {"source": str(source)}
        self._journal_event("drain", replica=st.name,
                            step=self.steps_taken, requeued=n, **jkw)
        self._decision_trace("drain", replica=st.name, requeued=n,
                             phase="start",
                             inflight=len(st.handle.inflight()))
        if not st.handle.has_work:
            self._finish_drain(st)
        return n

    def _finish_drain(self, st):
        st.status = "drained"
        self._decision_trace("drain", replica=st.name, requeued=0,
                             phase="complete")
        self._update_gauges(st)

    def _mark_dead(self, name, reason):
        """A replica died (step exception / stale source): requeue
        every request placed on it — the deterministic rerun elsewhere
        is token-identical to an unfailed run."""
        st = self.replicas[name]
        if st.status == "dead":
            return
        st.status = "dead"
        victims = [ruid for (rep, _), ruid in self._by_engine.items()
                   if rep == name]
        for ruid in victims:
            rr = self._requests.get(ruid)
            if rr is None:
                continue
            self._by_engine.pop((name, rr.engine_uid), None)
            # splice the dead placement's engine run in and
            # open the "rerun" window. counted=True — the dying
            # engine's sweep runs before its fault check, so the death
            # step is already in the engine run (and a stale-source
            # death lands between steps, where the engine stepped
            # normally)
            self.anatomy.note_unplaced(
                ruid, self.steps_taken, "rerun",
                engine_segments=self._engine_segments(
                    st, rr.engine_uid),
                counted=True)
            rr.replica = rr.engine_uid = None
            if rr.cancel_requested:
                # the cancel died with the replica — honor it here
                self._fail_queued(rr, "cancelled")
                continue
            # progress died with the replica: requeue a from-scratch
            # rerun (deterministic => token-identical), but as a
            # resume-shaped Request so t_arrival — the TTFT/deadline
            # basis — stays the ORIGINAL submit time; a death must
            # not reset the latency clock
            rr.resume = Request(
                uid=-1, prompt=rr.prompt,
                max_new_tokens=rr.max_new_tokens,
                temperature=rr.temperature,
                eos_id=-1 if rr.eos_id is None else int(rr.eos_id),
                seed=rr.seed, t_arrival=rr.t_submit,
                priority=rr.priority, deadline_s=rr.deadline_s,
                tenant=rr.tenant)
            rr.migrations += 1
            self._queue.push(rr)
            self._m_requeued.inc()
            self.stats["requeued"] += 1
        self.stats["replica_deaths"] += 1
        self.deaths.append({"replica": name, "step": self.steps_taken,
                            "reason": str(reason)[:200],
                            "error": type(reason).__name__
                            if isinstance(reason, BaseException)
                            else None})
        self._m_deaths.inc()
        # observational: replay never applies this — the recorded
        # fault arm reproduces the death at the same step
        self._journal_event("replica_dead", replica=name,
                            step=self.steps_taken,
                            reason=str(reason)[:200],
                            requeued=len(victims))
        self._decision_trace("replica_dead", replica=name,
                             reason=str(reason)[:200],
                             requeued=len(victims))
        self._update_gauges(st)

    def poll_health(self):
        """Pull the fleet view; any LIVE replica whose metrics source
        errored (a silently-dead process — the staleness signal) is
        marked dead and its work requeued. Returns the aggregated fleet
        snapshot (carrying ``fleet_sources_ok`` /
        ``fleet_sources_total``)."""
        fleet = self.aggregator.aggregate()
        for name in list(self.aggregator.last_errors):
            st = self.replicas.get(name)
            if st is not None and st.status in ("live", "draining"):
                self._mark_dead(name, "stale_source")
        return fleet

    def scale_signals(self):
        """The aggregated drain/join driver: fleet queue depth, free
        pages, p99 TTFT and goodput rate from the merged view, plus
        the router's own queue — what an autoscaler compares against
        per-replica capacity.

        ``ttft_p99_s`` is ``None`` until the merged histogram has a
        sample (no samples is NOT "all fast"); the
        per-tenant SLO burn rates (``tenant_burn``: tenant ->
        {window: burn} from the router's :class:`SLOEngine`, plus the
        scalar ``max_burn``) make burn a first-class controller
        input. Burn reads the SLO engine's LAST evaluation — the
        controller owns the ``evaluate()`` cadence so the decision
        clock stays deterministic."""
        agg = self.aggregator
        fleet = agg.aggregate()
        tenant_burn = self._tenant_burn_windows()
        burns = [b for w in tenant_burn.values() for b in w.values()]
        return {
            "router_queue_depth": len(self._queue),
            "engine_queue_depth": agg.total("serving_queue_depth"),
            "free_pages": agg.total("serving_pages_free"),
            "ttft_p99_s": agg.quantile("serving_ttft_seconds", 0.99),
            "goodput_tokens": agg.total(
                "serving_goodput_tokens_total"),
            "sources_ok": fleet.get("sources_ok"),
            "sources_total": fleet.get("sources_total"),
            "live_replicas": len(self.live_replicas()),
            "tenant_burn": tenant_burn,
            "max_burn": max(burns) if burns else 0.0}

    # -- admission tier ------------------------------------------------------
    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_id=None, seed=0, priority=0, deadline_s=None,
               tenant=None):
        """Enqueue a request with the engine's own admission-control
        semantics (priority ordering, ``max_queue`` bound + shed
        policy). Returns the ROUTER uid — engine uids are a placement
        detail that changes under migration."""
        if self.page_size is None:
            raise RuntimeError(
                "join at least one replica before submitting "
                "(affinity digests need the fleet page size)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and float(deadline_s) < 0:
            raise ValueError("deadline_s must be >= 0 (or None)")
        if self.max_queue is not None and \
                len(self._queue) >= self.max_queue:
            self._shed_for(int(priority))
        uid = self._next_uid
        self._next_uid += 1
        seq = self._next_seq
        self._next_seq += 1
        tenant = str(tenant) if tenant else "default"
        trace_id = ""
        if self._tracer is not None:
            trace_id = f"{self.name}:req{uid}"
            try:
                self._tracer.start_trace(
                    "routed_request", trace_id=trace_id, uid=uid,
                    router=self.name, tenant=tenant,
                    priority=int(priority),
                    prompt_tokens=int(prompt.size),
                    max_new_tokens=int(max_new_tokens))
            except Exception:
                trace_id = ""
        rr = _RouterRequest(
            uid=uid, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), eos_id=eos_id,
            seed=int(seed), priority=int(priority),
            deadline_s=None if deadline_s is None
            else float(deadline_s),
            tenant=tenant, seq=seq,
            digests=_page_digests(prompt, self.page_size),
            t_submit=time.perf_counter(), trace_id=trace_id)
        self._requests[uid] = rr
        self._queue.push(rr)
        # open the fleet-level anatomy record — the pending
        # window is tagged "handoff" until the first placement
        self.anatomy.register(uid, tenant=tenant, priority=priority,
                              trace_id=trace_id,
                              step=self.steps_taken)
        self.stats["submitted"] += 1
        self._journal_event(
            "submit", uid=uid, step=self.steps_taken,
            prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=None if eos_id is None else int(eos_id),
            seed=int(seed), priority=int(priority),
            deadline_s=rr.deadline_s, tenant=tenant,
            trace_id=trace_id)
        return uid

    def _shed_for(self, incoming_priority):
        victim = self._queue.pick_shed_victim(incoming_priority,
                                              self.shed_policy)
        self.stats["sheds"] += 1
        if victim is None:
            raise QueueFullError(
                f"router queue full (depth {len(self._queue)} >= "
                f"max_queue {self.max_queue}, policy "
                f"{self.shed_policy!r})",
                depth=len(self._queue), policy=self.shed_policy)
        self._queue.remove(victim)
        self._fail_queued(victim, "shed")

    def _fail_queued(self, rr, reason):
        self._requests.pop(rr.uid, None)
        anat = self._anat_finish(rr, reason)
        # a migrated request's resume state carries what it already
        # observed — its failure Completion must not forget it
        toks, ttft, preempts = [], None, 0
        if rr.resume is not None:
            toks = list(rr.resume.resume_out or [])
            ttft = rr.resume.ttft_s
            preempts = rr.resume.preemptions
        if self._tracer is not None and rr.trace_id:
            try:
                self._tracer.end_trace(
                    rr.trace_id, status=reason, finish_reason=reason,
                    migrations=rr.migrations)
            except Exception:
                pass
        self._early_done.append(Completion(
            rr.uid, toks, reason, ttft_s=ttft, priority=rr.priority,
            preemptions=preempts, tenant=rr.tenant))
        self._journal_event(
            "complete", uid=rr.uid, step=self.steps_taken,
            tokens=[int(t) for t in toks], finish_reason=reason,
            replica=None, migrations=rr.migrations,
            ttft_s=ttft, trace_id=rr.trace_id,
            segments=anat["segments"])
        if reason == "cancelled":
            self.stats["cancelled"] += 1
        elif reason == "deadline":
            self.stats["expired"] += 1

    def cancel(self, uid):
        """Cancel a router request wherever it lives: dequeued at the
        router with an immediate ``cancelled`` completion, or
        forwarded to its replica's engine (the completion then flows
        back through step()). The request is ALSO flagged so a cancel
        survives migration: an eject (drain/preemption) or replica
        death that pulls the request back before the engine applies
        the cancel fails it at the router instead of re-placing it.
        Returns True when the uid was live."""
        rr = self._requests.get(int(uid))
        if rr is None:
            return False
        rr.cancel_requested = True
        if rr.replica is None:
            self._queue.remove(rr)
            self._fail_queued(rr, "cancelled")
            return True
        st = self.replicas.get(rr.replica)
        return bool(st and st.handle.cancel(rr.engine_uid))

    def _expire_queued(self):
        now = time.perf_counter()
        expired = [rr for rr in self._queue
                   if rr.deadline_s is not None
                   and now - rr.t_submit > rr.deadline_s]
        for rr in expired:
            self._queue.remove(rr)
            self._fail_queued(rr, "deadline")

    # -- placement -----------------------------------------------------------
    def _saturated(self, st):
        depth = self.saturation_depth
        if depth is None:
            depth = 2 * getattr(st.handle, "num_slots", 4)
        return st.handle.queue_depth >= depth

    def _affine_target(self, rr):
        """(state, digest-hex) of the longest-prefix affine replica
        that can take the request right now, else (None, longest
        mapped digest or "")."""
        best_digest = ""
        for i in range(len(rr.digests) - 1, -1, -1):
            nm = self._affinity.get(rr.digests[i])
            if nm is None:
                continue
            st = self.replicas.get(nm)
            if st is None or st.status != "live":
                continue
            if not best_digest:
                best_digest = rr.digests[i].hex()
            if not self._saturated(st):
                return st, rr.digests[i].hex()
        return None, best_digest

    def _place(self, rr, target=None, decision=None):
        """Try to place ``rr`` (``target`` forces one replica — the
        remote-preemption path). Candidates are tried in policy order
        — the affine (or random) choice first, then the remaining
        live replicas by load — so a replica-LOCAL rejection (e.g. a
        heterogeneous fleet member whose max_seq_len a migrated
        prompt outgrew) falls through to the next candidate; the
        request fails terminally only when every live replica rejects
        it structurally. Returns True when consumed (placed OR
        terminally failed); False leaves it queued at the router."""
        if rr.cancel_requested:
            self._queue.remove(rr)
            self._fail_queued(rr, "cancelled")
            return True
        deadline = rr.deadline_s
        if deadline is not None:
            # the engine's deadline clock starts at add_request: hand
            # it the REMAINDER so router queue wait counts against
            # the budget
            deadline -= time.perf_counter() - rr.t_submit
            if deadline <= 0:
                self._queue.remove(rr)
                self._fail_queued(rr, "deadline")
                return True
        aff_digest = ""
        if target is not None:
            tries = [(target, decision)]
        else:
            cands = self.live_replicas()
            if not cands:
                return False
            by_load = sorted(cands, key=lambda st: (
                st.handle.queue_depth, -st.handle.free_pages,
                st.name))
            if self.policy == "random":
                first = cands[int(self._rng.randint(len(cands)))]
                tries = [(first, "random")] + [
                    (s, "random") for s in by_load if s is not first]
            else:
                aff, aff_digest = self._affine_target(rr)
                if aff is None and self._saturated(by_load[0]):
                    # the whole fleet is saturated: wait at the
                    # router (or preempt — the dispatch loop's next
                    # move) instead of piling queues deeper
                    return False
                tries = ([(aff, "affinity")] if aff is not None
                         else [])
                # fallbacks keep the saturation wait-policy: a
                # saturated replica is retried on a later step, never
                # piled onto now
                tries.extend((s, "least_loaded") for s in by_load
                             if s is not aff
                             and not self._saturated(s))
            covered_all = len(tries) == len(cands)
        structural_err = None
        saw_capacity = False
        for st, decision in tries:
            sp, ctx = None, None
            if self._tracer is not None and rr.trace_id:
                try:
                    sp = self._tracer.start_span(
                        "route", trace_id=rr.trace_id,
                        replica=st.name, decision=decision,
                        affinity_digest=aff_digest,
                        scores={s.name: [int(s.handle.queue_depth),
                                         int(s.handle.free_pages)]
                                for s in self.replicas.values()
                                if s.status == "live"},
                        migrations=rr.migrations,
                        queue_depth=len(self._queue))
                    ctx = self._tracer.inject(trace_id=rr.trace_id,
                                              span_id=sp.span_id)
                except Exception:
                    sp = ctx = None
            try:
                if rr.resume is not None:
                    engine_uid = st.handle.admit_migrated(
                        rr.resume, trace_ctx=ctx)
                else:
                    engine_uid = st.handle.add_request(
                        prompt=rr.prompt,
                        max_new_tokens=rr.max_new_tokens,
                        temperature=rr.temperature, eos_id=rr.eos_id,
                        seed=rr.seed, priority=rr.priority,
                        deadline_s=deadline, tenant=rr.tenant,
                        trace_ctx=ctx)
            except QueueFullError:
                if sp is not None:
                    sp.end(error="queue_full")
                saw_capacity = True
                continue
            except Exception as e:
                if sp is not None:
                    sp.end(error=repr(e)[:200])
                structural_err = e
                continue
            break
        else:
            if target is None and structural_err is not None \
                    and covered_all and not saw_capacity:
                # EVERY live replica rejected it structurally (none
                # was merely full) — a terminal failure, not a queue
                # wedge. Anything softer stays queued and retries
                # next step; an undeliverable request's backstop is
                # its deadline.
                self._queue.remove(rr)
                self._fail_queued(rr, "error")
                return True
            return False
        if sp is not None:
            sp.end(engine_uid=int(engine_uid))
        rr.replica, rr.engine_uid = st.name, engine_uid
        rr.resume = None
        # close the pending window — the engine counts this
        # router step onward (engines step AFTER dispatch)
        self.anatomy.note_placed(rr.uid, self.steps_taken)
        self._by_engine[(st.name, engine_uid)] = rr.uid
        if rr.affinity_hit is None:
            # request-denominated hit accounting, FIRST placement
            # only, policy-independent: did this land where one of
            # its page digests already lives?
            rr.affinity_hit = any(self._affinity.get(d) == st.name
                                  for d in rr.digests)
            if rr.digests:
                if rr.affinity_hit:
                    self.stats["affinity_hits"] += 1
                    self._m_aff_hits.inc()
                else:
                    self.stats["affinity_misses"] += 1
                    self._m_aff_miss.inc()
        for d in rr.digests:
            owner = self.replicas.get(self._affinity.get(d))
            if owner is None or owner.status != "live":
                self._affinity[d] = st.name
            self._affinity.move_to_end(d)   # LRU touch
        while len(self._affinity) > self.affinity_capacity:
            self._affinity.popitem(last=False)
        self._m_requests.labels(replica=st.name,
                                decision=decision).inc()
        self.stats["placements"] += 1
        self._update_gauges(st)
        return True

    def _requeue_from(self, st, engine_uid, why):
        """Eject ``engine_uid`` from ``st`` and push its router
        request back into the admission tier carrying the resume
        state. Returns the router request (None for engine-side work
        the router never placed)."""
        ruid = self._by_engine.pop((st.name, engine_uid), None)
        if ruid is None:
            return None
        rr = self._requests[ruid]
        req = st.handle.eject(engine_uid)
        # splice the ejected placement's engine run in and
        # open the "migrated" window. A drain lands between router
        # steps (the engine already counted the current step:
        # counted=True); a mid-dispatch remote preemption runs BEFORE
        # the engines step this router step (counted=False — the next
        # placement's engine, or the window, owns the current step).
        self.anatomy.note_unplaced(
            ruid, self.steps_taken, "migrated",
            engine_segments=self._engine_segments(st, engine_uid),
            counted=(why != "preempt_remote"))
        rr.resume = req
        rr.replica = rr.engine_uid = None
        if rr.cancel_requested:
            # the engine-side cancel was outrun by the eject: honor
            # it here — a cancelled request must not resume elsewhere
            self._fail_queued(rr, "cancelled")
            return rr
        rr.migrations += 1
        self._queue.push(rr)
        self._m_requeued.inc()
        self.stats["requeued"] += 1
        if self._tracer is not None and rr.trace_id:
            try:
                with self._tracer.span(
                        "requeue", trace_id=rr.trace_id, reason=why,
                        from_replica=st.name,
                        tokens_out=len(req.resume_out or [])):
                    pass
            except Exception:
                pass
        return rr

    def _tenant_burn_windows(self):
        """tenant -> {window: burn} from the SLO engine's last
        evaluation (worst across that tenant's specs per window) —
        the multi-window shape the autoscaler's burn predictor reads.
        Empty without an SLO engine."""
        if self.slo is None:
            return {}
        try:
            rep = self.slo.report()
        except Exception:
            return {}
        out = {}
        for r in rep.get("slos", []):
            t = r.get("tenant")
            if not t:
                continue
            wins = out.setdefault(t, {})
            for w, b in (r.get("burn") or {}).items():
                wins[str(w)] = max(wins.get(str(w), 0.0), float(b))
        return out

    def _tenant_burns(self):
        """tenant -> worst burn rate across windows, from the SLO
        engine (one fleet-level number per tenant when the engine
        reads this router's aggregator). Empty without an SLO engine —
        victim choice then falls back to priority/recency alone."""
        return {t: max(w.values())
                for t, w in self._tenant_burn_windows().items() if w}

    def _preempt_remote(self, rr):
        """The queue head ``rr`` outranks running work but nothing can
        take it: evict the lowest-value victim anywhere in the fleet
        (priority asc, then tenant SLO burn asc — most budget left —
        then newest arrival) and place ``rr`` on the freed replica.
        The victim requeues through the router and resumes elsewhere
        token-identically. The eviction is committed BEFORE the
        forced placement is known to succeed: if the freed replica
        still refuses the head (an engine-level queue bound), the
        victim has merely been migrated — work is never lost, and
        churn is bounded because evictions stay 1:1 with PLACED
        high-tier heads: a failed post-eviction placement ends the
        dispatch loop for this step, so at most one eviction per step
        goes unrewarded and the head retries next step."""
        burns = self._tenant_burns()
        best = None   # (key, state, victim dict)
        for st in self.live_replicas():
            for v in st.handle.inflight():
                if v["priority"] >= rr.priority:
                    continue
                key = (v["priority"],
                       burns.get(v["tenant"], 0.0), -v["seq"])
                if best is None or key < best[0]:
                    best = (key, st, v)
        if best is None:
            return False
        _, st, v = best
        victim = self._requeue_from(st, v["uid"], "preempt_remote")
        if self._tracer is not None and rr.trace_id:
            try:
                with self._tracer.span(
                        "preempt_remote", trace_id=rr.trace_id,
                        replica=st.name,
                        victim_uid=(victim.uid if victim is not None
                                    else int(v["uid"])),
                        victim_replica=st.name,
                        victim_tenant=v["tenant"],
                        victim_priority=int(v["priority"]),
                        victim_burn=burns.get(v["tenant"], 0.0),
                        priority=rr.priority):
                    pass
            except Exception:
                pass
        self.stats["preempts_remote"] += 1
        return self._place(rr, target=st, decision="preempt_remote")

    def _dispatch(self):
        """Place queued work: priority order with a bounded lookahead
        (a page-starved head must not park placeable traffic), then
        cross-replica preemption for a blocked high-tier head."""
        while self._queue:
            placed = False
            for i in range(min(len(self._queue),
                               self.dispatch_lookahead)):
                rr = self._queue[i]
                if self._place(rr):
                    if self._queue.find_uid(rr.uid) is not None:
                        self._queue.remove(rr)
                    placed = True
                    break
            if placed:
                continue
            head = self._queue[0]
            if self.preemption and head.priority > 0 \
                    and self._preempt_remote(head):
                if self._queue.find_uid(head.uid) is not None:
                    self._queue.remove(head)
                continue
            break

    # -- the serving loop ----------------------------------------------------
    def _complete(self, st, c):
        """An engine completion -> the router-uid completion (None for
        engine traffic the router never placed)."""
        ruid = self._by_engine.pop((st.name, c.uid), None)
        if ruid is None:
            return None
        rr = self._requests.pop(ruid, None)
        if rr is None:
            return None
        # splice the completing placement's engine run in —
        # the fleet-level record now covers the request's whole life
        anat = self._anat_finish(
            rr, c.finish_reason,
            engine_segments=self._engine_segments(st, c.uid))
        out = Completion(
            rr.uid, list(c.tokens), c.finish_reason, ttft_s=c.ttft_s,
            priority=rr.priority, preemptions=c.preemptions,
            tenant=rr.tenant)
        self.stats["completed"] += 1
        # engine-applied decisions count too — the router-tier stats
        # must agree with the completion stream, not just with the
        # failures the router itself minted
        if c.finish_reason == "cancelled":
            self.stats["cancelled"] += 1
        elif c.finish_reason == "deadline":
            self.stats["expired"] += 1
        self.completed.append({
            "uid": rr.uid, "replica": st.name,
            "finish_reason": c.finish_reason,
            "migrations": rr.migrations,
            "affinity_hit": rr.affinity_hit, "tenant": rr.tenant,
            "priority": rr.priority})
        self._journal_event(
            "complete", uid=rr.uid, step=self.steps_taken,
            tokens=[int(t) for t in c.tokens],
            finish_reason=c.finish_reason, replica=st.name,
            migrations=rr.migrations, ttft_s=c.ttft_s,
            trace_id=rr.trace_id, segments=anat["segments"])
        if self._tracer is not None and rr.trace_id:
            try:
                self._tracer.end_trace(
                    rr.trace_id,
                    status="ok" if c.finish_reason in ("eos", "length")
                    else c.finish_reason,
                    finish_reason=c.finish_reason,
                    replica=st.name, migrations=rr.migrations,
                    tokens_emitted=len(c.tokens))
            except Exception:
                pass
        return out

    def step(self):
        """One router tick: expire/dispatch queued work, step every
        live or draining replica (a step that RAISES marks its replica
        dead and requeues its work), finish drains. Returns the
        completions that landed this tick, router-uid'd."""
        done, self._early_done = list(self._early_done), []
        self.steps_taken += 1
        self._expire_queued()
        self._dispatch()
        for name, st in list(self.replicas.items()):
            if st.status not in ("live", "draining"):
                continue
            try:
                comps = st.handle.step()
            except Exception as e:
                self._mark_dead(name, e)
                continue
            for c in comps:
                out = self._complete(st, c)
                if out is not None:
                    done.append(out)
            self._update_gauges(st)
            if st.status == "draining" and not st.handle.has_work:
                self._finish_drain(st)
        done.extend(self._early_done)
        self._early_done = []
        return done

    @property
    def has_work(self):
        return (bool(self._queue) or bool(self._early_done)
                or bool(self._by_engine)
                or any(st.handle.has_work
                       for st in self.replicas.values()
                       if st.status in ("live", "draining")))

    def run(self, max_steps=None):
        """Drive step() until the fleet drains; {router uid:
        Completion}. Raises once a stuck fleet (e.g. every replica
        dead with work queued) exceeds ``max_steps``."""
        done = {}
        steps = 0
        while self.has_work:
            # already-minted completions (cancels, sheds, expiries)
            # must drain through step() before a dead fleet is fatal
            if not self._early_done and not self.live_replicas() \
                    and not any(st.status == "draining"
                                for st in self.replicas.values()):
                raise RuntimeError(
                    f"router has work but no live replicas "
                    f"({len(self._queue)} queued)")
            for c in self.step():
                done[c.uid] = c
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"router loop exceeded max_steps={max_steps}")
        return done

    def affinity_hit_rate(self):
        """Fraction of first placements that landed on an affine
        replica (None before any placement)."""
        h, m = self.stats["affinity_hits"], self.stats["affinity_misses"]
        return h / (h + m) if h + m else None

    def close(self, close_replicas=True):
        """Tear the fleet down (non-dead replica handles closed when
        ``close_replicas``); the router object stays inspectable. A
        journal gets the run summary — stats + per-replica ledger
        conservation, the divergence checker's third axis — then a
        final flush (and close when the router owns the writer)."""
        if self.journal is not None:
            cons = {}
            for name, st in self.replicas.items():
                if st.status == "dead":
                    continue
                led = getattr(getattr(st.handle, "engine", None),
                              "ledger", None)
                if led is not None:
                    try:
                        cons[name] = bool(
                            led.attribution_check()["conserved"])
                    except Exception:
                        pass
            self._journal_event("summary", step=self.steps_taken,
                                stats=dict(self.stats),
                                conserved=cons,
                                completed=self.stats["completed"])
        if close_replicas:
            for st in self.replicas.values():
                if st.status != "dead":
                    try:
                        st.handle.close()
                    except Exception:
                        pass
        if self.journal is not None:
            try:
                if self._owns_journal:
                    self.journal.close()
                else:
                    self.journal.flush()
            except Exception:
                pass
