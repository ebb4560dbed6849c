"""The serving journal — the port's own copy of
``paddle_tpu/observability/journal.py`` (which has no JAX in it; the port
imports nothing of ``paddle_tpu``): event-sourced recording of every
input a serving run consumed, and the deterministic replay that drives a
FRESH engine through the recorded schedule.

The engines are deterministic given (prompt, seed, temperature). What is
not deterministic is everything that arrives from outside: which
requests showed up (tokens, tenant, tier, sampling seed), when they
showed up (the step-paced schedule), which faults were armed, and which
replicas drained, joined or died. The journal records exactly that set,
so that::

    recorded run  ==  replay(journal, fresh engine)

token for token, greedy and fixed-seed sampled alike. The format
(``JOURNAL_FORMAT``) and the event schema are the reference's, so a
journal written by either package's engine reads in the other and
:func:`replay` drives either engine (greedy streams are identical across
the two; sampled ones only within one package, whose generators differ).

- :class:`JournalWriter` — append-only JSONL, crash-safe (whole-line
  appends + fsync on flush; a torn final line is detected and dropped by
  the reader), a bounded in-memory buffer, atomic ``os.replace``
  rotation at ``max_bytes``, and a ``dump()`` surface duck-typed to the
  flight-recorder postmortem registry: the engine exception, SIGUSR1 and
  ``dump_all_postmortems`` hooks flush the journal as they dump span
  trees. Fed by ``ServingEngine(journal=...)`` and by
  ``FaultInjector.bind_journal``.
- :class:`JournalReader` / :func:`replay` — parse (tolerantly: a
  truncated tail degrades to the prefix that made it to disk, a corrupt
  mid-file line is skipped and reported unless ``strict``), then drive a
  fresh engine through the recorded schedule: submit events land after
  exactly the recorded number of ``step()`` calls, fault arms likewise.
  :func:`check_divergence` diffs per-request token streams, outcomes,
  ledger conservation and segment anatomies and reports the FIRST
  divergence with its span context.
- :func:`generate_workload` — heavy-tail lognormal prompt lengths and
  pareto output budgets, zipf-popular shared-prefix groups, weighted
  tenant/tier mixes and a diurnal + burst (two-state modulated Poisson)
  arrival process, all drawn from ONE seeded RandomState and emitted in
  the same journal format (seed-recipe prompts, no wall clock).
  :func:`write_workload` output is byte-reproducible from its seed.

Host-side only (the scheduler import is call-time).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "JOURNAL_FORMAT", "EVENT_KINDS", "JournalError",
    "JournalWriter", "JournalReader", "read_journal", "expand_prompt",
    "schedule_from_stream", "replay", "ReplayResult",
    "check_divergence", "generate_workload", "write_workload",
]

JOURNAL_FORMAT = "paddle_tpu-journal-v1"

# One line per event, ``kind`` first among sorted keys by accident of
# the alphabet, ``seq`` strictly monotonic per journal:
#
# - meta         format/id/name + caller fields (param_seed, model,
#                workload params, replayed_from) — always line one;
#                rotation opens the next generation with a meta line
#                carrying ``continues``.
# - config       one per replica: the engine-config fingerprint
#                (model config + every identity-relevant engine lever
#                + a weights digest) and its hash.
# - submit       one request arrival: uid, step (``step()`` calls the
#                recorder had made — the replayable clock), prompt
#                (raw tokens) OR recipe (seed-recipe expansion —
#                the workload generator's compact form), max_new_
#                tokens/temperature/eos_id/seed/priority/deadline_s/
#                tenant, trace_id.
# - fault        a FaultInjector arm: step, fault kind, target uid,
#                count, seconds, replica.
# - drain/join   membership changes, step-stamped.
# - replica_dead the OBSERVED death (step, replica, reason). Replay
#                never applies it — the recorded fault arm reproduces
#                it; the event exists so a reader can see what the
#                recorded run concluded.
# - complete     one request outcome: uid, step, tokens, finish_
#                reason, replica, migrations, ttft_s (informational —
#                wall clock is NOT part of the identity diff),
#                trace_id (the span context a divergence reports),
#                segments (the run-length-compressed latency
#                anatomy, step-denominated — the divergence checker's
#                fifth identity axis).
# - scale        one autoscaler decision: step, decision
#                (scale_out/scale_in/scale_hold), rule, replica,
#                replicas_before/after, the signal snapshot and the
#                counterfactual. Replay never applies it — a replayed
#                controller re-decides — but the SEQUENCE is the
#                divergence checker's fourth identity axis.
# - summary      end-of-run stats + per-replica ledger-conservation
#                flags (the third axis the divergence checker diffs).
EVENT_KINDS = ("meta", "config", "submit", "fault", "drain", "join",
               "replica_dead", "complete", "scale", "summary")


class JournalError(RuntimeError):
    """A malformed journal (strict parsing), an unknown event kind, or
    a write to a closed journal."""


def _jsonable(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.hex()
    raise TypeError(f"not journal-serializable: {type(v)!r}")


def _digest(obj):
    """Stable blake2b-8 hex of any jsonable payload."""
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_jsonable).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


# -- recording ----------------------------------------------------------------

class JournalWriter:
    """Append-only journal sink (module docstring). ``meta`` fields
    ride the first line; ``registry`` (optional) feeds the
    ``journal_events_total{kind}`` / ``journal_bytes_total`` series;
    ``wallclock=False`` omits the per-event ``t`` offset — the
    byte-reproducible mode the workload generator writes in;
    ``max_bytes`` arms atomic rotation (the current generation is
    ``os.replace``d to ``<path>.1`` and a continuation meta line opens
    the next — readers stitch the pair back together).

    The writer registers ITSELF with the flight-recorder postmortem
    registry (it duck-types ``dump(path, reason)`` as a flush), so an
    engine exception, SIGUSR1, or ``dump_all_postmortems()`` lands the
    buffered tail on disk exactly when the span trees dump."""

    def __init__(self, path, *, name="journal0", meta=None,
                 registry=None, buffer_events=256, max_bytes=None,
                 wallclock=True):
        if int(buffer_events) < 1:
            raise ValueError("buffer_events must be >= 1")
        self.path = str(path)
        self.name = str(name)
        self.buffer_events = int(buffer_events)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.wallclock = bool(wallclock)
        self._buf = []
        self._seq = 0
        self._bytes_gen = 0          # bytes in the current generation
        self._rotations = 0
        self._t0 = time.perf_counter()
        self._closed = False
        self._lock = threading.Lock()
        self._m_events = self._m_bytes = None
        if registry is not None:
            self._m_events = registry.counter(
                "journal_events_total",
                "fleet-journal events recorded, by kind",
                labels=("kind",))
            self._m_bytes = registry.counter(
                "journal_bytes_total",
                "fleet-journal bytes flushed to disk")
            self._m_bytes.inc(0)
        payload = {"format": JOURNAL_FORMAT, "journal": self.name}
        payload.update(meta or {})
        payload["id"] = _digest(payload)
        self.journal_id = payload["id"]
        self._meta_payload = payload
        open(self.path, "w").close()     # a fresh generation
        self.event("meta", **payload)
        # the postmortem registry holds the writer WEAKLY (same
        # contract as tracers) — registration never keeps an abandoned
        # journal alive
        from . import tracing as _tracing
        self._pm_handle = _tracing.register_postmortem(self, self.path)

    # -- event intake --------------------------------------------------------
    def event(self, kind, **fields):
        """Record one event; returns the dict as written (with its
        stamped ``seq``). Buffered — ride :meth:`flush`, the buffer
        high-water mark, or any postmortem dump to disk."""
        if kind not in EVENT_KINDS:
            raise JournalError(
                f"unknown journal event kind {kind!r} "
                f"(one of {EVENT_KINDS})")
        if self._closed:
            raise JournalError("journal is closed")
        with self._lock:
            rec = {"kind": kind, "seq": self._seq}
            rec.update(fields)
            if self.wallclock:
                rec["t"] = round(time.perf_counter() - self._t0, 6)
            line = json.dumps(rec, sort_keys=True,
                              separators=(",", ":"),
                              default=_jsonable) + "\n"
            self._seq += 1
            self._buf.append(line)
            if self._m_events is not None:
                self._m_events.labels(kind=kind).inc()
            if len(self._buf) >= self.buffer_events:
                self._flush_locked()
        return rec

    # -- persistence ---------------------------------------------------------
    def _flush_locked(self):
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        data = "".join(buf)
        with open(self.path, "a") as f:
            f.write(data)
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
        self._bytes_gen += len(data)
        if self._m_bytes is not None:
            self._m_bytes.inc(len(data))
        if self.max_bytes is not None \
                and self._bytes_gen >= self.max_bytes:
            self._rotate_locked()

    def _rotate_locked(self):
        """Atomic rotation: the full generation moves to ``.1`` in one
        ``os.replace`` (readers never observe a half-written file),
        and a continuation meta line opens the next generation."""
        os.replace(self.path, self.path + ".1")
        self._rotations += 1
        self._bytes_gen = 0
        cont = dict(self._meta_payload)
        cont["continues"] = self.journal_id
        cont["rotation"] = self._rotations
        rec = {"kind": "meta", "seq": self._seq}
        rec.update(cont)
        if self.wallclock:
            rec["t"] = round(time.perf_counter() - self._t0, 6)
        self._seq += 1
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"),
                          default=_jsonable) + "\n"
        with open(self.path, "w") as f:
            f.write(line)
        self._bytes_gen += len(line)
        if self._m_events is not None:
            self._m_events.labels(kind="meta").inc()
        if self._m_bytes is not None:
            self._m_bytes.inc(len(line))

    def flush(self):
        with self._lock:
            self._flush_locked()
        return self.path

    def dump(self, path=None, reason="manual"):
        """The postmortem-registry surface (duck-typed to
        ``Tracer.dump``): a crash/SIGUSR1 dump flushes the journal."""
        return self.flush()

    def close(self):
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._pm_handle is not None:
            from . import tracing as _tracing
            _tracing.unregister_postmortem(self._pm_handle)
            self._pm_handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- reading ------------------------------------------------------------------

class JournalReader:
    """Parse a journal back into events. Crash-tolerant by default: a
    TORN FINAL LINE (the crash the append-only format is designed
    around) sets ``truncated`` and yields the intact prefix; a corrupt
    line anywhere else is skipped into ``errors``. ``strict=True``
    raises :class:`JournalError` on any of it. A rotated predecessor
    (``<path>.1``) is stitched in front automatically."""

    def __init__(self, path, strict=False):
        self.path = str(path)
        self.strict = bool(strict)
        self.events = []
        self.errors = []
        self.truncated = False
        self.meta = {}
        paths = [p for p in (self.path + ".1", self.path)
                 if os.path.exists(p)]
        if not paths:
            raise FileNotFoundError(self.path)
        for p in paths:
            with open(p) as f:
                data = f.read()
            torn_tail_ok = (p == paths[-1]
                            and not data.endswith("\n"))
            lines = data.split("\n")
            for i, ln in enumerate(lines):
                if not ln.strip():
                    continue
                try:
                    rec = json.loads(ln)
                    if not isinstance(rec, dict) \
                            or rec.get("kind") not in EVENT_KINDS:
                        raise ValueError(f"bad event {rec!r:.80}")
                except ValueError as e:
                    if i == len(lines) - 1 and torn_tail_ok:
                        # the crash tail: everything before it stands
                        self.truncated = True
                        break
                    if self.strict:
                        raise JournalError(
                            f"{p}: corrupt journal line {i}: "
                            f"{e}") from None
                    self.errors.append(f"{p}:{i}: {e}")
                    continue
                if rec["kind"] == "meta" and not self.meta:
                    self.meta = rec
                self.events.append(rec)
        fmt = self.meta.get("format")
        if fmt != JOURNAL_FORMAT:
            msg = (f"{self.path}: journal format {fmt!r}, expected "
                   f"{JOURNAL_FORMAT!r}")
            if self.strict:
                raise JournalError(msg)
            self.errors.append(msg)

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def by_kind(self, kind):
        return [e for e in self.events if e.get("kind") == kind]

    def submits(self):
        return {e["uid"]: e for e in self.by_kind("submit")}

    def completes(self):
        return {e["uid"]: e for e in self.by_kind("complete")}

    def summary(self):
        s = self.by_kind("summary")
        return s[-1] if s else None


def read_journal(path, strict=False):
    return JournalReader(path, strict=strict)


def _coerce(journal):
    """journal -> (events list, reader-or-None)."""
    if isinstance(journal, JournalReader):
        return journal.events, journal
    if isinstance(journal, (str, os.PathLike)):
        r = JournalReader(journal)
        return r.events, r
    return list(journal), None


def expand_prompt(ev):
    """A submit event's prompt as int32 tokens: raw ``prompt`` lists
    (recorded production windows) or the workload generator's
    ``recipe`` (seed-expansion — the SAME group ``prefix_seed`` always
    expands to the SAME shared prefix, so zipf prefix groups survive
    the round trip page-digest-identical)."""
    if ev.get("prompt") is not None:
        return np.asarray(ev["prompt"], np.int32).reshape(-1)
    r = ev.get("recipe")
    if not r:
        raise JournalError(
            f"submit event {ev.get('uid')!r} has neither prompt nor "
            "recipe")
    vocab = int(r["vocab"])
    parts = []
    if int(r.get("prefix_len", 0)) > 0:
        parts.append(np.random.RandomState(
            int(r["prefix_seed"]) & 0x7FFFFFFF).randint(
            0, vocab, int(r["prefix_len"])))
    if int(r.get("tail_len", 0)) > 0:
        parts.append(np.random.RandomState(
            int(r["tail_seed"]) & 0x7FFFFFFF).randint(
            0, vocab, int(r["tail_len"])))
    if not parts:
        raise JournalError(f"empty recipe in {ev!r:.120}")
    return np.concatenate(parts).astype(np.int32)


def schedule_from_stream(items, *, arrival_steps=1, start_step=0):
    """In-memory submit events from a bench-style stream: ``items``
    are dicts of ``submit()`` kwargs (``prompt`` may stay an ndarray —
    these events need not serialize); item ``i`` lands after
    ``start_step + i*arrival_steps`` steps. This is the shared shape
    the bench's paced-arrival legs dedupe onto: build the schedule,
    then :func:`replay` drives it."""
    out = []
    for i, item in enumerate(items):
        ev = {"kind": "submit", "seq": i, "uid": i,
              "step": start_step + i * int(arrival_steps)}
        ev.update(item)
        out.append(ev)
    return out


# -- replay -------------------------------------------------------------------

_SUBMIT_KW = ("max_new_tokens", "temperature", "eos_id", "seed",
              "priority", "deadline_s", "tenant")


@dataclass
class ReplayResult:
    """What :func:`replay` drove: completions keyed by JOURNAL uid
    (the recorder's ids — target uids are a placement detail),
    ``uid_map`` journal->target, rejected journal uids (admission
    sheds at submit time), and events replay could not apply."""
    completions: dict = field(default_factory=dict)
    uid_map: dict = field(default_factory=dict)
    rejected: list = field(default_factory=list)
    skipped: list = field(default_factory=list)
    ticks: int = 0
    wall_s: float = 0.0
    target: object = None

    def conservation(self):
        """Per-replica ledger-conservation flags of the replayed
        target (None when the target exposes no ledger)."""
        return _conservation_of(self.target)


def _conservation_of(target):
    out = {}
    try:
        if hasattr(target, "replicas"):        # a FleetRouter
            for name, st in target.replicas.items():
                if st.status == "dead":
                    continue
                eng = getattr(st.handle, "engine", st.handle)
                chk = getattr(eng, "ledger", None)
                if chk is not None:
                    out[name] = bool(
                        eng.ledger.attribution_check()["conserved"])
        elif hasattr(target, "ledger"):        # a bare ServingEngine
            out[f"e{getattr(target, 'engine_id', 0)}"] = bool(
                target.ledger.attribution_check()["conserved"])
    except Exception:
        return None
    return out or None


def _find_injector(target, replica):
    if hasattr(target, "replicas") and replica is not None:
        st = target.replicas.get(replica)
        if st is None:
            return None
        eng = getattr(st.handle, "engine", st.handle)
        return getattr(eng, "faults", None)
    return getattr(target, "faults", None)


def replay(journal, target, *, step_fn=None, on_tick=None,
           controller=None, replica_factory=None,
           max_steps=2_000_000, catch_queue_full=True):
    """Drive ``target`` (a FleetRouter, a ServingEngine, or anything
    duck-typed over their surfaces) through the recorded schedule:
    every schedule event lands after exactly its recorded number of
    ``step()`` calls, then the run drains. Returns a
    :class:`ReplayResult` keyed by journal uid.

    ``step_fn`` overrides the per-tick step call (an engine driver
    with hoisted weights passes ``lambda: engine.step(params)``);
    ``on_tick(k)`` runs after every step — the bench's mid-stream SLO
    evaluation cadence rides it.

    Membership replay: ``replica_factory(event) ->
    replica`` lets recorded ``join`` events re-apply (replay cannot
    invent an engine); without one they land in ``skipped``.
    ``controller`` is an autoscale controller bound to ``target`` — its ``tick()`` runs
    after every step (the same clock point the recorder used), it
    RE-DECIDES the recorded run's scaling, and recorded drain/join
    events stamped ``source="autoscaler"`` are therefore NOT applied
    from the schedule (the replayed controller must reproduce them
    itself — :func:`check_divergence` diffs the two decision
    sequences as its fourth identity axis)."""
    events, _ = _coerce(journal)
    sched = [e for e in events
             if e.get("kind") in ("submit", "fault", "drain", "join")]
    if controller is not None:
        # the replayed controller re-drives its own membership moves
        sched = [e for e in sched
                 if not (e.get("kind") in ("drain", "join")
                         and e.get("source") == "autoscaler")]
    sched.sort(key=lambda e: (int(e.get("step", 0)),
                              int(e.get("seq", 0))))
    is_fleet = hasattr(target, "submit")
    if step_fn is None:
        step_fn = target.step
    from ..inference.scheduler import QueueFullError
    res = ReplayResult(target=target)
    rev = {}                       # target uid -> journal uid

    def apply(ev):
        kind = ev["kind"]
        if kind == "submit":
            kw = {k: ev.get(k) for k in _SUBMIT_KW
                  if ev.get(k) is not None}
            kw["prompt"] = expand_prompt(ev)
            kw.setdefault("max_new_tokens", 1)
            try:
                if is_fleet:
                    uid = target.submit(**kw)
                else:
                    uid = target.add_request(**kw)
            except QueueFullError:
                if not catch_queue_full:
                    raise
                res.rejected.append(ev["uid"])
                return
            res.uid_map[ev["uid"]] = uid
            rev[uid] = ev["uid"]
        elif kind == "fault":
            inj = _find_injector(target, ev.get("replica"))
            if inj is None:
                res.skipped.append(ev)
                return
            inj.inject(ev["fault"], uid=ev.get("uid"),
                       count=int(ev.get("count", 1)),
                       seconds=float(ev.get("seconds", 0.0)))
        elif kind == "drain":
            try:
                target.drain(ev["replica"])
            except Exception:
                res.skipped.append(ev)
        elif kind == "join" and replica_factory is not None:
            try:
                target.join(replica_factory(ev))
            except Exception:
                res.skipped.append(ev)
        else:                      # join needs a replica factory
            res.skipped.append(ev)

    t0 = time.perf_counter()
    i = 0
    while True:
        while i < len(sched) \
                and int(sched[i].get("step", 0)) <= res.ticks:
            apply(sched[i])
            i += 1
        if i >= len(sched) and not target.has_work:
            break
        for c in step_fn():
            ju = rev.get(c.uid)
            if ju is not None:
                res.completions[ju] = c
        res.ticks += 1
        if on_tick is not None:
            on_tick(res.ticks)
        if controller is not None:
            controller.tick()
        if res.ticks > max_steps:
            raise JournalError(
                f"replay exceeded max_steps={max_steps} "
                f"({i}/{len(sched)} events applied)")
    res.wall_s = time.perf_counter() - t0
    return res


# -- the divergence checker ---------------------------------------------------

# the decision-identity fields of one ``scale`` event: everything the
# controller DECIDED (wall-clock-free), none of what it merely observed
# (the journaled ``signals`` snapshot carries ttft_p99_s — wall clock —
# for humans; the identity diff must not read nondeterminism into it)
_SCALE_FIELDS = ("step", "decision", "rule", "replica",
                 "replicas_before", "replicas_after")


def _canon_scale(ev):
    return {k: ev.get(k) for k in _SCALE_FIELDS}


def _scale_view(side):
    """side -> ordered list of canonical scale decisions, or None when
    the side carries no decision record at all (a pre-autoscaler
    journal, a bare {uid: Completion} map)."""
    if isinstance(side, ReplayResult):
        ctl = getattr(side.target, "autoscaler", None)
        if ctl is None:
            return None
        return [_canon_scale(d) for d in ctl.decisions]
    if isinstance(side, (JournalReader, str, os.PathLike, list)):
        events, _ = _coerce(side)
        return [_canon_scale(e) for e in events
                if e.get("kind") == "scale"]
    return None


def _anatomy_view(side):
    """side -> {journal uid: RLE segment sequence}, or None when the
    side carries no anatomy at all (a pre-anatomy journal, a bare
    {uid: Completion} map, a target without a ledger). Per-uid
    sequences are an identity payload: step-denominated, so
    a faithful replay reproduces them byte-identically."""
    if isinstance(side, ReplayResult):
        anat = getattr(side.target, "anatomy", None)
        if anat is None:
            return None
        out = {}
        for ju, tu in side.uid_map.items():
            try:
                seq = anat.sequence_of(tu)
            except Exception:
                seq = None
            if seq is not None:
                out[int(ju)] = [[str(s), int(n)] for s, n in seq]
        return out
    if isinstance(side, (JournalReader, str, os.PathLike, list)):
        events, _ = _coerce(side)
        out = {}
        for e in events:
            if e.get("kind") == "complete" \
                    and e.get("segments") is not None:
                out[int(e["uid"])] = [[str(s), int(n)]
                                      for s, n in e["segments"]]
        return out
    return None


def _completions_view(replayed):
    """replayed -> ({uid: {tokens, finish_reason, trace_id, replica}},
    conservation-flags-or-None). Accepts a ReplayResult, a replayed
    journal (path/reader/events), or a plain {uid: Completion} map."""
    if isinstance(replayed, ReplayResult):
        done = {u: {"tokens": list(c.tokens),
                    "finish_reason": c.finish_reason,
                    "trace_id": "", "replica": None}
                for u, c in replayed.completions.items()}
        return done, replayed.conservation()
    if isinstance(replayed, (JournalReader, str, os.PathLike, list)):
        events, _ = _coerce(replayed)
        done = {e["uid"]: e for e in events
                if e.get("kind") == "complete"}
        summ = [e for e in events if e.get("kind") == "summary"]
        cons = summ[-1].get("conserved") if summ else None
        return done, cons
    # a {uid: Completion} map
    done = {u: {"tokens": list(c.tokens),
                "finish_reason": c.finish_reason,
                "trace_id": "", "replica": None}
            for u, c in dict(replayed).items()}
    return done, None


def check_divergence(recorded, replayed, *, registry=None,
                     max_divergences=64):
    """Diff a recorded journal against a replayed run on the five
    identity axes: per-request TOKEN STREAMS, OUTCOMES (finish
    reasons; wall-clock fields like ttft_s are deliberately not
    diffed), LEDGER CONSERVATION (each side's per-replica
    attribution-conserved flags), — when either side carries an
    autoscaler — the SCALE-DECISION SEQUENCE (each recorded
    ``scale`` event vs the replayed controller's decision at the same
    position, on the wall-clock-free fields of ``_SCALE_FIELDS``),
    and — when both sides carry latency anatomy — each request's
    SEGMENT SEQUENCE (run-length-compressed and
    step-denominated, so record and replay must match byte for byte).
    Returns a report dict whose ``first`` divergence carries its span
    context — the recorded and replayed trace ids and the replica the
    recorded request completed on — so the next stop is the
    flight-recorder dump, not a print-debug session. ``registry``
    feeds ``replay_divergence_total``."""
    events, _ = _coerce(recorded)
    rec_done = {e["uid"]: e for e in events
                if e.get("kind") == "complete"}
    rec_summ = [e for e in events if e.get("kind") == "summary"]
    rec_cons = rec_summ[-1].get("conserved") if rec_summ else None
    rep_done, rep_cons = _completions_view(replayed)
    rec_scale = _scale_view(recorded)
    rep_scale = _scale_view(replayed)
    rec_anat = _anatomy_view(recorded)
    rep_anat = _anatomy_view(replayed)

    divs = []

    def div(uid, field_, recorded_v, replayed_v):
        a = rec_done.get(uid) or {}
        b = rep_done.get(uid) or {}
        divs.append({
            "uid": uid, "field": field_,
            "recorded": recorded_v, "replayed": replayed_v,
            "span": {"recorded_trace_id": a.get("trace_id", ""),
                     "replayed_trace_id": b.get("trace_id", ""),
                     "replica": a.get("replica"),
                     "step": a.get("step")}})

    for uid in sorted(rec_done):
        if len(divs) >= max_divergences:
            break
        a = rec_done[uid]
        b = rep_done.get(uid)
        if b is None:
            div(uid, "missing", a.get("finish_reason"), None)
            continue
        ta = [int(t) for t in (a.get("tokens") or [])]
        tb = [int(t) for t in (b.get("tokens") or [])]
        if ta != tb:
            k = next((j for j, (x, y)
                      in enumerate(zip(ta, tb)) if x != y),
                     min(len(ta), len(tb)))
            div(uid, "tokens",
                {"len": len(ta), "at": k, "tok": ta[k:k + 4]},
                {"len": len(tb), "at": k, "tok": tb[k:k + 4]})
        if a.get("finish_reason") != b.get("finish_reason"):
            div(uid, "finish_reason", a.get("finish_reason"),
                b.get("finish_reason"))
    for uid in sorted(set(rep_done) - set(rec_done)):
        if len(divs) >= max_divergences:
            break
        div(uid, "extra", None, rep_done[uid].get("finish_reason"))
    for side, cons in (("recorded", rec_cons), ("replayed", rep_cons)):
        for name, ok in sorted((cons or {}).items()):
            if not ok:
                div(None, "ledger_conservation", side, name)
    # axis 4: the autoscaler decision sequence — positional, exact
    if rec_scale is not None and rep_scale is not None \
            and (rec_scale or rep_scale):
        if len(rec_scale) != len(rep_scale):
            div(None, "scale_decision_count",
                len(rec_scale), len(rep_scale))
        for i, (a, b) in enumerate(zip(rec_scale, rep_scale)):
            if len(divs) >= max_divergences:
                break
            if a != b:
                div(None, "scale_decision",
                    {"index": i, **a}, {"index": i, **b})
    # axis 5: the latency-anatomy segment sequence —
    # byte-identical per uid; compared only where BOTH sides carry a
    # sequence (pre-anatomy journals and duck-typed targets skip)
    if rec_anat is not None and rep_anat is not None:
        for uid in sorted(set(rec_anat) & set(rep_anat)):
            if len(divs) >= max_divergences:
                break
            if rec_anat[uid] != rep_anat[uid]:
                div(uid, "anatomy", rec_anat[uid][:8],
                    rep_anat[uid][:8])

    report = {
        "requests": len(rec_done),
        "replayed": len(rep_done),
        "divergences": len(divs),
        "identical": not divs,
        "first": divs[0] if divs else None,
        "all": divs,
        "conservation": {"recorded": rec_cons, "replayed": rep_cons},
        "scale_decisions": {
            "recorded": None if rec_scale is None else len(rec_scale),
            "replayed": None if rep_scale is None else len(rep_scale)},
        "anatomy": {
            "recorded": None if rec_anat is None else len(rec_anat),
            "replayed": None if rep_anat is None else len(rep_anat)},
    }
    if registry is not None:
        m = registry.counter(
            "replay_divergence_total",
            "record->replay divergences found by the checker "
            "(token streams, outcomes, ledger conservation)")
        m.inc(len(divs))
    return report


# -- the workload generator ---------------------------------------------------

def generate_workload(*, seed=0, requests=64, vocab=50304,
                      prompt_mu=2.8, prompt_sigma=0.7, min_prompt=4,
                      max_prompt=96, output_pareto_a=1.8, min_new=2,
                      max_new=64, prefix_groups=8, prefix_len=16,
                      prefix_frac=0.7, zipf_a=1.1, tenants=None,
                      sample_frac=0.3, temperature=0.8,
                      base_arrivals_per_tick=0.5, diurnal_period=256,
                      diurnal_amp=0.6, burst_mult=4.0, burst_on=0.02,
                      burst_off=0.25, steps_per_tick=1):
    """The million-user day-in-the-life, replayable from one seed
    (module docstring). Returns ``(events, params)`` — submit events
    in the journal schema (seed-recipe prompts) plus the full
    parameter record for the meta line.

    - Prompt lengths: lognormal(``prompt_mu``, ``prompt_sigma``)
      clipped to [min_prompt, max_prompt]; output budgets:
      ``min_new * (1 + pareto(output_pareto_a))`` clipped to
      [min_new, max_new] — both heavy-tailed, the mixed-length shape
      continuous batching exists for.
    - Shared prefixes: each request joins a prefix group with
      probability ``prefix_frac``; group popularity is zipf
      (``1/rank^zipf_a`` over ``prefix_groups``) — a few system
      prompts dominate, the long tail stays warm, exactly the
      affinity-router subject.
    - Tenants: ``{name: weight}`` or ``{name: (weight, priority)}``
      (default ``{"gold": (0.25, 2), "bulk": (0.75, 0)}``).
    - Arrivals: per-tick Poisson with rate ``base * (1 +
      diurnal_amp*sin(2*pi*t/diurnal_period))``, multiplied by
      ``burst_mult`` while a two-state (on/off, ``burst_on``/
      ``burst_off`` switch probabilities) burst process is hot — the
      diurnal-plus-burst arrival shape of real fleets. Events land at
      ``step = tick * steps_per_tick``.
    - ``sample_frac`` of requests decode at ``temperature`` with a
      per-uid fixed seed; the rest are greedy — replay identity must
      hold for BOTH.
    """
    if tenants is None:
        tenants = {"gold": (0.25, 2), "bulk": (0.75, 0)}
    t_names, t_weights, t_prio = [], [], {}
    for nm, spec in tenants.items():
        if isinstance(spec, (tuple, list)):
            w, pr = float(spec[0]), int(spec[1])
        else:
            w, pr = float(spec), 0
        t_names.append(str(nm))
        t_weights.append(w)
        t_prio[str(nm)] = pr
    tot = sum(t_weights)
    if tot <= 0:
        raise ValueError("tenant weights must sum > 0")
    t_weights = [w / tot for w in t_weights]

    G = max(1, int(prefix_groups))
    zipf_p = np.array([1.0 / (r + 1) ** float(zipf_a)
                       for r in range(G)])
    zipf_p /= zipf_p.sum()
    params = {
        "seed": int(seed), "requests": int(requests),
        "vocab": int(vocab), "prompt_mu": float(prompt_mu),
        "prompt_sigma": float(prompt_sigma),
        "min_prompt": int(min_prompt), "max_prompt": int(max_prompt),
        "output_pareto_a": float(output_pareto_a),
        "min_new": int(min_new), "max_new": int(max_new),
        "prefix_groups": G, "prefix_len": int(prefix_len),
        "prefix_frac": float(prefix_frac), "zipf_a": float(zipf_a),
        "tenants": {nm: [w, t_prio[nm]]
                    for nm, w in zip(t_names, t_weights)},
        "sample_frac": float(sample_frac),
        "temperature": float(temperature),
        "base_arrivals_per_tick": float(base_arrivals_per_tick),
        "diurnal_period": int(diurnal_period),
        "diurnal_amp": float(diurnal_amp),
        "burst_mult": float(burst_mult), "burst_on": float(burst_on),
        "burst_off": float(burst_off),
        "steps_per_tick": int(steps_per_tick)}

    rng = np.random.RandomState(int(seed))
    events = []
    uid = 0
    tick = 0
    bursting = False
    while uid < int(requests):
        lam = float(base_arrivals_per_tick) * (
            1.0 + float(diurnal_amp)
            * np.sin(2.0 * np.pi * tick / float(diurnal_period)))
        # the two-state modulated-Poisson burst overlay
        if bursting:
            if rng.rand() < float(burst_off):
                bursting = False
        elif rng.rand() < float(burst_on):
            bursting = True
        if bursting:
            lam *= float(burst_mult)
        for _ in range(int(rng.poisson(max(lam, 0.0)))):
            if uid >= int(requests):
                break
            plen = int(np.clip(int(rng.lognormal(
                float(prompt_mu), float(prompt_sigma))),
                int(min_prompt), int(max_prompt)))
            nnew = int(np.clip(int(float(min_new) * (
                1.0 + rng.pareto(float(output_pareto_a)))),
                int(min_new), int(max_new)))
            group = int(rng.choice(G, p=zipf_p)) \
                if rng.rand() < float(prefix_frac) else None
            tenant = t_names[int(rng.choice(len(t_names),
                                            p=t_weights))]
            sampled = rng.rand() < float(sample_frac)
            recipe = {
                "vocab": int(vocab),
                "tail_seed": (int(seed) * 2_000_003
                              + 104_729 * uid) & 0x7FFFFFFF,
                "tail_len": plen}
            if group is not None and int(prefix_len) > 0:
                recipe["prefix_seed"] = (
                    int(seed) * 1_000_003
                    + 7_919 * group) & 0x7FFFFFFF
                recipe["prefix_len"] = int(prefix_len)
                recipe["group"] = group
            events.append({
                "kind": "submit", "uid": uid,
                "step": tick * int(steps_per_tick),
                "recipe": recipe, "max_new_tokens": nnew,
                "temperature": float(temperature) if sampled else 0.0,
                "seed": 10_000 + uid if sampled else 0,
                "priority": t_prio[tenant], "tenant": tenant,
                "burst": bool(bursting)})
            uid += 1
        tick += 1
    params["horizon_ticks"] = tick
    return events, params


def write_workload(path, *, name="workload0", registry=None,
                   meta=None, **kw):
    """Generate and persist a workload journal — BYTE-reproducible:
    the same seed/params always write the same file (no wall clock,
    sorted keys, deterministic meta id). Returns the path."""
    events, params = generate_workload(**kw)
    m = {"source": "workload", "workload": params}
    m.update(meta or {})
    w = JournalWriter(path, name=name, meta=m, registry=registry,
                      wallclock=False)
    try:
        for ev in events:
            fields = {k: v for k, v in ev.items()
                      if k not in ("kind", "seq")}
            w.event(ev["kind"], **fields)
    finally:
        w.close()
    return path
