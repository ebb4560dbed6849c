"""Per-request latency anatomy — port of
``paddle_tpu/observability/anatomy.py`` (pure bookkeeping, kept as the
port's own copy): where did every step of a request's life go? A
deterministic decomposition of each request's admission→finish
interval into an exact segment ledger, pinned by conservation:

    sum(segments) == finish_step - submit_step        (EXACTLY)

Time is **step-denominated** — the same convention the autoscaler and
the journal use: wall-clock rides alongside for humans but is excluded
from identity, so a replay reproduces every sequence byte-identically
and the divergence checker can gate on it (its fifth axis).

Segment taxonomy (``SEGMENTS``):

- ``queued`` — engine admission queue (a request waiting for a slot).
- ``prefill`` — steps whose dispatch ran this request's prefill chunks.
- ``decode_compute`` — ready-to-decode steps whose dispatch carried no
  prefill (pure decode: the request got the step it was owed).
- ``decode_blocked`` — ready-to-decode steps whose dispatch ALSO
  carried prefill rows (mixed-step interference: the decode row shared
  its dispatch with someone else's prefill; legacy engines block when
  ``_run_prefill_chunks`` ran in the same ``_step``). This is the
  number disaggregated prefill/decode is measured against: it
  succeeds when gold-tier ``decode_blocked_frac`` goes to ~0.
- ``preempted`` — ejected to the engine queue's preempted lane,
  waiting to resume (same-engine preempt/resume).
- ``migrated`` — in flight between replicas after a cross-replica
  eject (remote preemption / drain), waiting for re-placement.
- ``rerun`` — waiting for a from-scratch re-placement after a replica
  death (the deterministic rerun).
- ``handoff`` — router-tier wait before the FIRST placement (the
  router's own admission queue; engine-side queue time is ``queued``
  — each tier reports its own truth).

Two ledgers implement one ownership invariant — *every live request is
counted by exactly one party each step*:

- :class:`AnatomyLedger` (engine): a per-step sweep at the very top of
  ``ServingEngine._step`` attributes one step to every live record by
  its state at step start. Decode-state records are *deferred* into a
  pending set and resolved to ``decode_blocked``/``decode_compute``
  once the dispatch composition is known (``resolve_decode``), so the
  attribution is per-row exact, not inferred after the fact.
  Conservation is exact **by construction**: submit/finish land
  between steps, and every step in (submit, finish] is swept once.
- :class:`RouterAnatomy` (router): formula-based pending windows — no
  sweep. While a request is placed, its engine counts the steps; while
  it is router-held (pre-placement, mid-migration, post-death) the
  router closes the window arithmetically with the tag of *why* it was
  unplaced. Engine segment runs are spliced into the router sequence
  at each unplacement/completion, so the router-level record is the
  request's full life across replicas on the router's step clock.

Sequences are run-length compressed — ``[["queued", 3], ["prefill",
2], ...]`` in chronological order — which is what rides the journal's
``complete`` events (the replay identity payload) and the SLO burn
exemplars.

The module is registry-free pure bookkeeping; ``serving.py`` owns the ``serving_segment_steps{segment}`` histogram and
``serving_decode_blocked_frac`` gauge fed from these records.
"""
from __future__ import annotations

import math
from collections import deque

__all__ = ["SEGMENTS", "ROUTER_SEGMENTS", "SEGMENT_STEP_BUCKETS",
           "AnatomyLedger", "RouterAnatomy", "segment_totals",
           "summarize", "records_from_journal", "exemplars"]

SEGMENTS = ("queued", "prefill", "decode_compute", "decode_blocked",
            "preempted", "migrated", "rerun", "handoff")

# the pending-window tags RouterAnatomy may close a window with
ROUTER_SEGMENTS = ("handoff", "migrated", "rerun")

# step-count buckets for serving_segment_steps (DEFAULT_BUCKETS are
# latency seconds — wrong unit for integer step counts)
SEGMENT_STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0)

# engine scheduler state -> swept segment; "decode" is deliberately
# absent: decode steps defer to resolve_decode() for the
# blocked/compute split
_STATE_SEGMENT = {"queued": "queued", "prefill": "prefill",
                  "preempted": "preempted"}


def _append(seq, seg, n=1):
    """Append ``n`` steps of ``seg`` to an RLE sequence in place,
    merging with the tail run when the segment repeats."""
    if n <= 0:
        return
    if seq and seq[-1][0] == seg:
        seq[-1][1] += int(n)
    else:
        seq.append([seg, int(n)])


def _extend(seq, runs):
    """Splice another RLE sequence onto ``seq`` (RouterAnatomy folding
    an engine run into the fleet-level record)."""
    for run in runs or ():
        _append(seq, run[0], int(run[1]))


def segment_totals(seq):
    """RLE sequence -> {segment: steps} with every segment present
    (zeros included — the histogram policy observes all eight so
    per-segment counts stay comparable across segments)."""
    out = {s: 0 for s in SEGMENTS}
    for seg, n in seq or ():
        out[seg] = out.get(seg, 0) + int(n)
    return out


def _blocked_frac(totals):
    den = totals.get("decode_blocked", 0) + totals.get(
        "decode_compute", 0)
    return totals.get("decode_blocked", 0) / den if den else 0.0


class _AnatomyStore:
    """Completed-record storage shared by both ledgers: a bounded ring
    plus a uid index (evicted in lockstep so the index never leaks)."""

    def __init__(self, capacity=1024):
        self.completed = deque(maxlen=int(capacity))
        self._by_uid = {}

    def _commit(self, uid, meta, seq, finish_step, outcome):
        totals = segment_totals(seq)
        total = sum(totals.values())
        submit = meta.get("submit_step")
        synthetic = submit is None
        if synthetic:
            # defensive auto-create (finish for an unknown uid): pin
            # submit so the conservation check stays clean and the
            # record is flagged as reconstructed
            submit = int(finish_step) - total
        rec = {"uid": int(uid), "tenant": meta.get("tenant", "default"),
               "priority": int(meta.get("priority", 0)),
               "trace_id": meta.get("trace_id", ""),
               "submit_step": int(submit),
               "finish_step": int(finish_step),
               "outcome": str(outcome),
               "segments": [[s, int(n)] for s, n in seq],
               "totals": totals, "total_steps": int(total),
               "conserved": total == int(finish_step) - int(submit),
               "blocked_frac": _blocked_frac(totals)}
        if synthetic:
            rec["synthetic"] = True
        if len(self.completed) == self.completed.maxlen:
            self._by_uid.pop(self.completed[0]["uid"], None)
        self.completed.append(rec)
        self._by_uid[rec["uid"]] = rec
        return rec

    def record_of(self, uid):
        return self._by_uid.get(int(uid))

    def request_records(self):
        """Completed anatomy records, oldest first (the ring's view)."""
        return list(self.completed)

    def conservation_check(self):
        recs = self.request_records()
        ok = sum(1 for r in recs if r["conserved"])
        return {"checked": len(recs), "conserved": ok,
                "frac": ok / len(recs) if recs else 1.0}

    def worst(self, k=3, tenant=None):
        return exemplars(self.request_records(), k=k, tenant=tenant)

    def close(self):
        self.completed.clear()
        self._by_uid.clear()


class AnatomyLedger(_AnatomyStore):
    """Engine-side anatomy: swept once per ``_step`` (state at step
    start), decode steps resolved per-dispatch.

    Call order inside the engine:

    - ``register(uid, ..., step=journal_steps)`` at add_request /
      admit_migrated (always between steps).
    - ``note_state(uid, state)`` on every scheduler transition
      (queued→prefill at admit, prefill→decode at activate,
      decode→preempted at requeue). Never touches the pending set —
      a mid-step transition must not drop the step the sweep already
      owes the record.
    - ``on_step()`` at the VERY TOP of ``_step`` (before fault
      injection, so a death step is still counted).
    - ``resolve_decode(blocked)`` once the dispatch composition is
      known; idempotent — the end-of-step safety net re-calls it with
      ``False`` for steps whose dispatch never ran.
    - ``finish(uid, step, outcome)`` at every terminal event
      (completion, shed, deadline, cancel, abort, eject)."""

    def __init__(self, capacity=1024):
        super().__init__(capacity)
        self._live = {}             # uid -> live record
        self._pending_decode = set()
        self.blocked_steps = 0      # cumulative, feeds the gauge
        self.compute_steps = 0

    @property
    def live(self):
        return len(self._live)

    def register(self, uid, tenant="default", priority=0, trace_id="",
                 step=0):
        uid = int(uid)
        self._pending_decode.discard(uid)   # defensive: uids are
        #                                     monotonic, never recycled
        self._live[uid] = {"tenant": str(tenant or "default"),
                           "priority": int(priority),
                           "trace_id": str(trace_id or ""),
                           "submit_step": int(step),
                           "state": "queued", "seq": []}

    def note_state(self, uid, state):
        rec = self._live.get(int(uid))
        if rec is not None:
            rec["state"] = state

    def on_step(self):
        """Attribute one step to every live record by its state at
        step start; decode-state records defer to resolve_decode."""
        for uid, rec in self._live.items():
            seg = _STATE_SEGMENT.get(rec["state"])
            if seg is not None:
                _append(rec["seq"], seg)
            else:
                self._pending_decode.add(uid)

    def resolve_decode(self, blocked):
        """Close this step's deferred decode attributions: ``blocked``
        iff the same dispatch carried prefill rows."""
        if not self._pending_decode:
            return
        seg = "decode_blocked" if blocked else "decode_compute"
        for uid in self._pending_decode:
            rec = self._live.get(uid)
            if rec is not None:
                _append(rec["seq"], seg)
                if blocked:
                    self.blocked_steps += 1
                else:
                    self.compute_steps += 1
        self._pending_decode.clear()

    def finish(self, uid, step, outcome):
        """Terminal event; returns the completed record (None when the
        uid was never registered — the record is then synthesized
        empty so downstream consumers still see the finish)."""
        uid = int(uid)
        rec = self._live.pop(uid, None)
        if uid in self._pending_decode:
            # finished mid-step before the dispatch resolved (abort /
            # fault teardown): the swept step deterministically counts
            # as compute — the request was decode-ready and no mixed
            # attribution was ever published for it
            self._pending_decode.discard(uid)
            if rec is not None:
                _append(rec["seq"], "decode_compute")
                self.compute_steps += 1
        meta = rec if rec is not None else {}
        return self._commit(uid, meta, meta.get("seq", []), step,
                            outcome)

    def extract(self, uid):
        """Pop a live record's partial sequence (replica death: the
        router splices it into the fleet-level record as the dead
        placement's run). Pending decode resolves to compute — the
        death step was swept but its dispatch never published."""
        uid = int(uid)
        rec = self._live.pop(uid, None)
        if uid in self._pending_decode:
            self._pending_decode.discard(uid)
            if rec is not None:
                _append(rec["seq"], "decode_compute")
                self.compute_steps += 1
        return rec["seq"] if rec is not None else []

    def sequence_of(self, uid):
        """RLE segment sequence for a completed uid (None when
        unknown) — the journal ``complete`` payload."""
        rec = self._by_uid.get(int(uid))
        return None if rec is None else [list(r) for r in
                                         rec["segments"]]

    def blocked_frac(self):
        """Cumulative decode interference: blocked / (blocked +
        compute) over every decode step this engine ever attributed."""
        den = self.blocked_steps + self.compute_steps
        return self.blocked_steps / den if den else 0.0

    def close(self):
        super().close()
        self._live.clear()
        self._pending_decode.clear()


class RouterAnatomy(_AnatomyStore):
    """Fleet-level anatomy on the router's step clock. No sweep:
    router-held intervals close arithmetically as pending windows.

    The ownership invariant: each router step, each live request is
    counted either by the engine it is placed on (its segment runs are
    spliced in at unplacement/completion) or by the open router window
    (``handoff`` before first placement, ``migrated`` after a
    cross-replica eject, ``rerun`` after a replica death). ``counted``
    at :meth:`note_unplaced` says whether the engine already counted
    the CURRENT router step (drain/death: yes — the engine swept it;
    mid-dispatch eject: no — engines step after dispatch), which pins
    the window base so no step is counted twice or dropped."""

    def __init__(self, capacity=1024):
        super().__init__(capacity)
        self._live = {}     # uid -> live record

    @property
    def live(self):
        return len(self._live)

    def register(self, uid, tenant="default", priority=0, trace_id="",
                 step=0):
        self._live[int(uid)] = {
            "tenant": str(tenant or "default"),
            "priority": int(priority),
            "trace_id": str(trace_id or ""),
            "submit_step": int(step), "seq": [],
            "pending_tag": "handoff", "pending_since": int(step)}

    def note_placed(self, uid, step):
        """Placement at router step ``step``: the engine counts this
        step onward, so the window closes at ``step - 1``."""
        rec = self._live.get(int(uid))
        if rec is None or rec["pending_tag"] is None:
            return
        _append(rec["seq"], rec["pending_tag"],
                int(step) - 1 - rec["pending_since"])
        rec["pending_tag"] = None

    def note_unplaced(self, uid, step, tag, engine_segments=(),
                      counted=True):
        """The placement ended without completing (eject / death):
        splice the engine's run in and open a ``tag`` window.
        ``counted`` — did the engine already count router step
        ``step``?"""
        rec = self._live.get(int(uid))
        if rec is None:
            return
        _extend(rec["seq"], engine_segments)
        rec["pending_tag"] = str(tag)
        rec["pending_since"] = int(step) if counted else int(step) - 1

    def finish(self, uid, step, outcome, engine_segments=None):
        """Terminal event at router step ``step``. Placed completions
        pass the engine's run; unplaced terminals close the open
        window."""
        uid = int(uid)
        rec = self._live.pop(uid, None)
        if rec is None:
            return self._commit(uid, {}, [], step, outcome)
        if rec["pending_tag"] is None:
            _extend(rec["seq"], engine_segments)
        else:
            _append(rec["seq"], rec["pending_tag"],
                    int(step) - rec["pending_since"])
        return self._commit(uid, rec, rec["seq"], step, outcome)

    def sequence_of(self, uid):
        rec = self._by_uid.get(int(uid))
        return None if rec is None else [list(r) for r in
                                         rec["segments"]]


# -- shared summaries (bench_serving prints through this code path) --

def _pctl(xs, q):
    """Deterministic percentile over a small sample: the ceil-rank
    order statistic (no interpolation — replay-stable)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return float(xs[max(0, math.ceil(q * len(xs)) - 1)])


def _group_summary(records):
    seg_steps = {s: [] for s in SEGMENTS}
    totals, bfracs = [], []
    for r in records:
        for s in SEGMENTS:
            seg_steps[s].append(r["totals"].get(s, 0))
        totals.append(r["total_steps"])
        bfracs.append(r["blocked_frac"])
    blocked = sum(r["totals"].get("decode_blocked", 0)
                  for r in records)
    compute = sum(r["totals"].get("decode_compute", 0)
                  for r in records)
    return {
        "requests": len(records),
        "segments": {s: {"p50": _pctl(v, 0.50),
                         "p99": _pctl(v, 0.99),
                         "total": int(sum(v))}
                     for s, v in seg_steps.items()},
        "total_steps_p50": _pctl(totals, 0.50),
        "total_steps_p99": _pctl(totals, 0.99),
        "decode_blocked_frac": (blocked / (blocked + compute)
                                if blocked + compute else 0.0),
        "decode_blocked_frac_p99": _pctl(bfracs, 0.99)}


def summarize(records):
    """Per-segment p50/p99 step decomposition: overall, per tenant,
    per priority tier — plus the conservation tally."""
    records = list(records)
    by_tenant, by_tier = {}, {}
    for r in records:
        by_tenant.setdefault(r.get("tenant", "default"),
                             []).append(r)
        by_tier.setdefault(int(r.get("priority", 0)), []).append(r)
    ok = sum(1 for r in records if r.get("conserved"))
    return {
        "overall": _group_summary(records),
        "by_tenant": {t: _group_summary(v)
                      for t, v in sorted(by_tenant.items())},
        "by_tier": {p: _group_summary(v)
                    for p, v in sorted(by_tier.items())},
        "conservation": {"checked": len(records), "conserved": ok,
                         "frac": ok / len(records) if records
                         else 1.0}}


def records_from_journal(events):
    """Join a journal's ``submit`` and ``complete`` events into
    canonical anatomy records (completes without a ``segments`` field
    — pre-anatomy journals — are skipped). ``events``: an iterable of
    event dicts (``JournalReader.events()`` or a loaded list)."""
    submits, out = {}, []
    for e in events:
        kind = e.get("kind")
        if kind == "submit":
            submits[int(e["uid"])] = e
        elif kind == "complete" and e.get("segments") is not None:
            uid = int(e["uid"])
            sub = submits.get(uid, {})
            seq = [[str(s), int(n)] for s, n in e["segments"]]
            totals = segment_totals(seq)
            total = sum(totals.values())
            submit_step = int(sub.get("step",
                                      int(e.get("step", 0)) - total))
            out.append({
                "uid": uid,
                "tenant": str(sub.get("tenant") or "default"),
                "priority": int(sub.get("priority") or 0),
                "trace_id": str(e.get("trace_id")
                                or sub.get("trace_id") or ""),
                "submit_step": submit_step,
                "finish_step": int(e.get("step", 0)),
                "outcome": str(e.get("finish_reason", "")),
                "segments": seq, "totals": totals,
                "total_steps": total,
                "conserved": total == int(e.get("step", 0))
                - submit_step,
                "blocked_frac": _blocked_frac(totals)})
    return out


def exemplars(records, k=3, tenant=None):
    """The k worst anatomies by total steps (optionally one tenant's)
    — what a burn alert attaches so 'p99 is on fire' comes with the
    trace ids and the segment breakdown that say why."""
    pool = [r for r in records
            if tenant is None or r.get("tenant") == tenant]
    pool.sort(key=lambda r: (-r["total_steps"], r["uid"]))
    return [{"uid": r["uid"], "trace_id": r.get("trace_id", ""),
             "tenant": r.get("tenant", "default"),
             "priority": int(r.get("priority", 0)),
             "total_steps": r["total_steps"],
             "blocked_frac": round(r.get("blocked_frac", 0.0), 6),
             "segments": [list(s) for s in r.get("segments") or []]}
            for r in pool[:int(k)]]
