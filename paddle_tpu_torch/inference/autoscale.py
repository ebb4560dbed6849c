"""The explainable autoscaler — the port's own copy of
``paddle_tpu/inference/autoscale.py`` (host code, no JAX in either; the
port imports nothing of ``paddle_tpu``): SLO-burn-driven elastic scaling
whose every decision is an observability artifact.

The controller inputs and actuators live elsewhere —
:meth:`FleetRouter.scale_signals` (queue depths, free pages, fleet
p99 TTFT, and per-tenant SLO burn from the router's
:class:`SLOEngine`), ``join()`` / ``drain()`` as the membership levers,
and the journal as the record/replay plane. This module closes the
loop, with three properties:

- **Scale out BEFORE the SLO trips.** The multi-window burn predictor
  extrapolates each watched tenant's fast-window burn by its lead
  over the slow window (``fast + lead_gain * max(fast - slow, 0)`` —
  a rising fast window predicts where burn is headed, the classic
  fast/slow multiwindow shape run forward): the controller joins a
  replica when the PREDICTION crosses ``scale_out_burn`` (default
  0.5), well under the 1.0 where the error budget is actually gone.
  A backlog rule (total queued > ``queue_high`` per live replica)
  covers fleets without an SLO engine.
- **Never thrash.** Both directions share one actuation cooldown
  (``cooldown_steps`` on the router's ``steps_taken`` clock — NO wall
  clock anywhere, the property replay identity rests on), scale-out
  needs ``confirm_out`` consecutive firing ticks, and scale-in needs
  ``idle_steps`` consecutive idle ticks (queue at or under
  ``queue_low`` AND every burn under ``scale_in_burn``) — classic
  hysteresis: the out and in conditions cannot both hold, and an
  oscillating load inside the cooldown window produces holds, not
  flapping.
- **Every decision explains itself.** Each ``tick()`` emits a
  ``scale_out`` / ``scale_in`` / ``scale_hold`` span into the merged
  timeline carrying the exact signal snapshot, the rule that fired,
  and the counterfactual ("would have scaled out at step S absent
  cooldown" — ``counterfactual.blocked`` / ``would_act_at``); every
  decision where a rule fired ALSO lands in the journal as a
  ``scale`` event, so :func:`~paddle_tpu_torch.observability.journal.replay`
  re-drives a fresh controller through the recorded run and
  :func:`check_divergence` diffs the two decision sequences as its
  fourth identity axis. The ``autoscaler_*`` metric families
  (replica-count gauge, decisions by kind, scaling-lag histogram,
  cumulative chip-steps vs the static-N counterfactual) make the
  loop graphable, and ``paddle_tpu_torch/tools/autoscale_sim.py``
  replays any journal against alternative policies offline.

Determinism contract: call :meth:`AutoscaleController.tick` at ONE
consistent clock point (after every ``router.step()``); the decision
is then a pure function of the step clock and step-deterministic
signals. Queue depths, free pages, goodput counters and live-replica
counts are deterministic under journal replay; SLO burn is too IFF
the SLO engine runs on a step-denominated clock
(``SLOEngine(clock=lambda: float(router.steps_taken), ...)``) with
count-based objectives (``success_frac`` / ``goodput_frac``) —
wall-clock latency objectives would read real time into the decision
and break byte-identical replay (the bench and sim construct their
SLO engines accordingly). ``ttft_p99_s`` rides the journaled signal
snapshot for humans but is excluded from the identity diff.

Everything here is host-side. On the card, ``factory()`` builds a
captured engine: a factory that raises is a ``join_failed`` hold (the
decision record says so) and its exception lands in
``AutoscaleController.join_errors``, never a silent success.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

__all__ = ["AutoscalePolicy", "AutoscaleController", "SCALE_DECISIONS",
           "SCALE_LAG_BUCKETS"]

SCALE_DECISIONS = ("scale_out", "scale_in", "scale_hold")

# steps, not seconds: the lag histogram lives on the replayable clock
SCALE_LAG_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0)


@dataclass(frozen=True)
class AutoscalePolicy:
    """The knobs (module docstring has the control story).

    - ``min_replicas`` / ``max_replicas`` — the elastic range.
    - ``scale_out_burn`` — join when a watched tenant's PREDICTED
      burn crosses this (< 1.0 = act before the budget is gone);
      ``burn_lead_gain`` scales the fast-over-slow extrapolation;
      ``watch_tenants`` narrows the predictor (() = every tenant the
      SLO engine reports).
    - ``queue_high`` — join when total queued (router + engines)
      exceeds this many requests PER live replica; the rule must hold
      ``confirm_out`` consecutive ticks.
    - ``queue_low`` / ``scale_in_burn`` / ``idle_steps`` — drain
      after ``idle_steps`` consecutive ticks with total queue <=
      ``queue_low`` and every burn < ``scale_in_burn``.
    - ``cooldown_steps`` — minimum steps between ANY two actuations
      (shared by both directions)."""
    min_replicas: int = 1
    max_replicas: int = 4
    scale_out_burn: float = 0.5
    burn_lead_gain: float = 1.0
    watch_tenants: tuple = ()
    queue_high: float = 4.0
    confirm_out: int = 2
    queue_low: float = 0.0
    scale_in_burn: float = 0.25
    idle_steps: int = 48
    cooldown_steps: int = 32

    def __post_init__(self):
        if int(self.min_replicas) < 1:
            raise ValueError("min_replicas must be >= 1")
        if int(self.max_replicas) < int(self.min_replicas):
            raise ValueError("max_replicas must be >= min_replicas")
        if float(self.scale_out_burn) <= 0:
            raise ValueError("scale_out_burn must be > 0")
        if float(self.queue_high) <= float(self.queue_low):
            raise ValueError(
                "queue_high must exceed queue_low (hysteresis needs "
                "a dead band)")
        if int(self.idle_steps) < 1 or int(self.confirm_out) < 1:
            raise ValueError("idle_steps/confirm_out must be >= 1")
        if int(self.cooldown_steps) < 0:
            raise ValueError("cooldown_steps must be >= 0")

    def predicted_burn(self, windows):
        """The multi-window predictor for ONE tenant: ``{window:
        burn}`` -> fast-window burn extrapolated forward by its lead
        over the slow window. Flat or falling burn predicts itself;
        a rising fast window predicts ``fast + gain*(fast - slow)``
        — where burn is headed, not where it is."""
        if not windows:
            return 0.0
        try:
            items = sorted(windows.items(), key=lambda kv: float(kv[0]))
        except (TypeError, ValueError):
            items = sorted(windows.items())
        fast = float(items[0][1])
        slow = float(items[-1][1])
        return fast + float(self.burn_lead_gain) * max(fast - slow,
                                                       0.0)

    def to_dict(self):
        d = {k: getattr(self, k) for k in (
            "min_replicas", "max_replicas", "scale_out_burn",
            "burn_lead_gain", "queue_high", "confirm_out",
            "queue_low", "scale_in_burn", "idle_steps",
            "cooldown_steps")}
        d["watch_tenants"] = list(self.watch_tenants)
        return d


class AutoscaleController:
    """Close the loop over one :class:`FleetRouter` (module
    docstring). ``factory()`` mints a fresh replica per scale-out (a
    bare ``ServingEngine`` is wrapped and named ``<name_prefix><k>``);
    ``static_n`` is the provisioning level the chip-step
    counterfactual counter bills against (default
    ``policy.max_replicas``).

    >>> ctl = AutoscaleController(router, factory, policy)
    >>> while router.has_work: router.step(); ctl.tick()

    The controller registers itself as ``router.autoscaler`` — the
    hook :func:`check_divergence` reads a ReplayResult's decision
    sequence through."""

    _ids = itertools.count()

    def __init__(self, router, factory, policy=None, registry=None,
                 tracer=None, static_n=None, name_prefix="as"):
        self.router = router
        self.factory = factory
        self.policy = policy if policy is not None \
            else AutoscalePolicy()
        self.static_n = int(static_n) if static_n is not None \
            else int(self.policy.max_replicas)
        if self.static_n < 1:
            raise ValueError("static_n must be >= 1")
        self.registry = registry if registry is not None \
            else router.metrics
        self._tracer = tracer if tracer is not None \
            else getattr(router, "_tracer", None)
        self.name_prefix = str(name_prefix)
        self._names = itertools.count(1)
        # journaled decision sequence (actions + blocked holds — the
        # fourth divergence axis); quiet holds are span/metric-only
        self.decisions = []
        self.replica_trace = []       # (step, live) on every change
        self.chip_steps = 0           # live+draining replica-steps
        self.chip_steps_static = 0    # the static-N counterfactual
        self.replica_steps = {}       # name -> steps while active
        self.join_errors = []         # (step, repr) of a failed join
        self.stats = {"ticks": 0, "scale_out": 0, "scale_in": 0,
                      "scale_hold": 0, "blocked_cooldown": 0,
                      "blocked_limit": 0, "lag_max": 0}
        self._last_action_step = None
        self._out_run = 0             # consecutive out-rule ticks
        self._out_since = None        # first step of the current run
        self._idle_run = 0
        self._idle_since = None
        reg = self.registry
        self._g_replicas = reg.gauge(
            "autoscaler_replicas",
            "live replicas as last seen by the autoscale controller")
        self._c_dec = reg.counter(
            "autoscaler_decisions_total",
            "autoscaler decisions by kind (scale_out / scale_in / "
            "scale_hold) — one per controller tick",
            labels=("kind",))
        for k in SCALE_DECISIONS:
            self._c_dec.labels(kind=k).inc(0)
        self._h_lag = reg.histogram(
            "autoscaler_scaling_lag_steps",
            "steps between a scaling rule first firing and the "
            "actuation it produced (confirm windows + cooldown both "
            "count — the demand-to-capacity delay)",
            buckets=SCALE_LAG_BUCKETS)
        self._c_chip = reg.counter(
            "autoscaler_chip_steps_total",
            "cumulative replica-steps actually provisioned (live + "
            "draining replicas per router step — the step-"
            "denominated chip-seconds bill)")
        self._c_chip_static = reg.counter(
            "autoscaler_chip_steps_static_total",
            "the static-N counterfactual bill: what the same run "
            "would have provisioned at a fixed static_n replicas")
        self._c_chip.inc(0)
        self._c_chip_static.inc(0)
        self._g_replicas.set(len(router.live_replicas()))
        self.replica_trace.append((router.steps_taken,
                                   len(router.live_replicas())))
        router.autoscaler = self

    # -- rule evaluation -----------------------------------------------------
    def _burn_fire(self, signals):
        """(predicted burn, tenant) of the worst watched tenant."""
        pol = self.policy
        watch = set(pol.watch_tenants or ())
        best = (0.0, None)
        for t, wins in (signals.get("tenant_burn") or {}).items():
            if watch and t not in watch:
                continue
            p = pol.predicted_burn(wins)
            if p > best[0]:
                best = (p, t)
        return best

    def _cooldown_left(self, step):
        if self._last_action_step is None:
            return 0
        left = self.policy.cooldown_steps \
            - (step - self._last_action_step)
        return max(left, 0)

    def _drain_victim(self):
        """The most recently joined live replica (router.replicas is
        insertion-ordered) — LIFO scale-in keeps the long-lived base
        replicas' prefix caches warm."""
        live = [nm for nm, st in self.router.replicas.items()
                if st.status == "live"]
        return live[-1] if live else None

    # -- the control loop ----------------------------------------------------
    def tick(self):
        """One decision, on the router's step clock. Returns the
        decision record (also appended to :attr:`decisions` when a
        rule fired)."""
        r = self.router
        pol = self.policy
        if r.slo is not None:
            try:
                r.slo.evaluate()
            except Exception:
                pass   # the control loop must never take down serving
        sig = r.scale_signals()
        step = r.steps_taken
        live = int(sig["live_replicas"])
        self.stats["ticks"] += 1
        # chip-step accounting: every replica still doing work bills,
        # draining included — scale-in does not refund in-flight work
        active = [st for st in r.replicas.values()
                  if st.status in ("live", "draining")]
        self.chip_steps += len(active)
        self.chip_steps_static += self.static_n
        self._c_chip.inc(len(active))
        self._c_chip_static.inc(self.static_n)
        for st in active:
            self.replica_steps[st.name] = \
                self.replica_steps.get(st.name, 0) + 1

        queue = int(sig["router_queue_depth"]) \
            + int(sig["engine_queue_depth"])
        pred_burn, burn_tenant = self._burn_fire(sig)
        burn_fire = pred_burn >= pol.scale_out_burn
        queue_fire = queue > pol.queue_high * max(live, 1)
        out_rule = "out:burn" if burn_fire else (
            "out:queue" if queue_fire else None)
        if out_rule:
            if self._out_run == 0:
                self._out_since = step
            self._out_run += 1
        else:
            self._out_run = 0
            self._out_since = None
        idle = queue <= pol.queue_low \
            and float(sig.get("max_burn") or 0.0) < pol.scale_in_burn
        if idle:
            if self._idle_run == 0:
                self._idle_since = step
            self._idle_run += 1
        else:
            self._idle_run = 0
            self._idle_since = None

        decision, rule, replica = "scale_hold", "none", None
        blocked = None
        wanted_since = None
        cooldown_left = self._cooldown_left(step)
        if out_rule and self._out_run >= pol.confirm_out:
            rule = out_rule
            wanted_since = self._out_since
            if live >= pol.max_replicas:
                blocked = "max_replicas"
                self.stats["blocked_limit"] += 1
            elif cooldown_left > 0:
                blocked = "cooldown"
                self.stats["blocked_cooldown"] += 1
            else:
                replica = self._join(step)
                if replica is not None:
                    decision = "scale_out"
                else:
                    blocked = "join_failed"
        elif idle and self._idle_run >= pol.idle_steps \
                and live > pol.min_replicas:
            rule = "in:idle"
            wanted_since = self._idle_since
            if cooldown_left > 0:
                blocked = "cooldown"
                self.stats["blocked_cooldown"] += 1
            else:
                replica = self._drain(step)
                if replica is not None:
                    decision = "scale_in"
                else:
                    blocked = "drain_failed"

        lag = None
        if decision != "scale_hold":
            self._last_action_step = step
            lag = step - (wanted_since if wanted_since is not None
                          else step)
            self._h_lag.observe(float(lag))
            self.stats["lag_max"] = max(self.stats["lag_max"], lag)
            self._out_run = 0
            self._out_since = None
            self._idle_run = 0
            self._idle_since = None
        counterfactual = {
            # the explainable "why not": what this tick WOULD have
            # done absent the binding constraint, and since when
            "blocked": blocked,
            "would": (None if rule == "none" else
                      ("scale_out" if rule.startswith("out") else
                       "scale_in")) if decision == "scale_hold"
            else None,
            "would_act_at": wanted_since if blocked else None,
            "cooldown_left": cooldown_left if blocked == "cooldown"
            else 0,
            "wanted_since": wanted_since,
            "lag_steps": lag,
            "predicted_burn": round(pred_burn, 6),
            "burn_tenant": burn_tenant}
        live_after = len(r.live_replicas())
        rec = {"step": step, "decision": decision, "rule": rule,
               "replica": replica, "replicas_before": live,
               "replicas_after": live_after,
               "signals": _jsonable_signals(sig),
               "counterfactual": counterfactual}
        self.stats[decision] += 1
        self._c_dec.labels(kind=decision).inc()
        self._g_replicas.set(live_after)
        if self.replica_trace[-1][1] != live_after:
            self.replica_trace.append((step, live_after))
        self._span(rec)
        if rule != "none":
            # actions and blocked holds are the DECISION SEQUENCE —
            # journaled (the fourth divergence axis) and retained;
            # quiet holds stay span/metric-only
            self.decisions.append(rec)
            r._journal_event(
                "scale", step=step, decision=decision, rule=rule,
                replica=replica, replicas_before=live,
                replicas_after=live_after,
                signals=rec["signals"],
                counterfactual=counterfactual)
        return rec

    # -- actuation -----------------------------------------------------------
    def _join(self, step):
        try:
            handle = self.factory()
            if not hasattr(handle, "step") \
                    or not hasattr(handle, "name"):
                from .router import EngineReplica
                handle = EngineReplica(
                    handle,
                    f"{self.name_prefix}{next(self._names)}")
            return self.router.join(handle, source="autoscaler")
        except Exception as e:
            self.join_errors.append((step, repr(e)[:500]))
            return None

    def _drain(self, step):
        nm = self._drain_victim()
        if nm is None:
            return None
        try:
            self.router.drain(nm, source="autoscaler")
            return nm
        except Exception:
            return None

    def _span(self, rec):
        """Every tick is a completed decision trace in the merged
        timeline (the drain/join/slo_alert pattern) carrying the full
        snapshot + counterfactual — the autoscaler's observability
        contract, validated by tools/trace_check.py."""
        if self._tracer is None:
            return
        try:
            tid = (f"{self.router.name}:{rec['decision']}:"
                   f"{next(AutoscaleController._ids)}")
            self._tracer.start_trace(
                rec["decision"], trace_id=tid, step=rec["step"],
                rule=rec["rule"], replica=rec["replica"] or "",
                replicas_before=rec["replicas_before"],
                replicas_after=rec["replicas_after"],
                signals=rec["signals"],
                counterfactual=rec["counterfactual"])
            self._tracer.end_trace(tid)
        except Exception:
            pass

    # -- reporting -----------------------------------------------------------
    def chip_steps_saved_frac(self):
        """Fraction of the static-N bill the elastic fleet did not
        pay (0.0 when nothing ticked yet)."""
        if self.chip_steps_static <= 0:
            return 0.0
        return 1.0 - self.chip_steps / self.chip_steps_static

    def conservation(self):
        """The chip-step ledger must balance: the cumulative bill ==
        the sum of per-replica bills, by construction — a broken
        invariant means the accounting (not the fleet) regressed."""
        per_replica = sum(self.replica_steps.values())
        return {"chip_steps": self.chip_steps,
                "per_replica_sum": per_replica,
                "conserved": per_replica == self.chip_steps}

    def report(self):
        """The bench/sim summary: decisions, chip-step bill vs the
        static-N counterfactual, lag, and the replica-count trace."""
        return {
            "policy": self.policy.to_dict(),
            "static_n": self.static_n,
            "ticks": self.stats["ticks"],
            "decisions": {k: self.stats[k] for k in SCALE_DECISIONS},
            "blocked_cooldown": self.stats["blocked_cooldown"],
            "blocked_limit": self.stats["blocked_limit"],
            "scaling_lag_max_steps": self.stats["lag_max"],
            "chip_steps": self.chip_steps,
            "chip_steps_static": self.chip_steps_static,
            "chip_steps_saved_frac": round(
                self.chip_steps_saved_frac(), 6),
            "replica_trace": list(self.replica_trace),
            "max_replicas_seen": max(
                (n for _, n in self.replica_trace), default=0),
            "conservation": self.conservation(),
            "journaled_decisions": len(self.decisions)}


def _jsonable_signals(sig):
    """The journal/span form of a scale_signals() snapshot: plain
    floats/ints/None (numpy scalars stripped), nested burn map
    copied."""
    out = {}
    for k, v in sig.items():
        if k == "tenant_burn":
            out[k] = {t: {str(w): float(b) for w, b in wins.items()}
                      for t, wins in (v or {}).items()}
        elif v is None:
            out[k] = None
        elif isinstance(v, (int, float)):
            out[k] = round(float(v), 6) if isinstance(v, float) \
                else int(v)
        else:
            out[k] = float(v) if hasattr(v, "__float__") else v
    return out
