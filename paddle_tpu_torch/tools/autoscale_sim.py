#!/usr/bin/env python3
"""What-if autoscaling simulator — port of ``tools/autoscale_sim.py``:
replay a recorded journal's arrival schedule against ALTERNATIVE
policies offline and print a per-policy chip-steps / burn / lag
comparison table.

    python3 -m paddle_tpu_torch.tools.autoscale_sim wl.jsonl
        [--max-replicas 4] [--slots 4] [--target-wait 16]
        [--policy default|aggressive|conservative ...] [--json]

The sim is the real control plane over a simulated data plane: the
port's FleetRouter and AutoscaleController run every leg (the same
routing, journaling and decision code the bench measures), but the
replicas are deterministic queue/slot simulators that decode one token
per step — no model and no card, so a policy sweep over a
million-step journal takes seconds. Burn is a simulated gold-tier wait
objective (worst queued-gold age / ``--target-wait`` on the step clock,
fast window instantaneous, slow window a running mean), the kind of
count/step-denominated signal the live controller keys on — wall-clock
objectives would make the what-if unreproducible.

Any journal with ``submit`` events drives it: a generated workload
(``bench_serving --gen-workload``), a recorded bench window, or a
production recording. Policies compared: ``static-1`` / ``static-N``
(no controller — the provisioning bookends), ``default``,
``aggressive`` (low thresholds, short cooldown), ``conservative``
(high thresholds, long cooldown). Exits 1 when a leg's chip-step
accounting does not balance.
"""
import argparse
import itertools
import json
import sys

from ..inference import AutoscaleController, AutoscalePolicy, FleetRouter
from ..inference.serving import Completion
from ..observability import MetricsRegistry
from ..observability import journal as jnl


class SimReplica:
    """Deterministic stand-in for one serving replica: ``num_slots``
    concurrent requests, one decoded token per slot per step, queued
    work admitted in arrival order."""

    page_size = 8

    def __init__(self, name, num_slots=4, pages=256):
        self.name = str(name)
        self.num_slots = int(num_slots)
        self.pages = int(pages)
        self._uid = itertools.count(1)
        self._pending = []            # [uid, kw]
        self._slots = {}              # uid -> [tokens_left, kw]
        self.metrics = MetricsRegistry()
        self._g_q = self.metrics.gauge("serving_queue_depth",
                                       "queued requests")
        self._g_p = self.metrics.gauge("serving_pages_free",
                                       "claimable pages")
        self._gauges()

    def _gauges(self):
        self._g_q.set(len(self._pending))
        self._g_p.set(self.pages - 4 * len(self._slots))

    def add_request(self, **kw):
        uid = next(self._uid)
        self._pending.append([uid, kw])
        self._gauges()
        return uid

    def admit_migrated(self, req, trace_ctx=None):
        return self.add_request(**req.kw)

    def eject(self, uid):
        class _R:
            resume_out = []
        for i, (u, kw) in enumerate(self._pending):
            if u == int(uid):
                del self._pending[i]
                self._gauges()
                r = _R()
                r.kw = kw
                return r
        _, kw = self._slots.pop(int(uid))
        self._gauges()
        r = _R()
        r.kw = kw
        return r

    def cancel(self, uid):
        self.eject(uid)

    def step(self):
        while self._pending and len(self._slots) < self.num_slots:
            uid, kw = self._pending.pop(0)
            self._slots[uid] = [int(kw.get("max_new_tokens", 1)), kw]
        done = []
        for uid, rec in list(self._slots.items()):
            rec[0] -= 1
            if rec[0] <= 0:
                kw = rec[1]
                n = int(kw.get("max_new_tokens", 1))
                del self._slots[uid]
                done.append(Completion(
                    uid=uid, tokens=[1] * n, finish_reason="length",
                    ttft_s=None, priority=int(kw.get("priority", 0)),
                    tenant=kw.get("tenant") or "default"))
        self._gauges()
        return done

    def inflight(self):
        out = [{"uid": u, "priority": int(kw.get("priority", 0)),
                "tenant": kw.get("tenant") or "default", "seq": u,
                "queued": True, "tokens_out": 0}
               for u, kw in self._pending]
        out.extend({"uid": u, "priority": int(kw.get("priority", 0)),
                    "tenant": kw.get("tenant") or "default", "seq": u,
                    "queued": False, "tokens_out": 0}
                   for u, (left, kw) in self._slots.items())
        return out

    @property
    def queue_depth(self):
        return len(self._pending)

    @property
    def free_pages(self):
        return self.pages - 4 * len(self._slots)

    @property
    def has_work(self):
        return bool(self._pending or self._slots)

    def snapshot(self):
        return self.metrics.snapshot()

    def config_fingerprint(self):
        return {"kind": "sim_replica", "num_slots": self.num_slots,
                "page_size": self.page_size, "pages": self.pages}

    def close(self):
        pass


class SimSLO:
    """Simulated gold-wait burn on the step clock: the worst queued
    gold request's age (router queue + replica queues) over
    ``target_wait`` steps is the fast-window burn; the slow window is
    the running mean of the fast series. Burn 1.0 == a gold request
    has waited its whole budget."""

    def __init__(self, router, tenant="gold", target_wait=16):
        self.router = router
        self.tenant = str(tenant)
        self.target_wait = float(target_wait)
        self._first_seen = {}
        self._fast = 0.0
        self._sum = 0.0
        self._n = 0
        self.burn_max = 0.0

    def _queued_uids(self):
        for rr in list(self.router._queue):
            if rr.tenant == self.tenant:
                yield ("r", rr.uid)
        for st in self.router.replicas.values():
            if st.status not in ("live", "draining"):
                continue
            for v in st.handle.inflight():
                if v["queued"] and v["tenant"] == self.tenant:
                    yield (st.name, v["uid"])

    def evaluate(self):
        step = self.router.steps_taken
        live = set()
        worst = 0
        for key in self._queued_uids():
            live.add(key)
            t0 = self._first_seen.setdefault(key, step)
            worst = max(worst, step - t0)
        for key in list(self._first_seen):
            if key not in live:
                del self._first_seen[key]
        self._fast = worst / self.target_wait
        self._sum += self._fast
        self._n += 1
        self.burn_max = max(self.burn_max, self._fast)

    def report(self):
        slow = self._sum / self._n if self._n else 0.0
        return {"slos": [{
            "slo": f"{self.tenant}-wait-sim", "tenant": self.tenant,
            "tier": self.tenant,
            "burn": {"8": self._fast, "64": slow}}]}


POLICIES = {
    "default": dict(),
    "aggressive": dict(scale_out_burn=0.3, queue_high=2.0,
                       confirm_out=1, idle_steps=16,
                       cooldown_steps=8),
    "conservative": dict(scale_out_burn=0.9, queue_high=8.0,
                         confirm_out=4, idle_steps=96,
                         cooldown_steps=64),
}


def run_leg(events, *, n0, max_n, slots, target_wait, policy=None,
            max_tail=2000):
    """One policy leg over the recorded schedule. ``policy=None`` is
    a static fleet of ``n0`` replicas (no controller)."""
    made = itertools.count(0)

    def mk():
        return SimReplica(f"s{next(made)}", num_slots=slots)

    router = FleetRouter([mk() for _ in range(n0)],
                         registry=MetricsRegistry(), name="sim0")
    slo = SimSLO(router, target_wait=target_wait)
    router.slo = slo
    ctl = None
    if policy is not None:
        ctl = AutoscaleController(router, mk, policy,
                                  static_n=max_n)
    else:
        # static legs still need the burn series evaluated each tick
        pass

    def on_tick(_k):
        if ctl is None:
            slo.evaluate()

    res = jnl.replay(events, router, controller=ctl,
                     on_tick=on_tick)
    floor = policy.min_replicas if policy is not None else 0
    for _ in range(max_tail):
        if ctl is None or len(router.live_replicas()) <= floor:
            break
        router.step()
        ctl.tick()
    ticks = router.steps_taken
    if ctl is not None:
        rep = ctl.report()
        out = {"chip_steps": rep["chip_steps"],
               "lag": rep["scaling_lag_max_steps"],
               "actions": rep["decisions"]["scale_out"]
               + rep["decisions"]["scale_in"],
               "peak": rep["max_replicas_seen"],
               "conserved": rep["conservation"]["conserved"]}
    else:
        out = {"chip_steps": n0 * ticks, "lag": 0, "actions": 0,
               "peak": n0, "conserved": True}
    out.update({
        "ticks": ticks, "burn_max": round(slo.burn_max, 3),
        "completed": len(res.completions),
        "rejected": len(res.rejected)})
    router.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("journal", help="any journal with submit events "
                    "(workload file or recorded window)")
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4,
                    help="slots per simulated replica")
    ap.add_argument("--target-wait", type=int, default=16,
                    help="gold queue-wait budget in steps (burn 1.0 "
                         "== a gold request waited this long)")
    ap.add_argument("--policy", action="append", default=None,
                    choices=sorted(POLICIES),
                    help="elastic legs to run (repeatable; default: "
                         "all)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per leg instead of the table")
    args = ap.parse_args(argv)

    rd = jnl.JournalReader(args.journal)
    events = [e for e in rd.events if e.get("kind") == "submit"]
    if not events:
        raise SystemExit(f"{args.journal}: no submit events")
    N = max(2, args.max_replicas)
    names = args.policy or sorted(POLICIES)

    legs = [("static-1", None, 1), (f"static-{N}", None, N)]
    legs += [(nm, AutoscalePolicy(max_replicas=N, **POLICIES[nm]), 1)
             for nm in names]

    rows = []
    for nm, pol, n0 in legs:
        r = run_leg(events, n0=n0, max_n=N, slots=args.slots,
                    target_wait=args.target_wait, policy=pol)
        r["policy"] = nm
        rows.append(r)

    static_n = next(r for r in rows
                    if r["policy"] == f"static-{N}")["chip_steps"]
    for r in rows:
        r["saved_vs_static"] = round(
            1.0 - r["chip_steps"] / static_n, 3) if static_n else 0.0

    if args.json:
        for r in rows:
            print(json.dumps({"metric": "autoscale_sim_leg", **r}))
        return 0 if all(r["conserved"] for r in rows) else 1

    cols = ("policy", "chip_steps", "saved_vs_static", "burn_max",
            "lag", "actions", "peak", "ticks", "completed",
            "rejected")
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows))
              for c in cols}
    line = "  ".join(c.rjust(widths[c]) for c in cols)
    print(f"# {args.journal}: {len(events)} submits, "
          f"{len(rows)} legs, max_replicas={N}")
    print(line)
    print("-" * len(line))
    for r in rows:
        print("  ".join(str(r[c]).rjust(widths[c]) for c in cols))
    worst = [r for r in rows if not r["conserved"]]
    if worst:
        print(f"!! chip-step conservation broken in: "
              f"{[r['policy'] for r in worst]}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
