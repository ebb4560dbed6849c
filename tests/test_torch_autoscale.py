"""The autoscaler of the PyTorch port (``paddle_tpu_torch/inference/
autoscale.py``: ``AutoscalePolicy``, ``AutoscaleController``) against the
JAX reference's on the CPU.

The scenarios of ``tests/test_autoscale.py`` run through both packages'
``FleetRouter`` and ``AutoscaleController`` over the same deterministic
simulated replicas (a request completes a fixed number of steps after
admission) and the same scripted burn (a pure function of the router's
step clock). Held equal across the packages: the decision sequence (every
record: step, decision, rule, replica, replica counts, signals and the
counterfactual), the attributes of every ``scale_*`` span, the
``autoscaler_*`` series and ``report()``; and each package's run holds
the reference's own assertions. Then: a journal recorded by either
package replays through the other's fresh router and controller with
the same decisions (``check_divergence`` identical), a tampered decision
is caught, and a tiny port-engine autoscale (the port's engines on the
CPU, an ``SLOEngine`` on the step clock over a count objective) is
recorded and replayed with 0 divergences.
Tolerances: none; every comparison is exact."""
import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu.inference as jinf
import paddle_tpu.observability as jobs
from paddle_tpu.inference.serving import Completion as JaxCompletion
from paddle_tpu.observability import journal as jjnl
import paddle_tpu_torch.inference as pinf
import paddle_tpu_torch.observability as pobs
from paddle_tpu_torch.inference.serving import Completion
from paddle_tpu_torch.observability import journal as pjnl

torch.set_num_threads(2)

PKGS = {
    "jax": SimpleNamespace(inf=jinf, obs=jobs, jnl=jjnl,
                           Completion=JaxCompletion),
    "port": SimpleNamespace(inf=pinf, obs=pobs, jnl=pjnl,
                            Completion=Completion)}


class FakeReplica:
    """Deterministic replica over the ``EngineReplica`` surface: an
    admitted request completes ``latency`` steps later with
    ``max_new_tokens`` tokens (finish ``length``)."""

    page_size = 8

    def __init__(self, pkg, name, num_slots=4, latency=2, pages=64):
        self.pkg = pkg
        self.name = str(name)
        self.num_slots = int(num_slots)
        self.latency = int(latency)
        self.pages = int(pages)
        self._uid = itertools.count(1)
        self._pending = []            # [uid, kw] in arrival order
        self._slots = {}              # uid -> [age, kw]
        self.metrics = pkg.obs.MetricsRegistry()
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
        for i, (u, kw) in enumerate(self._pending):
            if u == int(uid):
                del self._pending[i]
                self._gauges()
                return SimpleNamespace(kw=kw, resume_out=[])
        _, kw = self._slots.pop(int(uid))
        self._gauges()
        return SimpleNamespace(kw=kw, resume_out=[])

    def cancel(self, uid):
        self.eject(uid)

    def step(self):
        while self._pending and len(self._slots) < self.num_slots:
            uid, kw = self._pending.pop(0)
            self._slots[uid] = [0, kw]
        done = []
        for uid, rec in list(self._slots.items()):
            rec[0] += 1
            if rec[0] >= self.latency:
                kw = rec[1]
                del self._slots[uid]
                done.append(self.pkg.Completion(
                    uid=uid, tokens=[7] * int(kw.get("max_new_tokens", 1)),
                    finish_reason="length", ttft_s=None,
                    priority=int(kw.get("priority", 0)),
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
                   for u, (_, kw) in self._slots.items())
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
        return {"kind": "fake_replica", "num_slots": self.num_slots,
                "page_size": self.page_size, "latency": self.latency}

    def close(self):
        pass


class ScriptedSLO:
    """Burn as a pure function of the router's step clock:
    ``fn(step) -> {tenant: {window: burn}}``; ``report()`` serves the last
    ``evaluate()``."""

    def __init__(self, fn):
        self.fn = fn
        self.router = None
        self._last = {}

    def evaluate(self):
        self._last = self.fn(self.router.steps_taken)

    def report(self):
        return {"slos": [
            {"slo": f"{t}-scripted", "tenant": t, "tier": t,
             "burn": {str(w): float(b) for w, b in wins.items()}}
            for t, wins in sorted(self._last.items())]}


def _router(pkg, n=1, slo_fn=None, journal=None, tracer=None):
    slo = ScriptedSLO(slo_fn) if slo_fn is not None else None
    r = pkg.inf.FleetRouter([FakeReplica(pkg, f"f{i}") for i in range(n)],
                            registry=pkg.obs.MetricsRegistry(), slo=slo,
                            journal=journal, tracer=tracer)
    if slo is not None:
        slo.router = r
    return r


def _ctl(pkg, r, policy, prefix="x", tracer=None):
    mk = itertools.count(0)
    return pkg.inf.AutoscaleController(
        r, lambda: FakeReplica(pkg, f"{prefix}{next(mk)}"),
        pkg.inf.AutoscalePolicy(**policy), tracer=tracer)


def _submit(router, n=1, tenant="gold", max_new=3, seed=0):
    rng = np.random.RandomState(seed + router.steps_taken)
    return [router.submit(prompt=rng.randint(0, 97, 6),
                          max_new_tokens=max_new, tenant=tenant)
            for _ in range(n)]


def _burst_fn(step):
    """Burn ramps over steps 4..14, then silence: drives 1 -> 2 -> 1."""
    if 4 <= step <= 14:
        f = min(0.1 * (step - 3), 1.2)
        return {"gold": {"8": f, "32": f / 2.0}}
    return {"gold": {"8": 0.0, "32": 0.0}}


BURST_POLICY = dict(max_replicas=2, confirm_out=2, cooldown_steps=6,
                    idle_steps=8)


def _tail(r, ctl):
    for _ in range(200):
        if len(r.live_replicas()) <= ctl.policy.min_replicas:
            break
        r.step()
        ctl.tick()


def _observe(r, ctl, tracer=None):
    """What the two packages must agree on."""
    snap = r.metrics.snapshot()
    series = {name: [(s["labels"], s.get("value", s.get("count")),
                      s.get("buckets"))
                     for s in snap[name]["series"]]
              for name in snap if name.startswith("autoscaler_")}
    spans = None
    if tracer is not None:
        spans = [(t.name, dict(t.root.attrs))
                 for t in tracer.completed_traces()
                 if t.name in ("scale_out", "scale_in", "scale_hold")]
    return {"decisions": json.loads(json.dumps(ctl.decisions)),
            "report": json.loads(json.dumps(ctl.report())),
            "series": series, "spans": spans, "steps": r.steps_taken,
            "stats": dict(r.stats),
            "live": [st.name for st in r.live_replicas()]}


# -- the scenarios, one body for both packages ------------------------------

def scenario_scale_out_before_burn(pkg):
    ramp = {}

    def burn(step):
        fast = min(0.06 * step, 1.5)
        ramp[step] = fast
        return {"gold": {"8": fast, "32": fast / 2.0}}
    r = _router(pkg, 1, slo_fn=burn)
    ctl = _ctl(pkg, r, dict(max_replicas=3, confirm_out=2,
                            cooldown_steps=4, idle_steps=10_000))
    _submit(r, 4)
    for _ in range(12):
        r.step()
        ctl.tick()
        if r.has_work is False:
            _submit(r, 2)
    outs = [d for d in ctl.decisions if d["decision"] == "scale_out"]
    first = outs[0]
    assert first["rule"] == "out:burn"
    assert (first["replicas_before"], first["replicas_after"]) == (1, 2)
    assert ramp[first["step"]] < 1.0
    assert first["counterfactual"]["predicted_burn"] >= 0.5
    assert first["counterfactual"]["burn_tenant"] == "gold"
    assert "tenant_burn" in first["signals"]
    assert r.autoscaler is ctl
    return _observe(r, ctl)


def scenario_idle_drain(pkg):
    r = _router(pkg, 2, slo_fn=lambda step: {"gold": {"8": 0.0}})
    ctl = _ctl(pkg, r, dict(min_replicas=1, max_replicas=3, idle_steps=4,
                            cooldown_steps=2))
    for _ in range(20):
        r.step()
        ctl.tick()
    ins = [d for d in ctl.decisions if d["decision"] == "scale_in"]
    assert len(ins) == 1 and ins[0]["rule"] == "in:idle"
    assert ins[0]["replica"] == "f1"
    assert [st.name for st in r.live_replicas()] == ["f0"]
    return _observe(r, ctl)


def scenario_cooldown(pkg):
    def burn(step):
        hot = (step // 10) % 2 == 0
        return {"gold": {"8": 0.9 if hot else 0.0,
                         "32": 0.45 if hot else 0.0}}
    r = _router(pkg, 1, slo_fn=burn)
    ctl = _ctl(pkg, r, dict(max_replicas=2, confirm_out=2,
                            cooldown_steps=20, idle_steps=3,
                            scale_in_burn=0.25))
    for _ in range(80):
        r.step()
        ctl.tick()
    acts = [d for d in ctl.decisions if d["decision"] != "scale_hold"]
    assert 1 <= len(acts) <= 80 // 20
    steps = [d["step"] for d in acts]
    assert all(b - a >= 20 for a, b in zip(steps, steps[1:]))
    blocked = [d for d in ctl.decisions if d["decision"] == "scale_hold"
               and d["counterfactual"]["blocked"] == "cooldown"]
    assert blocked and blocked[0]["counterfactual"]["cooldown_left"] > 0
    assert ctl.stats["blocked_cooldown"] == len(blocked)
    return _observe(r, ctl)


def scenario_max_replicas(pkg):
    r = _router(pkg, 1, slo_fn=lambda s: {"gold": {"8": 2.0, "32": 2.0}})
    ctl = _ctl(pkg, r, dict(max_replicas=1, confirm_out=1,
                            cooldown_steps=0, idle_steps=10_000))
    for _ in range(3):
        r.step()
        ctl.tick()
    assert all(d["decision"] == "scale_hold" and
               d["counterfactual"]["blocked"] == "max_replicas"
               for d in ctl.decisions)
    assert ctl.stats["blocked_limit"] == len(ctl.decisions)
    return _observe(r, ctl)


def scenario_burst_recorded(pkg, path=None):
    """The bursty window recorded (the reference's ``_drive_recorded``):
    due submits before the step, the controller's tick after it, then
    the idle tail."""
    r = _router(pkg, 1, slo_fn=_burst_fn, journal=path)
    ctl = _ctl(pkg, r, BURST_POLICY)
    sched = {0: 3, 4: 4, 6: 4, 8: 3}
    while sched or r.has_work:
        for _ in range(sched.pop(r.steps_taken, 0)):
            _submit(r, 1, seed=7)
        r.step()
        ctl.tick()
    _tail(r, ctl)
    r.close()
    acts = [d["decision"] for d in ctl.decisions
            if d["decision"] != "scale_hold"]
    assert acts == ["scale_out", "scale_in"]
    assert [n for _, n in ctl.replica_trace] == [1, 2, 1]
    cons = ctl.conservation()
    assert cons["conserved"] and cons["per_replica_sum"] == ctl.chip_steps
    rep = ctl.report()
    assert ctl.chip_steps < ctl.chip_steps_static
    assert rep["chip_steps_static"] == ctl.static_n * rep["ticks"]
    return _observe(r, ctl)


def scenario_metrics_and_spans(pkg):
    tracer = pkg.obs.Tracer("autoscale-test")
    r = _router(pkg, 1, slo_fn=_burst_fn, tracer=tracer)
    ctl = _ctl(pkg, r, BURST_POLICY, prefix="m", tracer=tracer)
    _submit(r, 3)
    for _ in range(30):
        r.step()
        ctl.tick()
    obs = _observe(r, ctl, tracer)
    assert len(obs["spans"]) == ctl.stats["ticks"]
    for key in ("step", "rule", "signals", "counterfactual",
                "replicas_before", "replicas_after"):
        assert key in obs["spans"][0][1]
    for name in ("autoscaler_replicas", "autoscaler_decisions_total",
                 "autoscaler_scaling_lag_steps",
                 "autoscaler_chip_steps_total",
                 "autoscaler_chip_steps_static_total"):
        assert name in obs["series"], name
    return obs


def scenario_empty_quantile(pkg):
    r = _router(pkg, 1)
    sig = r.scale_signals()
    assert sig["ttft_p99_s"] is None
    assert r.aggregator.quantile("serving_ttft_seconds", 0.99,
                                 refresh=True) is None
    return {"signals": sig}


SCENARIOS = {"scale_out_before_burn": scenario_scale_out_before_burn,
             "idle_drain": scenario_idle_drain,
             "cooldown": scenario_cooldown,
             "max_replicas": scenario_max_replicas,
             "burst_recorded": scenario_burst_recorded,
             "metrics_and_spans": scenario_metrics_and_spans,
             "empty_quantile": scenario_empty_quantile}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_controller_matches_the_jax_controller(scenario):
    got = {name: SCENARIOS[scenario](pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]


def test_predictor_equal_across_packages():
    for windows in ({"8": 0.3, "32": 0.3}, {"8": 0.4, "32": 0.1},
                    {"8": 0.1, "32": 0.8}, {}, {"1": 0.9, "64": 0.2,
                                                "8": 0.5}):
        vals = [pkg.inf.AutoscalePolicy(burn_lead_gain=1.5)
                .predicted_burn(windows) for pkg in PKGS.values()]
        assert vals[0] == vals[1], windows
    assert pinf.AutoscalePolicy().to_dict() == \
        jinf.AutoscalePolicy().to_dict()
    for bad in (dict(min_replicas=0), dict(max_replicas=0),
                dict(queue_high=0.0), dict(cooldown_steps=-1)):
        for pkg in PKGS.values():
            with pytest.raises(ValueError):
                pkg.inf.AutoscalePolicy(**bad)


@pytest.mark.parametrize("recorder,replayer", [("jax", "port"),
                                               ("port", "jax"),
                                               ("port", "port")])
def test_recorded_decisions_replay_across_packages(recorder, replayer,
                                                   tmp_path):
    """A journal of the bursty window recorded through one package
    replays through the other's fresh router and controller: the same
    decision sequence, byte for byte on the journaled fields, and
    ``check_divergence`` identical."""
    path = str(tmp_path / "auto.jsonl")
    n = len(scenario_burst_recorded(PKGS[recorder], path)["decisions"])
    rp = PKGS[replayer]
    rd = rp.jnl.JournalReader(path)
    scale_evs = [e for e in rd.events if e["kind"] == "scale"]
    assert len(scale_evs) == n > 2      # actions and blocked holds
    tagged = [e for e in rd.events if e["kind"] in ("drain", "join")
              and e.get("source") == "autoscaler"]
    assert len(tagged) == 2
    r2 = _router(rp, 1, slo_fn=_burst_fn)
    ctl2 = _ctl(rp, r2, BURST_POLICY)
    res = rp.jnl.replay(rd, r2, controller=ctl2)
    _tail(r2, ctl2)
    report = rp.jnl.check_divergence(rd, res)
    assert report["identical"], report["first"]
    assert report["scale_decisions"] == {"recorded": n, "replayed": n}
    fields = rp.jnl._SCALE_FIELDS
    assert [{k: e[k] for k in fields} for e in scale_evs] == \
        [{k: d[k] for k in fields} for d in ctl2.decisions]


def test_a_failing_factory_is_a_join_failed_hold_with_its_error():
    """A factory that raises (on the card: a capture that failed) joins
    nothing: every scale-out the burn asks for is a ``join_failed`` hold,
    the same decisions in both packages, and the port's controller keeps
    each exception in ``join_errors``."""
    got = {}
    for name, pkg in PKGS.items():
        r = _router(pkg, 1, slo_fn=_burst_fn)

        def factory():
            raise RuntimeError("CUDA graph capture failed")
        ctl = pkg.inf.AutoscaleController(
            r, factory, pkg.inf.AutoscalePolicy(**BURST_POLICY))
        _submit(r, 4)
        for _ in range(20):
            r.step()
            ctl.tick()
        assert r.stats["joins"] == 1 and ctl.stats["scale_out"] == 0
        got[name] = json.loads(json.dumps(ctl.decisions))
    failed = [d["step"] for d in got["port"]
              if d["counterfactual"]["blocked"] == "join_failed"]
    assert failed and got["port"] == got["jax"]
    assert [st for st, _ in ctl.join_errors] == failed
    assert all("CUDA graph capture failed" in e for _, e in ctl.join_errors)


def test_a_tampered_decision_is_caught(tmp_path):
    """The port's checker trips on a recorded decision changed in the
    journal, and on a replay under a different policy."""
    path = str(tmp_path / "auto.jsonl")
    scenario_burst_recorded(PKGS["port"], path)
    rd = pjnl.JournalReader(path)
    r2 = _router(PKGS["port"], 1, slo_fn=_burst_fn)
    ctl2 = _ctl(PKGS["port"], r2, BURST_POLICY)
    res = pjnl.replay(rd, r2, controller=ctl2)
    _tail(r2, ctl2)
    assert pjnl.check_divergence(rd, res)["identical"]
    tampered = json.loads(json.dumps(rd.events))
    for e in tampered:
        if e["kind"] == "scale" and e["decision"] == "scale_out":
            e["decision"] = "scale_hold"
            break
    bad = pjnl.check_divergence(tampered, res)
    assert not bad["identical"]
    assert {d["field"] for d in bad["all"]} & {"scale_decision",
                                               "scale_decision_count"}
    r3 = _router(PKGS["port"], 1, slo_fn=_burst_fn)
    ctl3 = _ctl(PKGS["port"], r3, dict(max_replicas=2, confirm_out=4,
                                       cooldown_steps=30, idle_steps=40))
    res3 = pjnl.replay(rd, r3, controller=ctl3)
    _tail(r3, ctl3)
    assert not pjnl.check_divergence(rd, res3)["identical"]


def test_tiny_port_engine_autoscale_records_and_replays(tmp_path):
    """An elastic fleet of tiny port engines on the CPU (2 slots, pages
    and chunks of 8) through a generated workload under the controller
    (an ``SLOEngine`` on the router's step clock over a count objective):
    it scales out and back in, the chip-step ledger balances, every
    join is a live replica, and a fresh fleet and controller replay the
    recorded journal with 0 divergences."""
    from paddle_tpu_torch.models.gpt import gpt2_tiny, init_params
    cfg = gpt2_tiny(max_position_embeddings=64)
    params = init_params(cfg, seed=0, device="cpu")
    wl = str(tmp_path / "wl.jsonl")
    pjnl.write_workload(wl, seed=3, requests=24, vocab=cfg.vocab_size,
                        min_prompt=8, max_prompt=16, max_new=8,
                        min_new=1, prefix_groups=4, prefix_len=16)
    pol = pinf.AutoscalePolicy(
        min_replicas=1, max_replicas=3, scale_out_burn=0.5,
        queue_high=2.0, confirm_out=2, queue_low=0.0, scale_in_burn=0.25,
        idle_steps=24, cooldown_steps=12)

    def make_engine():
        return pinf.ServingEngine(
            cfg, params, device="cpu", num_slots=2, page_size=8,
            prefill_chunk=8, max_seq_len=40,
            registry=pobs.MetricsRegistry())

    def build(journal):
        router = pinf.FleetRouter(
            [pinf.EngineReplica(make_engine(), "a0")],
            registry=pobs.MetricsRegistry(), journal=journal,
            name="autoscale0", seed=3)
        router.slo = pobs.SLOEngine(
            [pobs.SLOSpec(name="gold-success", tenant="gold",
                          success_frac=0.99, windows=(8.0, 64.0),
                          min_count=2)],
            source=router.aggregator, registry=router.metrics,
            clock=lambda: float(router.steps_taken))
        return router, pinf.AutoscaleController(router, make_engine, pol,
                                                static_n=3)

    def drive(router, ctl):
        res = pjnl.replay(pjnl.JournalReader(wl), router, controller=ctl)
        _tail(router, ctl)
        return res

    path = str(tmp_path / "auto.jsonl")
    router, ctl = build(path)
    res = drive(router, ctl)
    rep = ctl.report()
    trace = [n for _, n in rep["replica_trace"]]
    assert trace[0] == trace[-1] == 1 and max(trace) > 1
    assert rep["conservation"]["conserved"]
    assert router.stats["joins"] - 1 == rep["decisions"]["scale_out"]
    assert all(c.finish_reason in ("eos", "length")
               for c in res.completions.values())
    router.close()
    router2, ctl2 = build(None)
    res2 = drive(router2, ctl2)
    report = pjnl.check_divergence(path, res2)
    assert report["divergences"] == 0, report["first"]
    assert report["scale_decisions"]["recorded"] == \
        report["scale_decisions"]["replayed"] == len(ctl.decisions) > 0
    router2.close()
