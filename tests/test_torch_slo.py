"""SLO burn rates and the serving watchdog of the PyTorch port
(``paddle_tpu_torch/observability/slo.py``, ``ServingEngine(watchdog=...)``)
against the JAX reference's on the CPU.

- ``SLOEngine`` of both packages over one synthetic snapshot sequence
  (every tenant and tier family an objective reads, written into one
  registry a tick) on a step clock (``clock=``): every evaluation's
  records, the ``serving_slo_*`` series, ``report()`` and the
  ``slo_alert`` decision spans' attributes equal. Burn rates built on
  wall-time histograms differ between two runs of one engine, so the
  latency objectives are held on this synthetic source only.
- ``ServingWatchdog`` of both packages over one sequence of engine
  counters (a stand-in engine) and a published quantization error: the
  trips, the ``serving_watchdog_*`` series and the ``watchdog`` decision
  spans' attributes equal.
- A JAX engine and a port engine on the same traffic with
  ``watchdog=`` (a dict) and a seeded baseline trip the same kinds at the
  same steps with the same values, thresholds and windows; the gauges
  of every count signal (``prefix_hit``, ``spec_accept``,
  ``page_thrash``) agree at the end. Greedy traffic, per phase.
- ``watchdog=`` takes ``True``, a dict and a shared instance (per-engine
  windows); a trip dumps the engine's flight recorder with reason
  ``watchdog:<kind>``.
Tolerances: none; every comparison is exact (both packages run the same
host arithmetic on the same numbers)."""
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import truncate_draft as jax_truncate_draft
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import Tracer as JaxTracer
from paddle_tpu.observability import slo as jslo
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry, Tracer
from paddle_tpu_torch.observability import slo
from paddle_tpu_torch.observability.tracing import FLIGHT_RECORDER_FORMAT

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)
KW = dict(page_size=8, prefill_chunk=8, max_seq_len=64, num_slots=3)
SPECS = [
    dict(name="gold-ttft", tenant="gold", ttft_p99_s=0.5,
         windows=(3.0, 10.0), min_count=2),
    dict(name="gold-token", tenant="gold", token_p99_s=0.05,
         success_frac=0.9, windows=(3.0, 10.0), min_count=2),
    dict(name="bulk-good", tenant="bulk", goodput_frac=0.8,
         windows=(2.0, 6.0), min_count=2, burn_threshold=1.5),
    dict(name="tier2", tier="2", goodput_frac=0.9, windows=(4.0,)),
]


def _span_attrs(tracer, name):
    return [t.root.attrs for t in tracer.completed_traces()
            if t.root.name == name]


def _families(reg, prefix):
    snap = reg.snapshot()
    return {k: v for k, v in snap.items() if k.startswith(prefix)}


def _feed(reg, tick, rng):
    """One tick of tenant and tier traffic into ``reg``; latencies go bad
    (past the objectives) between ticks 12 and 24."""
    ttft = reg.histogram("serving_tenant_ttft_seconds", "t",
                         labels=("tenant",))
    tok = reg.histogram("serving_tenant_token_latency_seconds", "t",
                        labels=("tenant",))
    good = reg.counter("serving_tenant_goodput_tokens_total", "g",
                       labels=("tenant",))
    raw = reg.counter("serving_tenant_tokens_total", "r",
                      labels=("tenant",))
    reqs = reg.counter("serving_tenant_requests_total", "q",
                       labels=("tenant", "outcome"))
    tgood = reg.counter("serving_goodput_tokens_total", "g",
                        labels=("tier",))
    traw = reg.counter("serving_tier_tokens_total", "r", labels=("tier",))
    bad = 12 <= tick < 24
    for tenant in ("gold", "bulk"):
        for _ in range(3):
            ttft.labels(tenant=tenant).observe(
                float(rng.uniform(0.6, 2.0) if bad else
                      rng.uniform(0.01, 0.3)))
            tok.labels(tenant=tenant).observe(
                float(rng.uniform(0.06, 0.2) if bad else
                      rng.uniform(0.001, 0.02)))
        n = int(rng.integers(8, 16))
        raw.labels(tenant=tenant).inc(n)
        good.labels(tenant=tenant).inc(n // 2 if bad else n)
        reqs.labels(tenant=tenant, outcome="shed" if bad else "length").inc()
        reqs.labels(tenant=tenant, outcome="eos").inc()
    traw.labels(tier="2").inc(10)
    tgood.labels(tier="2").inc(5 if bad else 10)


def test_slo_engine_matches_the_reference_on_a_step_clock():
    src = MetricsRegistry()
    snap = {}
    clock = [0.0]
    regs = (JaxRegistry(), MetricsRegistry())
    tracers = (JaxTracer("slo"), Tracer("slo"))
    engines = [mod.SLOEngine(SPECS, source=lambda: snap, registry=reg,
                             tracer=tr, clock=lambda: clock[0],
                             cooldown_s=5.0)
               for mod, reg, tr in zip((jslo, slo), regs, tracers)]
    rng = np.random.default_rng(0)
    fired = 0
    for tick in range(40):
        _feed(src, tick, rng)
        snap.clear()
        snap.update(src.snapshot())
        clock[0] = float(tick)
        want, got = (e.evaluate() for e in engines)
        assert got == want, tick
        fired += sum(r["fired"] for r in got)
    assert fired >= 3
    assert _families(regs[1], "serving_slo_") == \
        _families(regs[0], "serving_slo_")
    want, got = (e.report() for e in engines)
    want.pop("ts"), got.pop("ts")
    assert got == want
    assert _span_attrs(tracers[1], "slo_alert") == \
        _span_attrs(tracers[0], "slo_alert")
    assert len(_span_attrs(tracers[1], "slo_alert")) == fired


def test_slo_spec_validation_matches_the_reference():
    for bad in (dict(name=""), dict(name="x"),
                dict(name="x", ttft_p99_s=1.0),
                dict(name="x", tenant="t", goodput_frac=1.5),
                dict(name="x", tier="1", goodput_frac=0.5, windows=()),
                dict(name="x", tenant="t", ttft_p99_s=-1.0)):
        for mod in (jslo, slo):
            with pytest.raises(ValueError):
                mod.SLOSpec(**bad)
    with pytest.raises(ValueError):
        slo.SLOEngine([SPECS[0], SPECS[0]], source=lambda: {})


def _stand_in(eid):
    return SimpleNamespace(
        engine_id=eid, kv=SimpleNamespace(cache_stats={"evictions": 0}),
        stats={k: 0 for k in ("steps", "spec_proposed", "spec_accepted",
                              "prefix_hits", "prefix_misses",
                              "preemptions")})


def test_serving_watchdog_matches_the_reference_on_a_counter_sequence():
    regs = (JaxRegistry(), MetricsRegistry())
    tracers = (JaxTracer("wd"), Tracer("wd"))
    dogs = [mod.ServingWatchdog(registry=reg, tracer=tr, interval_steps=4,
                                min_samples=8, min_events=2,
                                cooldown_steps=12, postmortem=False)
            for mod, reg, tr in zip((jslo, slo), regs, tracers)]
    errs = [reg.gauge("serving_quant_logit_err", "e", labels=("engine",))
            for reg in regs]
    engs = [_stand_in("e0"), _stand_in("e0")]
    rng = np.random.default_rng(1)
    trips = 0
    for step in range(1, 120):
        late = step > 60
        d = {"steps": 1, "spec_proposed": 4,
             "spec_accepted": int(rng.integers(0, 2) if late
                                  else rng.integers(2, 5)),
             "prefix_hits": int(rng.integers(0, 2) if late
                                else rng.integers(3, 6)),
             "prefix_misses": int(rng.integers(1, 4)),
             "preemptions": int(rng.integers(0, 3) if step > 90 else 0)}
        ev = int(rng.integers(0, 2)) if step > 95 else 0
        err = float(0.004 if step < 100 else 0.09)
        outs = []
        for dog, eng, g in zip(dogs, engs, errs):
            for k, v in d.items():
                eng.stats[k] += v
            eng.kv.cache_stats["evictions"] += ev
            g.labels(engine="e0").set(err)
            outs.append([{k: v for k, v in t.items() if k != "postmortems"}
                         for t in dog.observe(eng)])
        assert outs[1] == outs[0], step
        trips += len(outs[1])
    assert {t["kind"] for t in dogs[1].trips} == set(slo.WATCHDOG_KINDS)
    assert trips == len(dogs[1].trips)
    assert _families(regs[1], "serving_watchdog_") == \
        _families(regs[0], "serving_watchdog_")
    assert _span_attrs(tracers[1], "watchdog") == \
        _span_attrs(tracers[0], "watchdog")
    with pytest.raises(ValueError):
        dogs[1].seed_baseline("latency", 1.0)


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(**CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, jax_truncate_draft(m, 1), params_from_numpy(tree, "cpu")


def _requests(seed, n=8):
    """Greedy requests sharing no prefix: every page lookup misses."""
    rng = np.random.default_rng(seed)
    return [(list(rng.integers(1, 97, int(rng.integers(12, 30)))),
             int(rng.integers(6, 14))) for _ in range(n)]


def _drive_tripping(eng, reqs=None, per_step=2):
    """Add the requests ``per_step`` a step; returns [(step, trip)] as
    they fire."""
    reqs = _requests(5) if reqs is None else list(reqs)
    out, step = [], 0
    while reqs or eng.has_work:
        for p, n in reqs[:per_step]:
            eng.add_request(p, n)
        reqs = reqs[per_step:]
        before = len(eng.watchdog.trips)
        eng.step()
        step += 1
        out += [(step, {k: v for k, v in t.items()
                        if k not in ("engine", "postmortems")})
                for t in list(eng.watchdog.trips)[before:]]
    return out


@pytest.mark.parametrize("kind", ["prefix_hit", "spec_accept"])
def test_engines_trip_the_same_kinds_at_the_same_steps(ref, kind):
    wd = dict(interval_steps=4, min_samples=4, postmortem=False)
    spec = kind == "spec_accept"
    jeng = JaxEngine(ref[0], attention="jax", cost_analysis=False,
                     registry=JaxRegistry(), tracing=False, watchdog=wd,
                     **(dict(speculative=ref[1], draft_k=3) if spec else {}),
                     **KW)
    peng = ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                         registry=MetricsRegistry(), tracing=False,
                         watchdog=wd,
                         **(dict(speculative=1, draft_k=3) if spec else {}),
                         **KW)
    for eng in (jeng, peng):
        eng.watchdog.seed_baseline(kind, 0.9)
    # speculation runs in steady decode: three long requests at once
    rng = np.random.default_rng(5)
    reqs = [(list(rng.integers(1, 97, 10)), 30) for _ in range(3)] \
        if spec else _requests(5)
    want, got = (_drive_tripping(e, reqs, 3 if spec else 2)
                 for e in (jeng, peng))
    assert got == want
    assert any(t["kind"] == kind for _, t in got)
    assert _families(peng.metrics, "serving_watchdog_") == \
        _families(jeng.metrics, "serving_watchdog_")


def test_watchdog_lever_true_dict_and_shared_instance(ref, tmp_path):
    def make(wd, **kw):
        return ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                             registry=MetricsRegistry(), watchdog=wd,
                             **dict(KW, **kw))
    default = make(True)
    assert isinstance(default.watchdog, slo.ServingWatchdog)
    assert default.watchdog.registry is default.metrics
    assert default.watchdog.interval_steps == 8
    assert make(False).watchdog is None and make(None).watchdog is None
    tuned = make(dict(interval_steps=3, collapse_frac=0.25))
    assert (tuned.watchdog.interval_steps,
            tuned.watchdog.collapse_frac) == (3, 0.25)
    shared = slo.ServingWatchdog(registry=MetricsRegistry(),
                                 interval_steps=2, min_samples=2,
                                 postmortem=False)
    a, b = make(shared), make(shared)
    assert a.watchdog is b.watchdog is shared
    for eng in (a, b):
        for p, n in _requests(6, 4):
            eng.add_request(p, n)
        eng.run()
    # windows are per engine, the baselines shared
    assert set(shared._last) == {a.engine_id, b.engine_id}
    assert "prefix_hit" in shared._baseline


def test_a_trip_dumps_the_flight_recorder(ref, tmp_path):
    pm = tmp_path / "pm.json"
    eng = ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                        registry=MetricsRegistry(), tracer=Tracer("r"),
                        postmortem_path=str(pm),
                        watchdog=dict(interval_steps=4, min_samples=4),
                        **KW)
    eng.watchdog.seed_baseline("prefix_hit", 0.9)
    trips = _drive_tripping(eng)
    assert trips and trips[0][1]["kind"] == "prefix_hit"
    first = eng.watchdog.trips[0]
    assert str(pm) in first["postmortems"]
    doc = json.load(open(pm))
    assert doc["format"] == FLIGHT_RECORDER_FORMAT
    wd = [t for t in eng._tracer.completed_traces()
          if t.root.name == "watchdog"]
    assert wd and wd[0].root.attrs["kind"] == "prefix_hit"
    assert eng.metrics.get("serving_watchdog_trips_total").labels(
        kind="prefix_hit").value == len(trips)
    eng.close()
