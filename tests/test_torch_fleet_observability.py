"""Cross-process metric aggregation of the PyTorch port
(``paddle_tpu_torch/observability/aggregate.py``, ``MetricsServer``'s
``/snapshot.json``) against the JAX reference's on the CPU, and the fleet
router's merged timeline.

Held:

- ``wrap_snapshot``, ``aggregate_snapshots``, ``merged_quantile`` /
  ``series_quantile`` and ``fleet_expose_text`` of both packages on the
  same snapshot documents (registries of both packages fed the same
  random traffic): equal JSON and byte-equal text;
- a port engine's snapshot merged by the JAX aggregator beside a JAX
  engine's, and the other way round, with the counters summed exactly;
  the port's ``engine``-labelled families merge without a mismatch;
- a type or bucket mismatch between replicas raises in both;
- ``/healthz`` and ``/snapshot.json`` of the port's ``MetricsServer`` over
  loopback, a ``FleetAggregator`` of either package pulling it over HTTP,
  a dead endpoint recorded and not fatal, ``MetricsServer(registry=
  aggregator)`` serving the fleet view;
- a two-replica port fleet (a registry and a tracer per replica): the
  router's aggregator totals equal the replicas' sums, and the merged
  timeline of the router's and the replicas' dumps passes
  ``tools/trace_check.py``'s ``check_dump`` and ``check_fleet_dumps``
  with one cross-process link per request.
Tolerances: none; every comparison is exact."""
import importlib.util
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
import paddle_tpu_torch.observability as pobs
from paddle_tpu_torch.inference import (EngineReplica, FleetRouter,
                                        ServingEngine)
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)
KW = dict(num_slots=2, page_size=8, prefill_chunk=8, max_seq_len=64)


def _fill(obs, seed):
    """A registry of ``obs``'s package fed one seeded random traffic:
    labelled counters, a histogram, a labelled gauge."""
    rng = np.random.RandomState(seed)
    reg = obs.MetricsRegistry()
    c = reg.counter("req_total", "requests", labels=("reason",))
    h = reg.histogram("lat_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    g = reg.gauge("pages_free", "free pages", labels=("engine",))
    for reason in ("ok", "err"):
        c.labels(reason=reason).inc(int(rng.randint(0, 20)))
    for v in rng.lognormal(-4, 2, size=int(rng.randint(5, 40))):
        h.observe(float(v))
    g.labels(engine="0").set(int(rng.randint(0, 64)))
    return reg


def _docs(obs):
    return [obs.wrap_snapshot(_fill(obs, s), replica=f"r{s}",
                              ts=100.0 + s, uptime_s=1.5 * s)
            for s in range(3)]


def test_merge_functions_equal_across_packages():
    pd, jd = _docs(pobs), _docs(jobs)
    assert json.dumps(pd, sort_keys=True) == json.dumps(jd, sort_keys=True)
    pf = pobs.aggregate_snapshots(pd, fleet_name="f")
    jf = jobs.aggregate_snapshots(jd, fleet_name="f")
    assert pf["format"] == jobs.FLEET_FORMAT == pobs.FLEET_FORMAT
    assert json.dumps(pf, sort_keys=True) == json.dumps(jf, sort_keys=True)
    assert pobs.fleet_expose_text(pf).encode() == \
        jobs.fleet_expose_text(jf).encode()
    rec = pf["metrics"]["lat_seconds"]["series"][0]
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert pobs.merged_quantile(rec["buckets"], rec["count"], q) == \
            jobs.aggregate.merged_quantile(rec["buckets"], rec["count"], q)
        assert pobs.series_quantile(rec, q) == \
            jobs.aggregate.series_quantile(rec, q)
    # idempotent wrap, the document's own stamps win, in both
    for obs, d in ((pobs, pd[0]), (jobs, jd[0])):
        again = obs.wrap_snapshot(json.loads(json.dumps(d)),
                                  replica="other")
        assert again == d


def test_mismatches_raise_in_both_packages():
    for obs in (pobs, jobs):
        a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
        a.gauge("x", "").set(1)
        b.counter("x", "").inc()
        with pytest.raises(ValueError):
            obs.aggregate_snapshots([obs.wrap_snapshot(a, "a"),
                                     obs.wrap_snapshot(b, "b")])
        a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
        a.histogram("h", "", buckets=(0.1, 1.0)).observe(0.5)
        b.histogram("h", "", buckets=(0.2, 1.0)).observe(0.5)
        with pytest.raises(ValueError):
            obs.aggregate_snapshots([obs.wrap_snapshot(a, "a"),
                                     obs.wrap_snapshot(b, "b")])
        a = obs.MetricsRegistry()
        a.gauge("g", "", labels=("replica",)).labels(replica="z").set(1)
        with pytest.raises(ValueError):
            obs.aggregate_snapshots([obs.wrap_snapshot(a, "a")])


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine on the same weights, each with its
    own registry, after serving the same requests."""
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(**CFG))
    m.eval()
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _gen_params(m)), "cpu")
    je = JaxEngine(m, attention="jax", cost_analysis=False,
                   registry=jobs.MetricsRegistry(), **KW)
    pe = ServingEngine(GPTConfig(**CFG), params, device="cpu",
                       registry=pobs.MetricsRegistry(), **KW)
    rng = np.random.RandomState(3)
    for _ in range(4):
        p = rng.randint(0, 97, int(rng.randint(4, 16)))
        n = int(rng.randint(3, 8))
        je.add_request(p, n)
        pe.add_request(p, n)
    je.run(max_steps=10_000)
    pe.run(max_steps=10_000)
    yield je, pe, params
    je.close()
    pe.close()


COUNTERS = ("serving_tokens_emitted_total", "serving_admissions_total",
            "serving_completions_total")


def _sum(reg, name):
    return sum(s["value"] for s in reg.snapshot()[name]["series"])


@pytest.mark.parametrize("agg_pkg", ["jax", "port"])
def test_snapshots_merge_across_packages(engines, agg_pkg):
    """One aggregator of either package over a JAX engine's registry and a
    port engine's: the counters sum exactly, the gauges keep their
    replica, nothing raises (the port's ``engine``-labelled series
    included)."""
    je, pe, _ = engines
    obs = jobs if agg_pkg == "jax" else pobs
    agg = obs.FleetAggregator(fleet_name="mixed")
    agg.add_source(je.metrics, replica="jax0")
    agg.add_source(pe.metrics, replica="port0")
    fleet = agg.aggregate()
    assert fleet["sources_ok"] == fleet["sources_total"] == 2
    assert agg.last_errors == {}
    for name in COUNTERS:
        want = _sum(je.metrics, name) + _sum(pe.metrics, name)
        assert want > 0
        assert agg.total(name) == want, name
    assert _sum(je.metrics, "serving_tokens_emitted_total") == \
        _sum(pe.metrics, "serving_tokens_emitted_total")
    reps = {s["labels"]["replica"] for s in
            fleet["metrics"]["serving_pages_free"]["series"]}
    assert reps == {"jax0", "port0"}
    assert agg.quantile("serving_ttft_seconds", 0.99) is not None
    assert agg.quantile("no_such_family", 0.5) is None


def test_metrics_server_snapshot_over_loopback(engines):
    """The port's ``/healthz`` and ``/snapshot.json``; both packages'
    aggregators pulling it over HTTP; a dead endpoint recorded, not
    fatal; ``MetricsServer(registry=aggregator)`` serving the fleet."""
    _, pe, _ = engines
    srv = pobs.MetricsServer(registry=pe.metrics, replica="repA")
    other = pobs.MetricsRegistry()
    other.counter("serving_tokens_emitted_total", "").inc(6)
    try:
        health = json.loads(urllib.request.urlopen(
            srv.base_url + "/healthz", timeout=5).read())
        assert health["status"] == "ok" and health["replica"] == "repA"
        snap = json.loads(urllib.request.urlopen(
            srv.base_url + "/snapshot.json", timeout=5).read())
        assert snap["format"] == pobs.SNAPSHOT_FORMAT
        assert snap["replica"] == "repA"
        assert snap["uptime_s"] >= 0 and snap["ts"] > 0
        assert snap["metrics"] == json.loads(json.dumps(
            pe.metrics.snapshot()))
        assert srv.snapshot()["replica"] == "repA"
        want = _sum(pe.metrics, "serving_tokens_emitted_total") + 6
        for obs in (pobs, jobs):
            agg = obs.FleetAggregator([srv.base_url])
            agg.add_source(other, replica="repB")
            assert agg.total("serving_tokens_emitted_total",
                             refresh=True) == want
            fsrv = pobs.MetricsServer(registry=agg, replica="fleet")
            try:
                text = urllib.request.urlopen(
                    fsrv.base_url + "/metrics", timeout=5).read().decode()
                assert f"serving_tokens_emitted_total {int(want)}" in text
                doc = json.loads(urllib.request.urlopen(
                    fsrv.base_url + "/snapshot.json", timeout=5).read())
                assert doc["format"] == pobs.FLEET_FORMAT
                assert doc["sources_ok"] == 2
            finally:
                fsrv.close()
    finally:
        srv.close()
    agg = pobs.FleetAggregator([srv.base_url], timeout=0.5)
    agg.add_source(other, replica="live")
    fleet = agg.aggregate()
    assert fleet["replicas"] == ["live"]
    assert fleet["sources_ok"] == 1 and fleet["sources_total"] == 2
    assert len(agg.last_errors) == 1


def test_fleet_aggregator_from_snapshot_files(tmp_path):
    paths = []
    for i, obs in enumerate((pobs, jobs)):
        reg = obs.MetricsRegistry()
        reg.counter("n_total", "").inc(i + 1)
        p = tmp_path / f"snap{i}.json"
        p.write_text(json.dumps(obs.wrap_snapshot(reg, replica=f"f{i}")))
        paths.append(str(p))
    for obs in (pobs, jobs):
        agg = obs.FleetAggregator(paths)
        assert agg.total("n_total", refresh=True) == 3
        assert agg.aggregate()["replicas"] == ["f0", "f1"]


def _trace_check():
    """``tools/trace_check.py``, loaded by path after JAX (it sets
    ``XLA_FLAGS`` at import)."""
    spec = importlib.util.spec_from_file_location(
        "trace_check", os.path.join(ROOT, "tools", "trace_check.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    return tc


def test_two_replica_port_fleet_timeline_and_view(engines, tmp_path):
    """A router over two port engines, each with its own registry and
    tracer: the router's fleet view sums the replicas' counters, and the
    merged timeline (router dump + replica dumps) passes the reference's
    checker with one cross-process link per request."""
    _, _, params = engines
    regs, tracers, reps = [], [], []
    for name in ("r0", "r1"):
        reg = pobs.MetricsRegistry()
        tr = pobs.Tracer("requests", replica=name, max_traces=64)
        eng = ServingEngine(GPTConfig(**CFG), params, device="cpu",
                            registry=reg, tracer=tr, **KW)
        regs.append(reg)
        tracers.append(tr)
        reps.append(EngineReplica(eng, name))
    rtracer = pobs.Tracer("router", replica="router0", max_traces=64)
    router = FleetRouter(reps, registry=pobs.MetricsRegistry(),
                         tracer=rtracer)
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, 97, 16)
    n = 6
    for i in range(n):
        tail = rng.randint(0, 97, int(rng.randint(4, 12)))
        router.submit(np.concatenate([prefix, tail]) if i % 2 else tail,
                      int(rng.randint(3, 8)))
    done = router.run(max_steps=10_000)
    assert len(done) == n
    fleet = router.poll_health()
    assert fleet["sources_ok"] == fleet["sources_total"] == 2
    for name in COUNTERS:
        assert router.aggregator.total(name) == \
            sum(_sum(r, name) for r in regs), name
    assert router.aggregator.total("router_requests_total") == 0
    paths = []
    for name, tr in [("router", rtracer)] + list(zip(("r0", "r1"),
                                                      tracers)):
        p = str(tmp_path / f"flight_{name}.json")
        tr.dump(p)
        paths.append(p)
    tc = _trace_check()
    docs = [json.load(open(p)) for p in paths]
    problems = []
    for doc in docs:
        tc.check_dump(doc, problems)
    links = tc.check_fleet_dumps(docs, problems)
    assert problems == []
    assert links == n
    merged = str(tmp_path / "merged.json")
    pobs.export_merged_chrome_trace(merged, tracers=[],
                                    include_profiler=False,
                                    include_compile=False, dumps=paths)
    data = json.load(open(merged))
    lanes = {(e.get("args") or {}).get("name")
             for e in data["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"router@router0", "requests@r0", "requests@r1"} <= lanes
    flows = [e for e in data["traceEvents"] if e.get("cat") == "xproc"]
    assert len([e for e in flows if e["ph"] == "s"]) == n
    router.close()
