"""The port's observability modules (``paddle_tpu_torch/observability``,
``paddle_tpu_torch/profiler``) held against the reference's
(``paddle_tpu/observability``, ``paddle_tpu/profiler``) as units:

- the registry: the same operations on both give byte-identical
  ``expose_text()`` and equal ``snapshot()`` (labels, escaping,
  non-finite values, quantiles, ``reset()`` keeping families), and a
  bucket mismatch is rejected by both;
- the ``MetricsServer`` lifecycle on a free port; ``StepLogger`` with a
  0-d tensor and numpy scalars;
- the tracer: span trees, the ring and the span cap, 4 threads' exact
  counts, the signal handler off the main thread; a flight-recorder dump
  of the port's engine accepted by the reference's
  ``tools/trace_check.py`` ``check_dump``;
- the profiler's host spans, their histogram and overflow counter;
- the graph-capture census and the merged timeline's lanes;
- ``model_costs`` of ``gpt2_tiny`` equal to the reference's;
- ``AnatomyLedger`` / ``RouterAnatomy`` / ``summarize`` / ``exemplars``
  on tests/test_anatomy.py's synthetic cases, equal to the reference's.
"""
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.inference import record_quant_logit_err as jax_record_err
from paddle_tpu.models.gpt import _gen_params
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.observability import anatomy as janat
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import FaultInjector, record_quant_logit_err
from paddle_tpu_torch.inference.graphs import EagerProgram
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import gpt2_tiny, params_from_numpy
from paddle_tpu_torch.observability import anatomy as panat
from paddle_tpu_torch.observability import compile_tracker as ct
from paddle_tpu_torch.observability import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the registry --------------------------------------------------------------

def _registry_ops(mod):
    """One script of registry operations, run on either package's
    ``MetricsRegistry``; returns the registry and what the reads saw."""
    reg = mod.MetricsRegistry()
    seen = []
    c = reg.counter("req_total", "requests by reason", labels=("reason",))
    c.labels(reason="eos").inc()
    c.labels(reason="eos").inc(2.5)
    c.labels(reason='we"ird\\name\nx').inc(0)
    u = reg.counter("plain_total", "an unlabeled counter")
    u.inc(7)
    g = reg.gauge("depth", 'help with "quotes" and \\ back\nslash',
                  labels=("engine", "dtype"))
    g.labels(engine="0", dtype="int8").set(3)
    g.labels(engine="1", dtype="int8").set(float("nan"))
    g.labels(engine="2", dtype="bf16").set(float("inf"))
    g.labels(engine="3", dtype="bf16").set(float("-inf"))
    g.labels(engine="4", dtype="bf16").inc(2)
    g.labels(engine="4", dtype="bf16").dec(0.5)
    h = reg.histogram("lat_seconds", "latency", labels=("kind",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.003, 0.003, 0.05, 0.5, 5.0):
        h.labels(kind="decode").observe(v)
    hd = reg.histogram("default_seconds", "default buckets")
    for v in np.linspace(0.0001, 3.0, 37):
        hd.observe(float(v))
    seen += [c.labels(reason="eos").value, u.value, hd.count, hd.sum,
             h.labels(kind="decode").quantile(0.5),
             h.labels(kind="decode").quantile(0.99), hd.quantile(0.9)]
    # get-or-create hands back the same family; a mismatch raises
    assert reg.counter("req_total", "x", labels=("reason",)) is c
    for bad in (lambda: reg.gauge("req_total", "x"),
                lambda: reg.counter("req_total", "x", labels=("other",)),
                lambda: reg.histogram("lat_seconds", "x", labels=("kind",),
                                      buckets=(0.5,))):
        with pytest.raises(ValueError):
            bad()
    g.remove(engine="3", dtype="bf16")
    g.remove_matching(dtype="int8")
    seen.append(reg.expose_text())
    reg.reset()
    c.labels(reason="length").inc()
    seen.append(reg.expose_text())
    return reg, seen


def test_registry_matches_the_reference_byte_for_byte():
    jreg, jseen = _registry_ops(jobs)
    preg, pseen = _registry_ops(pobs)
    assert pseen == jseen
    assert preg.expose_text() == jreg.expose_text()
    assert preg.snapshot() == jreg.snapshot()
    json.dumps(preg.snapshot())          # strict-JSON round trip
    assert pobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert pobs.get_registry() is pobs.get_registry()
    assert pobs.get_registry() is not jobs.get_registry()


def test_histogram_observe_n_equals_n_observes():
    """``observe(v, n)`` (the engine's per-token latency: one step's time
    for each token it emitted) is ``n`` calls, the sum bit for bit."""
    reg = pobs.MetricsRegistry()
    a = reg.histogram("a_seconds", "a")
    b = reg.histogram("b_seconds", "b")
    for v, n in ((0.1, 7), (0.0031, 3), (2.5, 1), (0.7, 0)):
        a.observe(v, n)
        for _ in range(n):
            b.observe(v)
    assert a.labels().stats() == b.labels().stats()


def test_registry_thread_safety():
    reg = pobs.MetricsRegistry()
    c = reg.counter("n_total", "n")
    h = reg.histogram("h_seconds", "h", buckets=(0.5,))
    N, T = 2000, 8

    def worker():
        for _ in range(N):
            c.inc()
            h.observe(0.1)

    threads = [threading.Thread(target=worker) for _ in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == N * T and h.count == N * T


def test_quant_logit_err_gauge_matches_the_reference():
    jreg, preg = jobs.MetricsRegistry(), pobs.MetricsRegistry()
    for lever, err in (("kv_int8", 0.0123), ("weight_int8", 1e-5)):
        assert jax_record_err(jreg, lever, err) == \
            record_quant_logit_err(preg, lever, err)
    assert preg.expose_text() == jreg.expose_text()


# -- exporters and the step logger ---------------------------------------------

def test_metrics_server_serves_and_shuts_down():
    reg = pobs.MetricsRegistry()
    reg.counter("hits_total", "hits").inc(3)
    srv = pobs.start_metrics_server(
        port=0, registry=reg, providers={"/costs.json": lambda: {"a": 1}})
    try:
        assert srv.port > 0 and srv._thread.daemon
        with urllib.request.urlopen(srv.url, timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "hits_total 3" in resp.read().decode()
        with urllib.request.urlopen(srv.url + ".json", timeout=5) as resp:
            assert json.loads(resp.read())["hits_total"]["series"][0][
                "value"] == 3
        with urllib.request.urlopen(srv.base_url + "/costs.json",
                                    timeout=5) as resp:
            assert json.loads(resp.read()) == {"a": 1}
        with urllib.request.urlopen(srv.base_url + "/healthz",
                                    timeout=5) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        with urllib.request.urlopen(srv.base_url + "/snapshot.json",
                                    timeout=5) as resp:
            snap = json.loads(resp.read())
            assert snap["format"] == pobs.SNAPSHOT_FORMAT
            assert snap["metrics"]["hits_total"]["series"][0][
                "value"] == 3
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.base_url + "/nowhere.json",
                                   timeout=5)
        with pytest.raises(ValueError):
            srv.add_provider("/metrics", dict)
        port = srv.port
    finally:
        srv.close()
    assert not srv._thread.is_alive()
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=2)


def test_step_logger_coerces_tensors(tmp_path):
    path = str(tmp_path / "steps.jsonl")
    log, owns = pobs.StepLogger.coerce(path)
    assert owns
    with log:
        log.log("train_step", step=1, loss=torch.tensor(0.25),
                n=torch.tensor(3), ok=torch.tensor(True),
                f=np.float32(1.5), i=np.int64(4),
                nan=torch.tensor(float("nan")), many=torch.ones(2))
    assert pobs.StepLogger.coerce(log) == (log, False)
    rec = json.loads(open(path).read(), parse_constant=lambda c:
                     pytest.fail(f"non-strict JSON constant {c}"))
    assert rec["loss"] == 0.25 and rec["n"] == 3 and rec["ok"] is True
    assert rec["f"] == 1.5 and rec["i"] == 4 and rec["nan"] == "NaN"
    assert isinstance(rec["many"], str)


# -- the tracer ----------------------------------------------------------------

def test_span_tree_ring_and_cap():
    t = pobs.Tracer("t", max_traces=3, max_spans_per_trace=4)
    tr = t.start_trace("request", trace_id="r1", uid=1)
    assert tr.root.span_id == 0
    with t.span("phase", trace_id="r1") as outer:
        with t.span("sub") as inner:          # implicit: same thread
            inner.set_attr(k=3)
    t.start_span("tail", trace_id="r1", parent_id=outer.span_id).end(
        tokens=7)
    d = t.end_trace("r1", finish_reason="eos").to_dict()
    by = {s["name"]: s for s in d["spans"]}
    assert by["phase"]["parent_id"] == 0
    assert by["sub"]["parent_id"] == by["phase"]["span_id"]
    assert by["tail"]["parent_id"] == by["phase"]["span_id"]
    assert by["sub"]["attrs"] == {"k": 3}
    for s in d["spans"]:
        assert d["t0"] <= s["t0"] <= s["t1"] <= d["t1"]
    for i in range(5):
        t.start_trace("x", trace_id=f"q{i}")
        t.end_trace(f"q{i}")
    assert [x.trace_id for x in t.completed_traces()] == ["q2", "q3", "q4"]
    t.start_trace("y", trace_id="caps")
    spans = [t.start_span(f"s{i}", trace_id="caps") for i in range(6)]
    assert [s.dropped for s in spans] == [False] * 3 + [True] * 3
    out = t.end_trace("caps")
    assert len(out.spans) == 4 and out.spans_dropped == 3


def test_concurrent_spans_4_threads_exact_counts():
    t = pobs.Tracer("t", max_spans_per_trace=10_000)
    t.start_trace("stress", trace_id="s")
    N, T = 400, 4
    barrier = threading.Barrier(T)

    def worker(k):
        barrier.wait()
        for i in range(N):
            t.start_span(f"w{k}", trace_id="s", i=i).end()

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(T)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    done = t.end_trace("s")
    recorded = done.spans[1:]
    assert done.spans_dropped == 0 and len(recorded) == N * T
    assert len({s.span_id for s in recorded}) == N * T
    assert len({s.tid for s in recorded}) == T


def test_signal_handler_is_a_no_op_off_the_main_thread():
    out = []
    th = threading.Thread(target=lambda: out.append(
        tracing.install_signal_handler()))
    th.start()
    th.join(timeout=10)
    assert out == [False] or tracing._signal_installed


def _engine(tmp_path, **kw):
    paddle.seed(0)
    m = jax_gpt2_tiny()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return ServingEngine(gpt2_tiny(), params_from_numpy(tree, "cpu"),
                         device="cpu", registry=pobs.MetricsRegistry(),
                         tracer=pobs.Tracer("requests"),
                         postmortem_path=str(tmp_path / "pm.json"),
                         num_slots=2, page_size=8, prefill_chunk=8,
                         max_seq_len=64, **kw)


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_flight_recorder_dump_passes_the_reference_checker(tmp_path, mixed):
    """The port's dump after a drive with a shared prefix, a cancel, a
    shed and an injected fault: ``tools/trace_check.py``'s
    ``check_dump`` (imported by path, after JAX, since it sets
    ``XLA_FLAGS`` at import) finds no problem."""
    spec = importlib.util.spec_from_file_location(
        "trace_check", os.path.join(ROOT, "tools", "trace_check.py"))
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    inj = FaultInjector()
    eng = _engine(tmp_path, mixed_step=mixed, max_queue=3,
                  shed_policy="shed_oldest", fault_injector=inj)
    rng = np.random.RandomState(0)
    head = rng.randint(1, 128, 16)
    eng.add_request(head, 4)
    eng.run()
    for i in range(3):
        eng.add_request(np.concatenate([head, rng.randint(1, 128, 5)]), 6)
    eng.cancel(eng.add_request(rng.randint(1, 128, 9), 4))   # sheds one
    eng.step()
    inj.inject("decode_error")
    eng.run()
    path = eng._dump_postmortem("manual")
    doc = json.load(open(path))
    assert doc["format"] == tc.EXPECTED_FORMAT
    problems = []
    completed = tc.check_dump(doc, problems, expect_requests=5)
    assert problems == []
    statuses = {t["status"] for t in completed}
    assert {"ok", "cancelled", "shed", "error"} <= statuses
    eng.close()


# -- the profiler ----------------------------------------------------------------

def test_record_event_histogram_spans_and_overflow(monkeypatch, tmp_path,
                                                   capsys):
    reg = pobs.MetricsRegistry()
    own = reg.histogram("dispatch_seconds", "x")
    profiler.feed_registry(reg)
    try:
        monkeypatch.setattr(profiler, "_SPAN_CAP", 3)
        profiler.start_profiler()
        with pytest.warns(RuntimeWarning, match="span buffer full"):
            for _ in range(5):
                with profiler.RecordEvent("serving.decode_step",
                                          histogram=own):
                    pass
        summary = profiler.stop_profiler(profile_path=str(
            tmp_path / "host.json"))
    finally:
        profiler.feed_registry(None)
    capsys.readouterr()
    assert own.count == 5
    assert reg.get("host_span_seconds").labels(
        name="serving.decode_step").count == 5
    assert summary["spans"] == 3 and summary["spans_dropped"] == 2
    assert reg.counter("host_spans_dropped_total").value == 2
    assert "serving.decode_step" in summary["table"]
    trace = json.load(open(tmp_path / "host.json"))
    assert trace["metadata"] == {"dropped_spans": 2}
    assert len(trace["traceEvents"]) == 3


def test_device_trace_on_the_cpu(tmp_path):
    """``start_trace`` / ``stop_trace``: a torch.profiler session written
    as chrome-trace JSON (CPU activity only here)."""
    profiler.start_trace(str(tmp_path))
    with profiler.RecordEvent("work"):
        torch.ones(8).sum()
    path = profiler.stop_trace()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "work" in names


# -- the graph-capture census and the merged timeline ---------------------------

def test_census_counts_replays_and_capture_events(tmp_path):
    ct.clear_compile_events()
    reg = pobs.MetricsRegistry()
    tracker = ct.CompileTracker(
        reg, gauge_name="serving_jit_compiles", help="graphs",
        extra_labels={"engine": "7"},
        replay_counter_name="serving_graph_replays_total")

    class Graph:        # a GraphProgram's census surface
        captures, replays = 1, 0

    progs = [EagerProgram(lambda: (lambda x: x + 1), (), "cpu")
             for _ in range(2)]
    tracker.track("decode_step", progs[0])
    tracker.track("decode_block", progs[1])
    g = tracker.track("page_copy", Graph(), t0=1.0, t1=1.5)
    tracker.track("mixed_step")
    assert tracker.counts() == {"decode_step": 0, "decode_block": 0,
                                "page_copy": 1, "mixed_step": 0}
    progs[0].replay(np.int64(1))
    progs[0].replay(np.int64(2))
    g.replays = 4
    assert tracker.publish()["decode_step"] == 1
    assert tracker.replays() == {"decode_step": 2, "decode_block": 0,
                                 "page_copy": 4, "mixed_step": 0}
    snap = reg.snapshot()
    vals = {s["labels"]["fn"]: s["value"]
            for s in snap["serving_jit_compiles"]["series"]}
    assert vals == {"decode_step": 1, "decode_block": 0, "page_copy": 1,
                    "mixed_step": 0}
    progs[0].replay(np.int64(3))
    tracker.publish()
    assert reg.get("serving_graph_replays_total").labels(
        fn="decode_step").value == 3
    ev, = ct.compile_events()
    assert ev["fn"] == "page_copy" and ev["source"] == "capture"
    assert (ev["t0"], ev["t1"], ev["engine"]) == (1.0, 1.5, "7")
    assert ct.cache_size(g) == 1 and ct.cache_size(object()) is None
    tracker.remove_series()
    assert reg.snapshot()["serving_jit_compiles"]["series"] == []
    # the merged timeline: host profiler, tracer and capture lanes
    tr = pobs.Tracer("requests")
    tr.start_trace("request", trace_id="r0")
    tr.start_span("queued", trace_id="r0").end()
    tr.end_trace("r0")
    path = pobs.export_merged_chrome_trace(str(tmp_path / "tl.json"),
                                           tracers=[tr])
    events = json.load(open(path))["traceEvents"]
    lanes = [e["args"]["name"] for e in events
             if e["name"] == "process_name"]
    assert lanes == ["host-profiler", "requests", "graph-capture"]
    assert any(e["name"] == "graph_capture:page_copy" for e in events)
    ct.clear_compile_events()


# -- the ledger ------------------------------------------------------------------

def test_model_costs_match_the_reference():
    """``gpt2_tiny``: FLOP constants exact, parameter bytes equal at the
    same (float32) dtype."""
    paddle.seed(0)
    m = jax_gpt2_tiny()
    want = jobs.model_costs(m)
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    got = pobs.model_costs(gpt2_tiny(), params_from_numpy(tree, "cpu"))
    assert got == want
    assert pobs.ledger.DEFAULT_PEAK_FLOPS == 989e12
    assert pobs.ledger.DEFAULT_PEAK_HBM_BYTES_PER_S == 3.35e12
    assert pobs.LEDGER_PHASES == jobs.LEDGER_PHASES
    assert pobs.GOODPUT_REASONS == jobs.GOODPUT_REASONS
    assert pobs.REQUEST_COST_BUCKETS == jobs.REQUEST_COST_BUCKETS


# -- the anatomy (tests/test_anatomy.py's synthetic cases) -------------------------

def _anatomy_cases(mod):
    out = []
    led = mod.AnatomyLedger()
    led.register(1, tenant="gold", priority=2, trace_id="t1", step=0)
    led.on_step()
    led.on_step()
    led.note_state(1, "prefill")
    led.on_step()
    led.note_state(1, "decode")
    led.on_step()
    led.resolve_decode(True)
    led.on_step()
    led.resolve_decode(False)
    out += [led.finish(1, 5, "length"), led.blocked_frac(),
            led.conservation_check(), led.finish(99, 7, "shed"),
            led.request_records(), led.sequence_of(1)]
    ra = mod.RouterAnatomy()
    ra.register(7, tenant="bulk", step=2)
    ra.note_placed(7, 5)
    out.append(ra.finish(7, 10, "length", engine_segments=[
        ["queued", 1], ["prefill", 2], ["decode_compute", 3]]))
    ra.register(8, step=0)
    ra.note_placed(8, 3)
    ra.note_unplaced(8, 7, "rerun", engine_segments=[
        ["prefill", 2], ["decode_compute", 3]], counted=True)
    out.append(ra.finish(8, 9, "length"))
    ra.register(9, step=0)
    ra.note_placed(9, 1)
    ra.note_unplaced(9, 4, "migrated", engine_segments=[
        ["prefill", 1], ["decode_compute", 2]], counted=False)
    ra.note_placed(9, 6)
    out += [ra.finish(9, 8, "length",
                      engine_segments=[["decode_compute", 3]]),
            ra.conservation_check()]
    recs = [
        {"uid": u, "tenant": t, "priority": p, "trace_id": f"t{u}",
         "segments": seq, "totals": mod.segment_totals(seq),
         "total_steps": sum(n for _, n in seq), "conserved": True,
         "blocked_frac": 0.0}
        for u, t, p, seq in (
            (0, "gold", 2, [["queued", 1], ["decode_compute", 4]]),
            (1, "bulk", 0, [["queued", 6], ["decode_blocked", 2]]),
            (2, "bulk", 0, [["prefill", 2], ["decode_compute", 2]]))]
    out += [mod.summarize(recs), mod.exemplars(recs, k=2),
            mod.exemplars(recs, tenant="bulk"),
            mod.records_from_journal([
                {"kind": "submit", "uid": 3, "step": 1, "tenant": "a"},
                {"kind": "complete", "uid": 3, "step": 4,
                 "finish_reason": "eos",
                 "segments": [["queued", 1], ["decode_compute", 2]]}])]
    return out


def test_anatomy_matches_the_reference():
    got, want = _anatomy_cases(panat), _anatomy_cases(janat)
    assert got == want
    assert got[2] == {"checked": 1, "conserved": 1, "frac": 1.0}
    assert got[0]["segments"] == [["queued", 2], ["prefill", 1],
                                  ["decode_blocked", 1],
                                  ["decode_compute", 1]]
    assert panat.SEGMENTS == janat.SEGMENTS
    assert panat.SEGMENT_STEP_BUCKETS == janat.SEGMENT_STEP_BUCKETS
