"""Serving telemetry of the PyTorch port (``paddle_tpu_torch/observability``
wired into ``inference/serving.py`` and ``inference/speculative.py``)
against the JAX reference's on the same traffic: the JAX engine
(``attention="jax"``, ``cost_analysis=False``) and the port's engine run
the same requests, each into a fresh ``MetricsRegistry`` and its own
``Tracer``, with the reference's seed-made weights carried across
(tests/test_speculative.py's model: vocab 97, hidden 32, 2 layers, 4
heads, 64 positions; pages and chunks of 8).

Held equal, per case:

- every counter series;
- every histogram's observation count; the bucket counts and sums
  (1e-9 relative) of the value histograms (``VALUE_HISTOGRAMS``) — the
  wall-time histograms' buckets depend on the two implementations'
  speeds;
- every gauge after mapping the ``engine`` label, but those that divide
  by wall time (``WALL_GAUGES``); ``serving_logit_absmax`` within 1e-4
  relative (float32 logits of two implementations);
  ``serving_jit_compiles`` by its stated mapping (``CENSUS``);
- ``ledger.totals()`` FLOPs and bytes per phase, and the tenant totals,
  within 1e-9 relative;
- ``anatomy_report()`` per-request segment sequences;
- per trace, the ordered span names, the parent links and the integer
  attributes (``SPAN_ATTRS_EXCLUDED`` names each excluded attribute with
  its reason), the float ones within 1e-9 relative.

The cases: per phase (fused blocks and a shared prefix with
copy-on-write), ``mixed_step=True``, speculative per phase and mixed,
int8 pools, a ``FaultInjector`` drill (preemption and resume, a
deadline, a cancel, a shed, an injected dispatch fault), two tenants.
Also: tokens are identical with ``tracing=False``; an exception inside
``step()`` dumps a postmortem holding the in-flight traces; a tracer
that fails is swallowed (the reference's null-span contract); and
``bench_serving.main`` at ``--model tiny`` on the CPU prints the
reference's keys. Card tests of the captured engine are in
tests/test_torch_cuda.py."""
import json
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import FaultInjector as JaxFaultInjector
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import truncate_draft as jax_truncate_draft
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import Tracer as JaxTracer
from paddle_tpu_torch.inference import FaultInjector
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry, Tracer

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
KW = dict(page_size=8, prefill_chunk=8, max_seq_len=64)

# histograms of values (not times): their sums are held too
VALUE_HISTOGRAMS = {
    "serving_tokens_per_dispatch", "serving_ragged_q_len",
    "serving_spec_accept_rate", "serving_segment_steps",
    "serving_preempted_resume_cached_frac", "serving_request_cost_flops",
    "serving_request_cost_hbm_bytes"}
# gauges that divide by the engine's wall time
WALL_GAUGES = {"serving_mfu", "serving_mbu", "serving_mfu_per_chip",
               "serving_mbu_per_chip", "serving_goodput_tokens_per_s",
               "serving_raw_tokens_per_s"}
# the one family compared by mapping: the reference counts the XLA
# executables compiled per jitted function, the port the CUDA graphs
# captured per program, an eager program (every program on the CPU)
# counting 1 from its first dispatch — so on the CPU, where each jit
# compiles at its first call, the counts are equal name for name
CENSUS = "serving_jit_compiles"
# port-only families: CUDA-graph replays have no reference counterpart
PORT_ONLY = {"serving_graph_replays_total"}
# span attributes not compared, each with its reason
SPAN_ATTRS_EXCLUDED = {
    "engine": "the engine id: a process-wide counter, mapped instead",
    "queue_wait_s": "wall time",
    "waited_s": "wall time",
    "auto_ended": "compared with the span's own presence",
}


@pytest.fixture(scope="module")
def ref():
    """The reference's tiny model and ``truncate_draft(model, 1)``, and
    its weights as the port's parameter dict."""
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, jax_truncate_draft(m, 1), params_from_numpy(tree, "cpu")


def _jax(ref, tmp_path, spec=False, **kw):
    kw.setdefault("num_slots", 3)
    if spec:
        kw.update(speculative=ref[1], draft_k=4)
    return JaxEngine(ref[0], attention="jax", cost_analysis=False,
                     registry=JaxRegistry(), tracer=JaxTracer("requests"),
                     postmortem_path=str(tmp_path / "jax_pm.json"),
                     **dict(KW, **kw))


def _port(ref, tmp_path, spec=False, **kw):
    kw.setdefault("num_slots", 3)
    if spec:
        kw.update(speculative=1, draft_k=4)
    return ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                         registry=MetricsRegistry(),
                         tracer=Tracer("requests"),
                         postmortem_path=str(tmp_path / "port_pm.json"),
                         **dict(KW, **kw))


def _traffic(n=6, seed=0, shared=0, lo=4, hi=20, max_new=(3, 9)):
    """Greedy requests from a seed: prompts of ``lo .. hi`` tokens, the
    first ``shared`` tokens common to all."""
    rng = np.random.RandomState(seed)
    head = rng.randint(1, 97, shared)
    out = []
    for i in range(n):
        p = np.concatenate([head, rng.randint(1, 97, rng.randint(lo, hi))])
        out.append((p.astype(np.int32), int(rng.randint(*max_new))))
    return out


def _drive(eng, reqs, tenants=None, every=0):
    """Submit ``reqs`` (all at once, or one every ``every`` steps) and
    drain; returns {uid: tokens}."""
    done = {}
    for i, (p, n) in enumerate(reqs):
        eng.add_request(p, n, tenant=None if tenants is None
                        else tenants[i % len(tenants)])
        for _ in range(every):
            for c in eng.step():
                done[c.uid] = c
    for c in eng.run(max_steps=10_000).values():
        done[c.uid] = c
    return {u: (list(c.tokens), c.finish_reason) for u, c in done.items()}


# -- the comparisons -----------------------------------------------------------

def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-30)


def _close(a, b, tol=1e-9):
    if a is None or b is None:
        return a is b
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b or _rel(float(a), float(b)) <= tol


def _series(snap, fam, engine_map):
    out = {}
    for s in snap[fam]["series"]:
        labels = dict(s["labels"])
        if "engine" in labels:
            labels["engine"] = engine_map.get(labels["engine"],
                                              labels["engine"])
        out[tuple(sorted(labels.items()))] = s
    return out


def check_registries(jeng, peng):
    js = jeng.metrics.snapshot()
    ps = peng.metrics.snapshot()
    emap = {jeng.engine_id: "E", peng.engine_id: "E"}
    assert set(ps) - PORT_ONLY == set(js), (
        set(ps) ^ set(js))
    for fam, jf in js.items():
        pf = ps[fam]
        assert pf["type"] == jf["type"], fam
        jser, pser = _series(js, fam, emap), _series(ps, fam, emap)
        if fam in WALL_GAUGES:
            assert set(pser) == set(jser), fam
            continue
        assert set(pser) == set(jser), (fam, set(pser) ^ set(jser))
        for key, j in jser.items():
            p = pser[key]
            if jf["type"] == "histogram":
                assert p["count"] == j["count"], (fam, key)
                if fam in VALUE_HISTOGRAMS:
                    assert p["buckets"] == j["buckets"], (fam, key)
                    assert _close(p["sum"], j["sum"]), (fam, key)
            elif fam == "serving_logit_absmax":
                assert _close(p["value"], j["value"], 1e-4), (fam, key)
            elif fam == CENSUS:
                # by the mapping: the reference's executables compiled
                # for a function, the port's programs built under the
                # same name (on the CPU: built at the first dispatch)
                assert p["value"] == j["value"], (fam, key)
            else:       # counters and the other gauges
                assert _close(p["value"], j["value"]), (
                    fam, key, p["value"], j["value"])


def check_ledger(jeng, peng):
    jt, pt = jeng.ledger.totals(), peng.ledger.totals()
    for key in ("flops", "bytes"):
        assert set(pt[key]) == set(jt[key])
        for phase, v in jt[key].items():
            assert _close(pt[key][phase], v), (key, phase)
    assert pt["kv_bytes_per_token"] == jt["kv_bytes_per_token"]
    assert pt["weight_bytes_per_step"] == jt["weight_bytes_per_step"]
    jtt, ptt = jeng.ledger.tenant_totals(), peng.ledger.tenant_totals()
    assert set(ptt) == set(jtt)
    for t, j in jtt.items():
        p = ptt[t]
        for key in ("flops", "hbm_bytes"):
            assert set(p[key]) == set(j[key]), (t, key)
            for phase, v in j[key].items():
                assert _close(p[key][phase], v), (t, key, phase)
        for key in ("tokens", "goodput_tokens", "cached_tokens",
                    "requests"):
            assert p[key] == j[key], (t, key)
    assert peng.ledger.attribution_check()["conserved"]


def check_anatomy(jeng, peng):
    jr, pr = jeng.anatomy_report(), peng.anatomy_report()
    assert {r["uid"]: r["segments"] for r in pr["records"]} == \
        {r["uid"]: r["segments"] for r in jr["records"]}
    assert pr["conservation"] == jr["conservation"]
    assert pr["decode_blocked_frac"] == jr["decode_blocked_frac"]
    assert pr["conservation"]["frac"] == 1.0


def _trace_view(doc, eid):
    out = {}
    for tr in doc["completed"] + doc["in_flight"]:
        tid = tr["trace_id"].replace(f"e{eid}:", "E:")
        spans = []
        for sp in tr["spans"]:
            attrs = {k: v for k, v in sp["attrs"].items()
                     if k not in SPAN_ATTRS_EXCLUDED}
            spans.append((sp["name"], sp["span_id"], sp["parent_id"],
                          attrs))
        out[tid] = (tr["status"], spans)
    return out


def check_traces(jeng, peng):
    jv = _trace_view(jeng._tracer.to_dict(), jeng.engine_id)
    pv = _trace_view(peng._tracer.to_dict(), peng.engine_id)
    assert set(pv) == set(jv)
    for tid, (status, jspans) in jv.items():
        pstatus, pspans = pv[tid]
        assert pstatus == status, tid
        assert [s[:3] for s in pspans] == [s[:3] for s in jspans], tid
        for (name, sid, _, ja), (_, _, _, pa) in zip(jspans, pspans):
            assert set(pa) == set(ja), (tid, name, set(pa) ^ set(ja))
            for k, v in ja.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    assert pa[k] == v, (tid, name, k, pa[k], v)
                elif isinstance(v, int):
                    assert pa[k] == v and isinstance(pa[k], int), (
                        tid, name, k, pa[k], v)
                else:
                    assert _close(pa[k], v), (tid, name, k, pa[k], v)


def check_all(jeng, peng, jout, pout):
    assert pout == jout
    check_registries(jeng, peng)
    check_ledger(jeng, peng)
    check_anatomy(jeng, peng)
    check_traces(jeng, peng)


# -- the cases -----------------------------------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_telemetry_matches_the_reference(ref, tmp_path, mixed):
    """Staggered arrivals over a shared 16-token prefix (prefix hits and
    a copy-on-write page), fused blocks in the per-phase drain, and
    logit health."""
    reqs = _traffic(6, seed=1, shared=16, lo=1, hi=12, max_new=(4, 24))
    # one prompt exactly the shared prefix: a fully cached prompt
    reqs[3] = (reqs[0][0][:16], 5)
    kw = dict(mixed_step=mixed, logit_health=True)
    jeng, peng = _jax(ref, tmp_path, **kw), _port(ref, tmp_path, **kw)
    # the first request alone first, so the prefix is registered and
    # written before the others map it (ROADMAP C14 traffic avoided)
    jout = _drive(jeng, reqs[:1]) | _drive(jeng, reqs[1:], every=2)
    pout = _drive(peng, reqs[:1]) | _drive(peng, reqs[1:], every=2)
    assert peng.stats["cow_copies"] == jeng.stats["cow_copies"] > 0
    assert peng.stats["prefix_hits"] > 0
    if not mixed:
        assert peng.stats["fused_blocks"] > 0
    check_all(jeng, peng, jout, pout)


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_speculative_telemetry_matches_the_reference(ref, tmp_path, mixed):
    """Speculative rounds: spec spans, acceptance series and the
    draft's ledger phase."""
    reqs = _traffic(4, seed=2, max_new=(6, 20))
    kw = dict(mixed_step=mixed, logit_health=True, spec=True)
    jeng, peng = _jax(ref, tmp_path, **kw), _port(ref, tmp_path, **kw)
    jout, pout = _drive(jeng, reqs), _drive(peng, reqs)
    assert peng.stats["spec_rounds"] == jeng.stats["spec_rounds"] > 0
    assert peng.ledger.totals()["flops"]["spec_draft"] > 0
    check_all(jeng, peng, jout, pout)


def test_int8_pool_telemetry_matches_the_reference(ref, tmp_path):
    """int8 pools: the KV bytes a token and the pool gauge at the
    pool's storage, the rest as above."""
    reqs = _traffic(5, seed=3)
    jeng = _jax(ref, tmp_path, kv_dtype="int8")
    peng = _port(ref, tmp_path, kv_dtype="int8")
    jout, pout = _drive(jeng, reqs, every=1), _drive(peng, reqs, every=1)
    check_all(jeng, peng, jout, pout)


@pytest.mark.parametrize("mixed", [False, True], ids=["per_phase", "mixed"])
def test_fault_drill_telemetry_matches_the_reference(ref, tmp_path, mixed):
    """tests/test_anatomy.py's drill: a page-pressure preemption resumed
    to completion, a deadline, a cancel, a shed at the queue bound and
    an injected dispatch fault, on each engine with its own injector."""
    kw = dict(num_slots=2, num_pages=9, decode_block=1, max_queue=2,
              shed_policy="shed_oldest", mixed_step=mixed)
    outs = []
    for make, inj in ((_jax, JaxFaultInjector()), (_port, FaultInjector())):
        eng = make(ref, tmp_path, fault_injector=inj, **kw)
        rng = np.random.RandomState(7)
        done = {}

        def drain():
            for c in eng.run(max_steps=10_000).values():
                done[c.uid] = (list(c.tokens), c.finish_reason)

        eng.add_request(rng.randint(1, 97, 12), 20, priority=0,
                        tenant="bulk")
        for _ in range(6):
            for c in eng.step():
                done[c.uid] = (list(c.tokens), c.finish_reason)
        eng.add_request(rng.randint(1, 97, 20), 20, priority=5,
                        tenant="gold")
        drain()                       # preempt + resume
        eng.add_request(rng.randint(1, 97, 8), 4, deadline_s=0.0)
        eng.cancel(eng.add_request(rng.randint(1, 97, 8), 4))
        drain()                       # deadline + cancel
        for _ in range(3):
            eng.add_request(rng.randint(1, 97, 8), 4)  # the 3rd sheds
        inj.inject("decode_error")
        drain()                       # shed + injected fault
        eng.kv.verify()
        outs.append((eng, done))
    (jeng, jout), (peng, pout) = outs
    reasons = {r for _, r in pout.values()}
    assert {"length", "deadline", "cancelled", "shed", "error"} <= reasons
    assert peng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    check_all(jeng, peng, jout, pout)
    # close() retires both engines' series alike
    jeng.close()
    peng.close()
    check_registries(jeng, peng)


def test_two_tenants_telemetry_matches_the_reference(ref, tmp_path):
    """Two tenants and two priority tiers: the tenant families, the
    goodput tiers and the conservation of tenant sums."""
    reqs = _traffic(6, seed=4)
    jeng, peng = _jax(ref, tmp_path), _port(ref, tmp_path)
    done = []
    for eng in (jeng, peng):
        for i, (p, n) in enumerate(reqs):
            eng.add_request(p, n, tenant=("gold", "bulk")[i % 2],
                            priority=i % 2)
        done.append({u: (list(c.tokens), c.finish_reason)
                     for u, c in eng.run(max_steps=10_000).items()})
    assert set(peng.ledger.tenant_totals()) == {"gold", "bulk"}
    check_all(jeng, peng, *done)


# -- the port on its own -------------------------------------------------------

def test_tracing_off_changes_no_token(ref, tmp_path):
    """``tracing=False``: no tracer, no trace ids, the same tokens."""
    reqs = _traffic(5, seed=5)
    on = _port(ref, tmp_path, logit_health=True)
    off = ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                        registry=MetricsRegistry(), tracing=False,
                        **dict(KW, num_slots=3))
    assert off._tracer is None
    assert _drive(off, reqs, every=1) == _drive(on, reqs, every=1)


def test_step_exception_dumps_the_in_flight_traces(ref, tmp_path):
    """An exception inside ``step()`` writes the postmortem before the
    teardown: the dump holds the requests in flight at the failure."""
    eng = _port(ref, tmp_path)
    for p, n in _traffic(3, seed=6, max_new=(8, 12)):
        eng.add_request(p, n)
    for _ in range(3):
        eng.step()

    def boom(*a, **k):
        raise RuntimeError("device lost")

    eng._run_decode_step = boom
    eng._run_decode_block = boom
    with pytest.raises(RuntimeError, match="device lost"):
        eng.step()
    doc = json.load(open(tmp_path / "port_pm.json"))
    assert doc["reason"] == "exception"
    assert doc["format"] == "paddle_tpu-flight-recorder-v1"
    assert len(doc["in_flight"]) == 3
    assert {t["trace_id"] for t in doc["in_flight"]} == {
        f"e{eng.engine_id}:req{u}" for u in range(3)}
    eng.kv.verify()
    # the teardown then failed them, each with its decision span
    tr = eng._tracer.get(f"e{eng.engine_id}:req0")
    assert tr.status == "error" and tr.find("fault")


def test_a_failing_tracer_is_swallowed(ref, tmp_path):
    """The reference's contract, kept: a tracer that raises on
    ``start_span`` yields null spans and the engine serves on, tokens
    unchanged."""
    reqs = _traffic(3, seed=8)
    good = _drive(_port(ref, tmp_path), reqs)

    class Broken(Tracer):
        def start_span(self, *a, **k):
            raise RuntimeError("tracer bug")

    eng = ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                        registry=MetricsRegistry(), tracer=Broken("b"),
                        postmortem_path=str(tmp_path / "b.json"),
                        **dict(KW, num_slots=3))
    assert _drive(eng, reqs) == good


def test_constructor_surface(ref, tmp_path):
    """The reference's telemetry keywords construct; ``add_request``
    takes ``trace_ctx=`` and ``tenant=``; ``mesh=`` still raises
    (``journal=`` and ``watchdog=`` are ported: tests/test_torch_journal.py
    and tests/test_torch_slo.py)."""
    reg, tracer = MetricsRegistry(), Tracer("caller")
    eng = ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                        registry=reg, tracer=Tracer("requests"),
                        step_log=str(tmp_path / "steps.jsonl"),
                        postmortem_path=str(tmp_path / "pm.json"),
                        logit_health=True, peak_flops=1e12,
                        peak_hbm_bytes_per_s=1e11, **KW)
    tracer.start_trace("rpc", trace_id="caller-1")
    ctx = tracer.inject("caller-1")
    eng.add_request([1, 2, 3], 4, trace_ctx=ctx, tenant="t1")
    eng.add_request([4, 5], 3, trace_ctx={"bogus": 1})
    eng.run()
    root = eng._tracer.get(f"e{eng.engine_id}:req0").root
    assert root.attrs["parent_trace_id"] == "caller-1"
    assert eng.ledger.totals()["peak_flops"] == 1e12
    assert set(eng.ledger.tenant_totals()) == {"t1", "default"}
    assert eng.close() == {}
    lines = open(tmp_path / "steps.jsonl").read().splitlines()
    assert lines and all(json.loads(x)["event"] == "serving_step"
                         for x in lines)
    assert json.load(open(tmp_path / "pm.json"))["reason"] == "close"
    with pytest.raises(NotImplementedError):
        ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                      mesh=object(), **KW)


# the keys of the reference's default-stream line
# (tools/bench_serving.py ``rec`` in ``main``, its ledger_fields and
# anatomy_fields)
BENCH_KEYS = (
    "metric", "value", "unit", "mp", "kv_shard", "tokens_per_chip_vs_mp1",
    "kv_pool_bytes_per_chip", "collective_bytes_per_token",
    "decode_collective_bytes_counted", "decode_collective_bytes_predicted",
    "p50_ms_per_token", "p99_ms_per_token", "ttft_p50_ms", "ttft_p99_ms",
    "prefill_chunks", "requests", "slots", "page_size", "prefill_chunk",
    "prompt_range", "max_new", "attention", "attention_impl", "prefix_len",
    "decode_block", "kv_dtype", "weight_dtype", "collective_dtype",
    "weight_bytes_per_step", "decode_hbm_bytes_per_token",
    "quant_logit_err_absmax", "kv_pool_bytes", "bytes_per_resident_token",
    "steady_decode", "decode_dispatches", "dispatches_per_token",
    "tokens_per_dispatch", "decode_compiles", "decode_block_compiles",
    "attribution_conserved", "prefill_compiles", "watchdog_trips_total",
    "slo_alerts_total", "tenants", "platform", "chips", "snapshot",
    "mfu", "mbu", "model_flops_total", "hbm_bytes_total",
    "goodput_tokens_per_s", "raw_tokens_per_s", "goodput_frac",
    "kv_bytes_per_token", "weight_dtype_ledger", "hbm_bytes_decode",
    "hbm_bytes_prefill", "mfu_per_chip", "mbu_per_chip",
    "collective_bytes_total", "ledger_peak_flops",
    "ledger_peak_hbm_bytes_per_s", "anatomy_conserved_frac",
    "decode_blocked_frac", "anatomy")


def test_bench_serving_prints_the_reference_keys(capsys):
    """``bench_serving.main`` at ``--model tiny`` on the CPU: one JSON
    line a ``--kv-dtype`` value, each with every key of the reference's
    line; the ledger priced against one H100; the not-ported flags exit
    non-zero."""
    from paddle_tpu_torch.tools import bench_serving
    args = ["--model", "tiny", "--requests", "6", "--slots", "2",
            "--max-new", "6", "--min-prompt", "4", "--max-prompt", "12",
            "--page-size", "8", "--prefill-chunk", "8",
            "--warmup-requests", "1", "--kv-dtype", "none,int8",
            "--tenants", "a:1,b:1", "--device", "cpu"]
    bench_serving.main(args)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert [r["kv_dtype"] for r in out] == ["param", "int8"]
    for line in out:
        assert not set(BENCH_KEYS) - set(line), set(BENCH_KEYS) - set(line)
        assert line["platform"] == "cpu"
        assert line["anatomy_conserved_frac"] == 1.0
        assert line["attribution_conserved"] == 1.0
        assert line["ledger_peak_flops"] == 989e12
        assert line["ledger_peak_hbm_bytes_per_s"] == 3.35e12
        # the warm-up traffic is the "default" tenant, as the reference's
        assert set(line["tenants"]) == {"a", "b", "default"}
        assert line["decode_compiles"] == 1
    assert out[1]["quant_logit_err_absmax"] is not None
    for flag in ("--fleet", "--mesh", "--autoscale", "--spec-train-steps"):
        with pytest.raises(SystemExit) as e:
            bench_serving.main(["--model", "tiny", flag, "2"])
        assert e.value.code != 0
