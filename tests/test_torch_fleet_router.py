"""The fleet router of the PyTorch port (``paddle_tpu_torch/inference/
router.py``: ``EngineReplica``, ``FleetRouter``) against the JAX
reference's on the CPU.

The model is the reference's fleet-test GPT (vocab 97, hidden 32, 2
layers, 4 heads, 64 positions) built after ``paddle.seed(0)``, its weights
carried to the port through numpy; replicas of 2 slots, pages and chunks
of 8, ``decode_block=1``. Each case of ``tests/test_fleet_router.py``
drives a JAX fleet (``ServingEngine(attention="jax")`` replicas) and a
port fleet through the same stream, and holds equal across the two:
greedy requests' tokens, every finish reason, ``steps_taken``, placements
by decision and replica (``router_requests_total``), affinity hits and
misses and the router's ``requeued`` / ``replica_deaths`` /
``preempts_remote`` / ``drains`` / ``joins``. Sampled requests' tokens are
held within a package (each package's fleet against its own unfailed
single engine): the two packages' generators differ. The overload case
holds survival and identity only; its high-tier TTFT ratio is wall-clock
on a shared CPU and is recorded in the test's output, never held. Port
against port: a sampled request rerun after a death equals an unfailed
run, and a step that raises something other than ``ReplicaDown`` marks
its replica dead too (the reference's contract).
Tolerances: none; every comparison is exact."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import EngineReplica as JaxReplica
from paddle_tpu.inference import FaultInjector as JaxFaultInjector
from paddle_tpu.inference import FleetRouter as JaxRouter
from paddle_tpu.inference import QueueFullError as JaxQueueFull
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import Tracer as JaxTracer
from paddle_tpu_torch.inference import (EngineReplica, FaultInjector,
                                        FleetRouter, QueueFullError,
                                        ServingEngine)
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry, Tracer
from paddle_tpu_torch.observability import journal as jnl

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)
KW = dict(num_slots=2, page_size=8, prefill_chunk=8, max_seq_len=64,
          decode_block=1)

# the reference's canonical mixed stream: two 2-page shared-prefix groups
# (the affinity subject) + unique prompts, greedy AND fixed-seed sampled
_RNG = np.random.RandomState(7)
_PREF_A = _RNG.randint(0, 97, 16)
_PREF_B = _RNG.randint(0, 97, 16)
REQS = []  # (prompt, max_new, temperature, seed)
for _i in range(8):
    _pref = _PREF_A if _i % 2 else _PREF_B
    REQS.append((np.concatenate([_pref, _RNG.randint(0, 97, 4 + _i % 3)]),
                 6 + _i % 4, 0.0 if _i < 4 else 0.9, 100 + _i))
for _i in range(4):
    REQS.append((_RNG.randint(0, 97, 6 + _i), 8, 0.0 if _i % 2 else 0.7,
                 200 + _i))


class Pkg:
    """One package's fleet parts, so one case body drives either."""

    def __init__(self, name, make, router, replica, injector, registry,
                 tracer, queue_full):
        self.name = name
        self._make = make
        self.Router, self.Replica = router, replica
        self.FaultInjector, self.Registry = injector, registry
        self.Tracer, self.QueueFullError = tracer, queue_full

    def engine(self, **kw):
        return self._make(**dict(KW, registry=self.Registry(), **kw))

    def router(self, engines, names=None, **kw):
        names = names or [f"r{i}" for i in range(len(engines))]
        kw.setdefault("registry", self.Registry())
        return self.Router([self.Replica(e, n)
                            for e, n in zip(engines, names)], **kw)

    def solo(self, reqs):
        """An unfailed single engine's tokens for ``reqs``."""
        eng = self.engine()
        uids = [eng.add_request(p, n, temperature=t, seed=s)
                for p, n, t, s in reqs]
        done = eng.run(max_steps=100_000)
        eng.close()
        return [done[u].tokens for u in uids]


@pytest.fixture(scope="module")
def pkgs():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(**CFG))
    m.eval()
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _gen_params(m)), "cpu")
    jx = Pkg("jax", lambda **kw: JaxEngine(m, attention="jax",
                                           cost_analysis=False, **kw),
             JaxRouter, JaxReplica, JaxFaultInjector, JaxRegistry,
             JaxTracer, JaxQueueFull)
    pt = Pkg("port", lambda **kw: ServingEngine(GPTConfig(**CFG), params,
                                                device="cpu", **kw),
             FleetRouter, EngineReplica, FaultInjector, MetricsRegistry,
             Tracer, QueueFullError)
    return {"jax": jx, "port": pt}


STATS = ("submitted", "completed", "placements", "affinity_hits",
         "affinity_misses", "preempts_remote", "requeued", "drains",
         "joins", "replica_deaths", "sheds", "expired", "cancelled")


def _observe(router, done, uids, reqs):
    """What the two packages must agree on: greedy tokens, finish
    reasons, the router's clock, stats and placements."""
    snap = router.metrics.snapshot()
    placed = {(s["labels"]["replica"], s["labels"]["decision"]): s["value"]
              for s in snap["router_requests_total"]["series"]
              if s["value"]}
    return {
        "greedy_tokens": {i: list(done[u].tokens)
                          for i, u in enumerate(uids)
                          if reqs[i][2] == 0.0 and u in done},
        "lengths": {i: len(done[u].tokens) for i, u in enumerate(uids)
                    if u in done},
        "finish": {i: done[u].finish_reason for i, u in enumerate(uids)
                   if u in done},
        "steps_taken": router.steps_taken,
        "stats": {k: router.stats[k] for k in STATS},
        "placements": placed,
        "statuses": {n: st.status for n, st in router.replicas.items()}}


def _identity(pkg, done, uids, reqs):
    """Every request's tokens (sampled too) equal to the package's own
    unfailed single engine's."""
    ref = pkg.solo(reqs)
    for i, u in enumerate(uids):
        assert list(done[u].tokens) == list(ref[i]), (pkg.name, i)


# -- the cases of tests/test_fleet_router.py, one body for both packages --

def case_migrate(pkg):
    """``eject`` mid-decode from one engine, ``admit_migrated`` on
    another: both requests finish with the unfailed engine's tokens,
    priority and tenant carried."""
    e0, e1 = pkg.engine(), pkg.engine()
    pick = [REQS[0], REQS[4]]
    (p, n, t, s), (p2, n2, t2, s2) = pick
    a = e0.add_request(p, n, temperature=t, seed=s, priority=1,
                       tenant="gold")
    b = e0.add_request(p2, n2, temperature=t2, seed=s2)
    for _ in range(6):
        e0.step()
    infl = {v["uid"]: v for v in e0.inflight()}
    assert infl[a]["tokens_out"] > 0 or infl[b]["tokens_out"] > 0
    ra, rb = e0.eject(a), e0.eject(b)
    assert not e0.has_work
    e0.kv.verify()
    assert ra.priority == 1 and ra.tenant == "gold"
    na, nb = e1.admit_migrated(ra), e1.admit_migrated(rb)
    done = e1.run(max_steps=100_000)
    e1.kv.verify()
    assert done[na].tenant == "gold"
    with pytest.raises(KeyError):
        e0.eject(a)
    got = [done[na].tokens, done[nb].tokens]
    assert got == pkg.solo(pick), pkg.name
    out = {"greedy_tokens": {0: list(got[0])},
           "tokens_out_at_eject": [len(ra.resume_out or []),
                                   len(rb.resume_out or [])],
           "counters": {k: e1.stats[k]
                        for k in ("tokens_emitted", "prefill_chunks")}}
    e0.close()
    e1.close()
    return out


def case_affinity(pkg):
    """Affinity against random on the same stream, every completion equal
    to the unfailed engine's; route spans carry their schema."""
    pair = [pkg.engine(), pkg.engine()]
    router = pkg.router(pair, tracer=pkg.Tracer("router",
                                                replica="router0"))
    uids = [router.submit(p, n, temperature=t, seed=s,
                          tenant="gold" if i % 2 else "bulk")
            for i, (p, n, t, s) in enumerate(REQS)]
    done = router.run(max_steps=100_000)
    assert len(done) == len(REQS)
    _identity(pkg, done, uids, REQS)
    hit_rate = router.affinity_hit_rate()
    assert hit_rate is not None and hit_rate >= 0.5
    obs = _observe(router, done, uids, REQS)
    hits = [c for c in router.completed if c["affinity_hit"]]
    assert hits
    cached = {}
    for name in {c["replica"] for c in hits}:
        snap = router.replicas[name].handle.engine.metrics.snapshot()
        cached[name] = sum(s["value"] for s in snap[
            "serving_prefix_cached_tokens_total"]["series"])
        assert cached[name] > 0, name
    for tr in router._tracer.completed_traces():
        if tr.name != "routed_request":
            continue
        routes = [sp for sp in tr.spans if sp.name == "route"]
        assert routes, tr.trace_id
        for sp in routes:
            for a in ("replica", "decision", "affinity_digest", "scores"):
                assert a in sp.attrs, (tr.trace_id, a)
    rnd = pkg.router(pair, policy="random", seed=11)
    for p, n, t, s in REQS:
        rnd.submit(p, n, temperature=t, seed=s)
    rnd.run(max_steps=100_000)
    assert rnd.affinity_hit_rate() < hit_rate
    for eng in pair:
        eng.close()
    return dict(obs, hit_rate=hit_rate,
                random_hit_rate=rnd.affinity_hit_rate(),
                random_steps=rnd.steps_taken, cached=cached)


def case_shed(pkg):
    """``max_queue`` and the shed policy at the ROUTER tier."""
    pair = [pkg.engine(), pkg.engine()]
    router = pkg.router(pair, max_queue=2,
                        shed_policy="shed_lowest_priority")
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 97, 6), 4, 0.0, 0) for _ in range(3)]
    uids = [router.submit(p, n, priority=pr)
            for (p, n, _, _), pr in zip(reqs, (0, 0, 2))]
    done = router.run(max_steps=100_000)
    assert [done[u].finish_reason for u in uids] == \
        ["length", "shed", "length"]
    obs = _observe(router, done, uids, reqs)
    router2 = pkg.router(pair, max_queue=1, shed_policy="reject")
    router2.submit(rng.randint(0, 97, 6), 4)
    with pytest.raises(pkg.QueueFullError):
        router2.submit(rng.randint(0, 97, 6), 4)
    router2.run(max_steps=100_000)
    for eng in pair:
        eng.close()
    return dict(obs, reject_stats={k: router2.stats[k] for k in STATS})


def case_preempt(pkg):
    """A high-tier burst on a saturated fleet preempts low-tier work on
    the other replica; victims migrate and finish with the unfailed
    engine's tokens; the ``preempt_remote`` span names its victim."""
    pair = [pkg.engine(), pkg.engine()]
    tracer = pkg.Tracer("router", replica="router0")
    router = pkg.router(pair, saturation_depth=1, tracer=tracer)
    rng = np.random.RandomState(9)
    low_reqs = [(rng.randint(0, 97, 8), 18, 0.0 if i % 2 else 0.6,
                 300 + i) for i in range(6)]
    high_reqs = [(rng.randint(0, 97, 8), 6, 0.0, 400 + i)
                 for i in range(2)]
    reqs = low_reqs + high_reqs
    low = [router.submit(p, n, temperature=t, seed=s, priority=0,
                         tenant="bulk") for p, n, t, s in low_reqs]
    for _ in range(4):
        router.step()
    high = [router.submit(p, n, temperature=t, seed=s, priority=2,
                          tenant="gold") for p, n, t, s in high_reqs]
    done = router.run(max_steps=100_000)
    uids = low + high
    assert router.stats["preempts_remote"] >= 1
    assert all(done[u].finish_reason == "length" for u in uids)
    _identity(pkg, done, uids, reqs)
    spans = [sp for tr in tracer.completed_traces()
             for sp in tr.spans if sp.name == "preempt_remote"]
    assert spans
    for sp in spans:
        for a in ("victim_uid", "victim_replica", "victim_tenant",
                  "priority"):
            assert a in sp.attrs, a
    for eng in pair:
        eng.kv.verify()
        eng.close()
    return dict(_observe(router, done, uids, reqs),
                victims=[(sp.attrs["victim_uid"], sp.attrs["replica"])
                         for sp in spans])


def case_drain_join(pkg):
    """``drain()`` stops placements and requeues queued work, in-flight
    work finishes where it runs, ``join()`` adds capacity that takes
    traffic, the drained replica ends empty with a clean pool."""
    e0, e1, e2 = pkg.engine(), pkg.engine(), pkg.engine()
    router = pkg.router([e0, e1], tracer=pkg.Tracer("router"))
    rng = np.random.RandomState(13)
    reqs = [(rng.randint(0, 97, 8), 10, 0.0, 0) for _ in range(6)]
    uids = [router.submit(p, n) for p, n, _, _ in reqs]
    for _ in range(2):
        router.step()
    requeued = router.drain("r0")
    assert router.replicas["r0"].status in ("draining", "drained")
    router.join(pkg.Replica(e2, "r2"))
    done = router.run(max_steps=100_000)
    assert all(done[u].finish_reason == "length" for u in uids)
    assert router.replicas["r0"].status == "drained"
    assert not e0.has_work
    e0.kv.verify()
    obs = _observe(router, done, uids, reqs)
    assert any(r == "r2" for r, _ in obs["placements"])
    kinds = [tr.name for tr in router._tracer.completed_traces()]
    assert "drain" in kinds and "join" in kinds
    for eng in (e0, e1, e2):
        eng.close()
    return dict(obs, drain_requeued=requeued)


def case_death(pkg):
    """A replica killed mid-trace (``replica_down``): every request it
    held requeues and finishes elsewhere with the unfailed engine's
    tokens; the fleet view shows fewer sources answering; the router's
    metrics count the death and the requeues."""
    e0 = pkg.engine(fault_injector=pkg.FaultInjector())
    e1 = pkg.engine()
    router = pkg.router([e0, e1], names=["k0", "k1"],
                        tracer=pkg.Tracer("router"))
    uids = [router.submit(p, n, temperature=t, seed=s)
            for p, n, t, s in REQS]
    for _ in range(4):
        router.step()
    e0.faults.inject("replica_down")
    done = router.run(max_steps=100_000)
    assert len(done) == len(REQS)
    _identity(pkg, done, uids, REQS)
    assert router.stats["replica_deaths"] == 1
    assert router.stats["requeued"] >= 1
    assert router.replicas["k0"].status == "dead"
    fleet = router.poll_health()
    assert fleet["sources_ok"] < fleet["sources_total"]
    snap = router.metrics.snapshot()
    assert snap["router_replica_deaths_total"]["series"][0]["value"] == 1
    assert sum(s["value"] for s in
               snap["router_requeued_total"]["series"]) >= 1
    assert "replica_dead" in [tr.name for tr in
                              router._tracer.completed_traces()]
    e1.kv.verify()
    e1.close()
    return dict(_observe(router, done, uids, REQS),
                sources=(fleet["sources_ok"], fleet["sources_total"]),
                anatomy=router.anatomy_report()["conservation"])


def case_overload_kill(pkg):
    """The oversubscribed two-tier stream with one replica killed at the
    first step: every request survives and the high tier's tokens equal
    its uncontended run's. The high tier's p99 TTFT against the
    uncontended run is recorded only (wall-clock on a shared CPU)."""
    rng = np.random.RandomState(21)
    n_low, n_high = 10, 4
    lows = [(rng.randint(0, 97, 8), 12) for _ in range(n_low)]
    highs = [(rng.randint(0, 97, 8), 6) for _ in range(n_high)]
    stream = []
    for i in range(max(n_low, n_high)):
        if i < n_low:
            stream.append((lows[i][0], lows[i][1], 0))
        if i < n_high:
            stream.append((highs[i][0], highs[i][1], 2))
    e0 = pkg.engine(num_pages=9, fault_injector=pkg.FaultInjector())
    e1 = pkg.engine(num_pages=9)
    for e in (e0, e1):
        dup = rng.randint(0, 97, 8)
        e.add_request(dup, 2)
        e.add_request(dup, 2)
        e.run(max_steps=100_000)
    router = pkg.router([e0, e1], names=["o0", "o1"])
    hu, ref_done = [], {}
    for p, n, tier in stream:
        if tier:
            hu.append(router.submit(p, n, priority=2, tenant="gold"))
        for c in router.step():
            ref_done[c.uid] = c
    ref_done.update(router.run(max_steps=100_000))
    ref_toks = [ref_done[u].tokens for u in hu]
    p99_u = float(np.percentile([ref_done[u].ttft_s for u in hu], 99))
    router = pkg.router([e0, e1], names=["o0", "o1"], saturation_depth=2)
    uids, hu2, done = [], [], {}
    for k, (p, n, tier) in enumerate(stream):
        u = router.submit(p, n, priority=tier,
                          tenant="gold" if tier else "bulk")
        uids.append(u)
        if tier:
            hu2.append(u)
        for c in router.step():
            done[c.uid] = c
        if k == 0:
            e0.faults.inject("replica_down")
    done.update(router.run(max_steps=100_000))
    assert router.stats["replica_deaths"] == 1
    assert router.stats["requeued"] >= 1
    assert len(done) == len(stream)
    assert all(c.finish_reason == "length" for c in done.values())
    assert all(done[u].ttft_s is not None for u in hu2)
    for i, u in enumerate(hu2):
        assert done[u].tokens == ref_toks[i], (pkg.name, i)
    p99_o = float(np.percentile([done[u].ttft_s for u in hu2], 99))
    print(f"{pkg.name}: high-tier p99 TTFT {p99_o * 1e3:.3f} ms against "
          f"{p99_u * 1e3:.3f} ms uncontended (recorded, not held)")
    e1.kv.verify()
    e1.close()
    reqs = [(p, n, 0.0, 0) for p, n, _ in stream]
    return _observe(router, done, uids, reqs)


CASES = {"migrate": case_migrate, "affinity": case_affinity,
         "shed": case_shed, "preempt": case_preempt,
         "drain_join": case_drain_join, "death": case_death,
         "overload_kill": case_overload_kill}


@pytest.mark.parametrize("case", list(CASES))
def test_port_fleet_matches_the_jax_fleet(pkgs, case):
    """The case on a JAX fleet and a port fleet: greedy tokens, finish
    reasons, the router's clock, stats and placements identical."""
    got = {name: CASES[case](pkg) for name, pkg in pkgs.items()}
    assert got["port"] == got["jax"]


def test_sampled_rerun_after_death_equals_an_unfailed_run(pkgs):
    """Port against port: the sampled requests of a fleet whose replica
    died mid-decode finish with the tokens of an unfailed port fleet."""
    pt = pkgs["port"]
    sampled = [r for r in REQS if r[2] > 0]

    def run(kill):
        e0 = pt.engine(fault_injector=FaultInjector())
        router = pt.router([e0, pt.engine()])
        uids = [router.submit(p, n, temperature=t, seed=s)
                for p, n, t, s in sampled]
        for _ in range(5):
            router.step()
        if kill:
            e0.faults.inject("replica_down")
        done = router.run(max_steps=100_000)
        return router, [done[u].tokens for u in uids]
    router, killed = run(True)
    assert router.stats["replica_deaths"] == 1
    assert [(d["replica"], d["error"]) for d in router.deaths] == [
        ("r0", "ReplicaDown")]
    assert router.stats["requeued"] >= 1
    assert killed == run(False)[1] == pt.solo(sampled)


def test_a_step_that_raises_anything_marks_its_replica_dead(pkgs,
                                                           tmp_path):
    """Any exception out of a replica's step — here a stand-in for a
    failing kernel launch, not ``ReplicaDown`` — marks the replica dead;
    its work reruns elsewhere with the same tokens; the journal's
    ``replica_dead`` event, the decision trace and ``router.deaths``
    carry the exception as their reason, so such a death never passes
    unseen."""
    pt = pkgs["port"]
    e0, e1 = pt.engine(), pt.engine()
    real = e0.step
    calls = [0]

    def failing_step():
        calls[0] += 1
        if calls[0] == 4:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real()
    e0.step = failing_step
    path = str(tmp_path / "fleet.jsonl")
    router = pt.router([e0, e1], tracer=Tracer("router"), journal=path)
    uids = [router.submit(p, n, temperature=t, seed=s)
            for p, n, t, s in REQS]
    done = router.run(max_steps=100_000)
    router.close()
    assert router.stats["replica_deaths"] == 1
    assert router.replicas["r0"].status == "dead"
    assert [done[u].tokens for u in uids] == pt.solo(REQS)
    dead = jnl.read_journal(path).by_kind("replica_dead")
    assert [e["replica"] for e in dead] == ["r0"]
    assert "illegal memory access" in dead[0]["reason"]
    traces = [tr for tr in router._tracer.completed_traces()
              if tr.name == "replica_dead"]
    assert "illegal memory access" in traces[0].root.attrs["reason"]
    assert [(d["replica"], d["error"], d["reason"]) for d in router.deaths] \
        == [("r0", "RuntimeError", dead[0]["reason"])]
    e1.close()


def test_engine_replica_surface(pkgs):
    """``EngineReplica`` over a port engine: ``step()`` calls the engine's
    own ``step()`` (it holds its weights), ``refresh_params()`` drops
    nothing, and ``snapshot()`` is the engine registry's snapshot."""
    pt = pkgs["port"]
    eng = pt.engine()
    rep = EngineReplica(eng, "x")
    eng.add_request(REQS[0][0], 3)
    assert rep.refresh_params() is None
    while rep.has_work:
        rep.step()
    assert rep.snapshot() == eng.metrics.snapshot()
    assert (rep.queue_depth, rep.num_slots, rep.page_size) == (0, 2, 8)
    assert rep.free_pages == eng.free_pages
    rep.close()
