"""Resilience drills of the serving engine and their checks, shared by
tests/test_torch_resilience.py (per-phase engines) and
tests/test_torch_resilience_mixed.py (``mixed_step=True``).

Each drill drives one engine through the traffic of the reference's
tests/test_resilience.py (2 layers, hidden 32, 4 heads, vocab 97; 2
slots, pages of 8, chunks of 8, ``max_seq_len`` 64, per-token decode)
and returns ``summary(...)``: every request's tokens, finish reason and
preemptions, the engine's resilience and dispatch counters, and what
else the drill observed. A drill gets ``make(**kw)``, which builds the
engine under test with the drill's levers, and ``pkg``, the namespace of
that engine's package (``FaultInjector``, ``QueueFullError``,
``ReplicaDown``), so the same drill runs on the port and on the oracle,
``paddle_tpu.inference.ServingEngine(attention="jax")`` (the Pallas
ragged kernel is no oracle under this JAX version: ROADMAP C1).

- ``DETERMINISTIC`` drills: the port's summary equals the JAX engine's
  (tokens, reasons, counters) and meets the drill's own expectation;
- ``TIMED`` drills depend on wall time (deadlines, stalls): finish
  reasons equal, expectations met;
- the int8-pool preemption also holds every dequantized pool element
  within one code step of the JAX engine's
  (tests/test_torch_quant_serving.py's rule);
- the sampled preemption, the overload stress, the synthetic program
  failure, the migration between engines, the shared prefix admitted in
  one step (ROADMAP C14) and the teardown past a failing abort (C15) run
  on the port alone."""
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.inference as jinf
from paddle_tpu.inference.faults import ReplicaDown as JaxReplicaDown
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry
import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
KW = dict(num_slots=2, page_size=8, prefill_chunk=8, max_seq_len=64,
          decode_block=1)
JAX_PKG = SimpleNamespace(FaultInjector=jinf.FaultInjector,
                          QueueFullError=jinf.QueueFullError,
                          ReplicaDown=JaxReplicaDown)
PORT_PKG = SimpleNamespace(FaultInjector=tinf.FaultInjector,
                           QueueFullError=tinf.QueueFullError,
                           ReplicaDown=tinf.ReplicaDown)


def reference():
    """The reference's tiny GPT (tests/test_resilience.py ``_tiny``) and
    its weights as the port's parameter dict."""
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _levers(mixed, kw):
    kw = dict(KW, **kw)
    if mixed:   # the mixed engine runs every queued chunk each dispatch
        kw.pop("prefill_chunks_per_step", None)
        kw["mixed_step"] = True
    return kw


def jax_make(ref, mixed):
    return lambda **kw: jinf.ServingEngine(
        ref[0], attention="jax", cost_analysis=False, tracing=False,
        registry=MetricsRegistry(), **_levers(mixed, kw))


def port_make(ref, mixed):
    return lambda **kw: tinf.ServingEngine(
        GPTConfig(**CFG), ref[1], device="cpu", **_levers(mixed, kw))


STATS = ("preemptions", "resumes", "collateral_requeues", "prefill_chunks",
         "cancelled", "deadline_expired", "faults", "sheds", "admitted",
         "dispatches", "tokens_emitted", "steps", "prefix_hits",
         "cow_copies", "admission_skips", "decode_blocks", "mixed_steps")
TERMINAL = {"eos", "length", "deadline", "cancelled", "shed", "error",
            "nonfinite"}


def summary(eng, done, **info):
    return {"done": {int(u): ([int(t) for t in c.tokens], c.finish_reason,
                              int(c.preemptions))
                     for u, c in sorted(done.items())},
            "stats": {k: eng.stats[k] for k in STATS}, **info}


def reasons(s):
    return {u: d[1] for u, d in s["done"].items()}


def prompts(rng, n, lo=4, hi=20):
    return [list(rng.integers(1, 97, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


def step(eng, done):
    for c in eng.step():
        done[c.uid] = c


def until_decoding(eng, uid, done, min_out=2, max_steps=64):
    """Step until ``uid`` holds a slot and has emitted ``min_out``
    tokens, keeping what finishes meanwhile in ``done``."""
    for _ in range(max_steps):
        step(eng, done)
        st = next((s for s in eng._slots.values() if s.uid == uid), None)
        if st is not None and len(st.out) >= min_out:
            return
    raise AssertionError(f"uid {uid} never reached steady decode")


def drain(eng, done, verify=False):
    while eng.has_work:
        step(eng, done)
        if verify:
            eng.kv.verify()
    eng.kv.verify()
    return done


# -- deterministic drills: tokens and counters equal the JAX engine's --------

def preempt_resume(make, pkg, **kw):
    """A low-priority request preempted mid-decode by a high-priority
    arrival on a pool too small for both (2 slots, 8 pages): it resumes
    from the prefix cache and finishes. It has emitted 12 tokens when the
    arrival comes, so a page it filled partly with generated tokens is
    registered under the resumed digests and mapped back."""
    rng = np.random.default_rng(0)
    low, hi = list(rng.integers(1, 97, size=12)), \
        list(rng.integers(1, 97, size=20))
    eng = make(num_pages=9, **kw)
    done = {}
    u_low = eng.add_request(low, 24, priority=0)
    until_decoding(eng, u_low, done, min_out=12)
    chunks_before = eng.stats["prefill_chunks"]
    u_hi = eng.add_request(hi, 20, priority=5)
    drain(eng, done)
    return eng, summary(eng, done, chunks_before=chunks_before,
                        low=u_low, hi=u_hi, low_len=len(low),
                        hi_len=len(hi))


def preempt_sampled(make, pkg, preempt=True):
    """A sampled request (temperature 0.7, seed 7), preempted or run
    alone: its tokens. The port's two runs must agree; the JAX engine's
    draws are its own."""
    rng = np.random.default_rng(1)
    prompt = list(rng.integers(1, 97, size=12))
    done = {}
    if not preempt:
        eng = make(num_slots=1)
        u = eng.add_request(prompt, 20, temperature=0.7, seed=7)
        drain(eng, done)
        return eng, summary(eng, done, target=u)
    eng = make(num_pages=9)
    u = eng.add_request(prompt, 20, temperature=0.7, seed=7, priority=0)
    until_decoding(eng, u, done, min_out=6)
    eng.add_request(list(rng.integers(1, 97, size=20)), 16, priority=5)
    drain(eng, done)
    return eng, summary(eng, done, target=u)


def preemption_disabled(make, pkg):
    rng = np.random.default_rng(2)
    eng = make(num_pages=9, preemption=False)
    done = {}
    u0 = eng.add_request(list(rng.integers(1, 97, size=12)), 24)
    until_decoding(eng, u0, done)
    eng.add_request(list(rng.integers(1, 97, size=20)), 8, priority=5)
    drain(eng, done)
    return eng, summary(eng, done)


def deadline_queued(make, pkg):
    eng = make(num_slots=1)
    rng = np.random.default_rng(3)
    eng.add_request(list(rng.integers(1, 97, size=8)), 20)
    eng.add_request(list(rng.integers(1, 97, size=8)), 4, deadline_s=0.0)
    time.sleep(0.01)
    return eng, summary(eng, drain(eng, {}))


def cancel_states(make, pkg):
    """cancel(uid) of a decoding, a prefilling and a queued request,
    then of a finished and of an unknown uid."""
    eng = make(num_slots=1, prefill_chunks_per_step=1)
    rng = np.random.default_rng(6)
    done = {}
    u_dec = eng.add_request(list(rng.integers(1, 97, size=8)), 30)
    until_decoding(eng, u_dec, done)
    u_pf = eng.add_request(list(rng.integers(1, 97, size=30)), 8)
    u_q = eng.add_request(list(rng.integers(1, 97, size=8)), 8)
    said = [eng.cancel(u_dec), eng.cancel(u_q)]
    for _ in range(3):      # u_pf gets the slot and starts its prefill
        step(eng, done)
    prefilling = any(st.uid == u_pf and st.pf_base < st.pf_end
                     for st in eng._slots.values())
    said.append(eng.cancel(u_pf))
    drain(eng, done)
    said += [eng.cancel(u_q), eng.cancel(12345)]
    return eng, summary(eng, done, said=said, prefilling=prefilling)


def shed(make, pkg, policy):
    """Three arrivals at ``max_queue=2`` under ``policy``, then a
    fourth; every QueueFullError recorded."""
    eng = make(num_slots=1, max_queue=2, shed_policy=policy)
    rng = np.random.default_rng(10)
    refused = []
    for pr in (0, 1, 3, 1):
        try:
            eng.add_request(list(rng.integers(1, 97, size=8)), 4,
                            priority=pr)
        except pkg.QueueFullError as e:
            refused.append((pr, e.policy, e.depth))
    return eng, summary(eng, drain(eng, {}), refused=refused)


def fault_one(make, pkg, kind):
    """One per-request fault armed at request a: a fails, b finishes,
    and a later request c is served."""
    rng = np.random.default_rng(11)
    pa, pb, pc = prompts(rng, 3, 8, 9)
    inj = pkg.FaultInjector()
    eng = make(fault_injector=inj)
    a = eng.add_request(pa, 6)
    eng.add_request(pb, 6)
    inj.inject(kind, uid=a)
    done = drain(eng, {})
    eng.add_request(pc, 6)
    drain(eng, done)
    return eng, summary(eng, done,
                        fired=[(f.kind, f.uid) for f in inj.fired()])


def page_exhaustion(make, pkg):
    inj = pkg.FaultInjector().inject("page_exhaustion", count=2)
    eng = make(fault_injector=inj)
    rng = np.random.default_rng(12)
    eng.add_request(list(rng.integers(1, 97, size=8)), 6)
    return eng, summary(eng, drain(eng, {}),
                        fired=[(f.kind, f.uid) for f in inj.fired()])


def stall_and_untargeted_nonfinite(make, pkg):
    """A 0-second stall still counts as a fired fault, and an untargeted
    nonfinite arm hits a decoding request, not a prefilling one."""
    rng = np.random.default_rng(22)
    inj = pkg.FaultInjector().inject("stall")
    eng = make(fault_injector=inj)
    done = {}
    eng.add_request(list(rng.integers(1, 97, size=8)), 4)
    drain(eng, done)
    u_dec = eng.add_request(list(rng.integers(1, 97, size=8)), 30)
    until_decoding(eng, u_dec, done)
    u_pf = eng.add_request(list(rng.integers(1, 97, size=40)), 4)
    step(eng, done)
    prefilling = any(st.uid == u_pf for st in eng._slots.values())
    inj.inject("nonfinite_logits")
    drain(eng, done)
    return eng, summary(eng, done, prefilling=prefilling)


def resilience_mix(make, pkg):
    """Preemption, an untargeted decode_error, a deadline_s=0 request and
    a cancel in one stream (the reference's compile-count drill)."""
    inj = pkg.FaultInjector()
    eng = make(num_pages=9, max_queue=8, shed_policy="shed_oldest",
               fault_injector=inj)
    rng = np.random.default_rng(16)
    done = {}
    u0 = eng.add_request(list(rng.integers(1, 97, size=12)), 20)
    until_decoding(eng, u0, done)
    inj.inject("decode_error")
    eng.add_request(list(rng.integers(1, 97, size=20)), 20, priority=5)
    eng.add_request(list(rng.integers(1, 97, size=8)), 4, deadline_s=0.0)
    u3 = eng.add_request(list(rng.integers(1, 97, size=8)), 4)
    eng.cancel(u3)
    return eng, summary(eng, drain(eng, done))


def close_inflight(make, pkg):
    """close() with a decoding, a prefilling and a queued request."""
    eng = make(num_slots=1)
    rng = np.random.default_rng(14)
    done = {}
    u_dec = eng.add_request(list(rng.integers(1, 97, size=8)), 30)
    until_decoding(eng, u_dec, done)
    eng.add_request(list(rng.integers(1, 97, size=30)), 8)
    eng.add_request(list(rng.integers(1, 97, size=8)), 8)
    aborted = eng.close()
    eng.kv.verify()
    return eng, summary(eng, aborted, in_use=eng.kv.num_in_use,
                        has_work=eng.has_work, again=eng.close())


def close_shared_pair(make, pkg):
    """close() while two prefills share pages the first registered at
    admission: the second, requeued as collateral, is drained too."""
    rng = np.random.default_rng(21)
    eng = make(num_slots=2, prefill_chunks_per_step=1)
    prefix = list(rng.integers(1, 97, size=16))
    eng.add_request(prefix + [1, 2, 3, 4], 4)
    eng.add_request(prefix + [5, 6, 7, 8], 4)
    done = {}
    step(eng, done)
    prefilling = len(eng._prefilling)
    aborted = eng.close()
    eng.kv.verify()
    return eng, summary(eng, {**done, **aborted}, prefilling=prefilling,
                        in_use=eng.kv.num_in_use, has_work=eng.has_work,
                        again=eng.close())


def replica_down(make, pkg):
    """replica_down escapes step() after the teardown: the pool is clean
    and the engine serves again afterwards."""
    inj = pkg.FaultInjector()
    eng = make(fault_injector=inj)
    rng = np.random.default_rng(23)
    done = {}
    u = eng.add_request(list(rng.integers(1, 97, size=12)), 20)
    until_decoding(eng, u, done)
    eng.add_request(list(rng.integers(1, 97, size=8)), 6)
    inj.inject("replica_down")
    try:
        eng.step()
        raised = False
    except pkg.ReplicaDown:
        raised = True
    eng.kv.verify()
    in_use = eng.kv.num_in_use
    eng.add_request(list(rng.integers(1, 97, size=8)), 6)
    drain(eng, done)
    return eng, summary(eng, done, raised=raised, in_use=in_use)


DETERMINISTIC = {
    "preempt_resume": preempt_resume,
    "preemption_disabled": preemption_disabled,
    "deadline_queued": deadline_queued,
    "cancel_states": cancel_states,
    "shed_reject": lambda m, p: shed(m, p, "reject"),
    "shed_oldest": lambda m, p: shed(m, p, "shed_oldest"),
    "shed_lowest_priority": lambda m, p: shed(m, p, "shed_lowest_priority"),
    "prefill_error": lambda m, p: fault_one(m, p, "prefill_error"),
    "decode_error": lambda m, p: fault_one(m, p, "decode_error"),
    "nonfinite_logits": lambda m, p: fault_one(m, p, "nonfinite_logits"),
    "page_exhaustion": page_exhaustion,
    "stall_and_untargeted_nonfinite": stall_and_untargeted_nonfinite,
    "resilience_mix": resilience_mix,
    "close_inflight": close_inflight,
    "close_shared_pair": close_shared_pair,
    "replica_down": replica_down,
}


# -- drills that depend on wall time: finish reasons only --------------------

def deadline_mid_prefill(make, pkg):
    """A stalled chunk pushes the request past its deadline: the next
    between-chunks check fails it."""
    inj = pkg.FaultInjector().inject("stall", seconds=0.15)
    eng = make(num_slots=1, fault_injector=inj, prefill_chunks_per_step=1)
    rng = np.random.default_rng(4)
    eng.add_request(list(rng.integers(1, 97, size=30)), 8, deadline_s=0.1)
    done = drain(eng, {})
    return eng, summary(eng, done, stalled=bool(inj.fired("stall")),
                        tokens=[len(c.tokens) for c in done.values()])


def deadline_mid_decode(make, pkg):
    """A deadline met at a decode-block boundary after a stall, with the
    adaptive block policy: tokens kept."""
    inj = pkg.FaultInjector().inject("stall", seconds=0.2)
    eng = make(num_slots=1, decode_block="adaptive",
               decode_block_buckets=(1, 4, 8), fault_injector=inj)
    rng = np.random.default_rng(5)
    eng.add_request(list(rng.integers(1, 97, size=8)), 40, deadline_s=0.15)
    done = drain(eng, {})
    return eng, summary(eng, done,
                        mid_stream=all(0 < len(c.tokens) < 40
                                       for c in done.values()))


def deadline_shared_pair(make, pkg):
    """Both of a page-sharing prefill pair expire at one boundary:
    aborting the first requeues the second as collateral mid-sweep."""
    rng = np.random.default_rng(20)
    eng = make(num_slots=2, prefill_chunks_per_step=1)
    done = {}
    eng.add_request(list(rng.integers(1, 97, size=8)), 2)
    drain(eng, done)   # the programs warm, off the deadline clock
    prefix = list(rng.integers(1, 97, size=16))
    eng.add_request(prefix + [1, 2, 3, 4], 4, deadline_s=0.2)
    eng.add_request(prefix + [5, 6, 7, 8], 4, deadline_s=0.2)
    step(eng, done)
    time.sleep(0.25)
    drain(eng, done)
    return eng, summary(eng, done, in_use=eng.kv.num_in_use)


TIMED = {
    "deadline_mid_prefill": deadline_mid_prefill,
    "deadline_mid_decode": deadline_mid_decode,
    "deadline_shared_pair": deadline_shared_pair,
}


def stress(make, pkg, seed=19, n=40):
    """The reference's randomized overload stream: mixed priorities,
    deadlines, sampled requests, cancels and faults on a tight pool,
    ``kv.verify()`` after every step. Returns (engine, done, uids)."""
    rng = np.random.default_rng(seed)
    inj = pkg.FaultInjector()
    eng = make(num_slots=2, num_pages=13, max_queue=4,
               shed_policy="shed_lowest_priority", fault_injector=inj)
    done, uids = {}, []
    for _ in range(n):
        if rng.random() < 0.6:
            try:
                uids.append(eng.add_request(
                    list(rng.integers(1, 97,
                                      size=int(rng.integers(4, 24)))),
                    int(rng.integers(2, 12)),
                    priority=int(rng.integers(0, 3)),
                    deadline_s=(None if rng.random() < 0.7
                                else float(rng.uniform(0.05, 1.0))),
                    temperature=float(rng.choice([0.0, 0.8])),
                    seed=int(rng.integers(0, 1000))))
            except pkg.QueueFullError:
                pass
        if rng.random() < 0.1 and uids:
            eng.cancel(int(rng.choice(uids)))
        if rng.random() < 0.08:
            inj.inject(str(rng.choice(["prefill_error", "decode_error",
                                       "nonfinite_logits",
                                       "page_exhaustion"])))
        step(eng, done)
        eng.kv.verify()
    drain(eng, done, verify=True)
    return eng, done, uids


# -- what each drill must show, beyond agreeing with the JAX engine ----------

def _expect_preempt_resume(s):
    st, done = s["stats"], s["done"]
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert done[s["low"]][2] >= 1 and done[s["hi"]][1] == "length"
    # the resume re-prefills only the uncached tail: the pages the
    # victim wrote came back from the prefix cache
    C = KW["prefill_chunk"]
    resume = st["prefill_chunks"] - s["chunks_before"] \
        - -(-s["hi_len"] // C)
    full = -(-(s["low_len"] + len(done[s["low"]][0])) // C)
    assert 1 <= resume < full, (resume, full)


EXPECT = {
    "preempt_resume": _expect_preempt_resume,
    "preemption_disabled": lambda s: (
        s["stats"]["preemptions"] == 0
        and reasons(s) == {0: "length", 1: "length"}),
    "deadline_queued": lambda s: (
        reasons(s) == {0: "length", 1: "deadline"}
        and s["done"][1][0] == [] and s["stats"]["deadline_expired"] == 1),
    "cancel_states": lambda s: (
        s["said"] == [True, True, True, False, False] and s["prefilling"]
        and reasons(s) == dict.fromkeys((0, 1, 2), "cancelled")
        and len(s["done"][0][0]) >= 2 and s["stats"]["cancelled"] == 3),
    "shed_reject": lambda s: (
        s["refused"] == [(3, "reject", 2), (1, "reject", 2)]
        and reasons(s) == {0: "length", 1: "length"}),
    "shed_oldest": lambda s: (
        s["refused"] == [] and s["stats"]["sheds"] == 2
        and reasons(s) == {0: "shed", 1: "shed", 2: "length",
                           3: "length"}),
    "shed_lowest_priority": lambda s: (
        s["refused"] == [(1, "shed_lowest_priority", 2)]
        and s["stats"]["sheds"] == 2
        and reasons(s) == {0: "shed", 1: "length", 2: "length"}),
    "prefill_error": lambda s: (
        reasons(s) == {0: "error", 1: "length", 2: "length"}
        and s["fired"] == [("prefill_error", 0)]
        and s["stats"]["faults"] == 1),
    "decode_error": lambda s: (
        reasons(s) == {0: "error", 1: "length", 2: "length"}
        and s["fired"] == [("decode_error", 0)]
        and s["stats"]["faults"] == 1),
    "nonfinite_logits": lambda s: (
        reasons(s) == {0: "nonfinite", 1: "length", 2: "length"}
        and s["fired"] == [("nonfinite_logits", 0)]
        and s["stats"]["faults"] == 1),
    "page_exhaustion": lambda s: (
        reasons(s) == {0: "length"} and s["stats"]["faults"] == 2
        and s["fired"] == [("page_exhaustion", 0)] * 2),
    "stall_and_untargeted_nonfinite": lambda s: (
        s["prefilling"] and s["stats"]["faults"] == 2
        and reasons(s) == {0: "length", 1: "nonfinite", 2: "length"}),
    "resilience_mix": lambda s: (
        s["stats"]["preemptions"] >= 1 and s["stats"]["faults"] >= 1
        and reasons(s)[2] == "deadline" and reasons(s)[3] == "cancelled"
        and set(reasons(s).values()) <= TERMINAL),
    "close_inflight": lambda s: (
        reasons(s) == dict.fromkeys((0, 1, 2), "aborted")
        and len(s["done"][0][0]) >= 2 and s["in_use"] == 0
        and not s["has_work"] and s["again"] == {}),
    "close_shared_pair": lambda s: (
        reasons(s) == {0: "aborted", 1: "aborted"} and s["in_use"] == 0
        and not s["has_work"] and s["again"] == {}),
    "replica_down": lambda s: (
        s["raised"] and s["in_use"] == 0 and s["stats"]["faults"] == 1
        and reasons(s) == {0: "error", 1: "error", 2: "length"}),
    "deadline_mid_prefill": lambda s: (
        s["stalled"] and reasons(s) == {0: "deadline"}),
    "deadline_mid_decode": lambda s: (
        s["mid_stream"] and reasons(s) == {0: "deadline"}),
    "deadline_shared_pair": lambda s: (
        s["in_use"] == 0
        and reasons(s) == {0: "length", 1: "deadline", 2: "deadline"}),
}


def _held(name, s):
    assert EXPECT[name](s) is not False, (name, s)


# -- the checks the two test files run ---------------------------------------

# ROADMAP C14, kept on purpose: the reference's mixed engine runs the
# second request's chunk beside the first one's chunk 0, though it reads a
# prefix page that chunk has not written, and activates it with a token;
# the port's holds that row back until the page is written
C14_MIXED = {"close_shared_pair": lambda s: {
    **s, "prefilling": 2,
    "done": {**s["done"], 1: ([], "aborted", s["done"][1][2])},
    "stats": {**s["stats"], "prefill_chunks": 1, "tokens_emitted": 0}}}


def check_deterministic(ref, name, mixed):
    drill = DETERMINISTIC[name]
    jeng, want = drill(jax_make(ref, mixed), JAX_PKG)
    eng, got = drill(port_make(ref, mixed), PORT_PKG)
    if mixed and name in C14_MIXED:
        want = C14_MIXED[name](want)
    assert got == want
    _held(name, got)
    assert eng.kv.num_in_use == jeng.kv.num_in_use


def check_timed(ref, name, mixed):
    drill = TIMED[name]
    _, want = drill(jax_make(ref, mixed), JAX_PKG)
    _, got = drill(port_make(ref, mixed), PORT_PKG)
    assert reasons(got) == reasons(want)
    _held(name, got)
    _held(name, want)


def _code_step(mag, fmt):
    """The code grid's spacing at code magnitude ``mag`` (int8: 1; e4m3:
    2^(e - 3) in the binade [2^e, 2^(e+1)), 2^-9 below 2^-6)."""
    if fmt == "int8":
        return np.ones_like(mag)
    e = np.floor(np.log2(np.maximum(mag, 2.0 ** -6)))
    return 2.0 ** (e - 3)


def assert_pools_within_one_code_step(eng, jeng, fmt):
    """Every dequantized element of every page but the trash page within
    one code step of the JAX engine's (plus the codes' share of the two
    scales' difference), and at least 99.9% of the codes identical."""
    same = total = 0
    for pools, jpools, scales, jscales in (
            (eng.kv.k, jeng.kv.k, eng.kv.k_scale, jeng.kv.k_scale),
            (eng.kv.v, jeng.kv.v, eng.kv.v_scale, jeng.kv.v_scale)):
        for li in range(len(pools)):
            c = pools[li].float().numpy()[1:]
            jc = np.asarray(jpools[li].astype(jnp.float32))[1:]
            sc = scales[li].numpy()[1:][:, None, :, None]
            js = np.asarray(jscales[li])[1:][:, None, :, None]
            mag = np.maximum(np.abs(c), np.abs(jc))
            bound = _code_step(mag, fmt) * np.maximum(sc, js) \
                + mag * np.abs(sc - js)
            assert np.all(np.abs(c * sc - jc * js) <= bound * (1 + 1e-6))
            same += int((c == jc).sum())
            total += c.size
    assert same >= 0.999 * total, (same, total)


def check_preempt_resume_quant(ref, mixed, kv_dtype):
    jeng, want = preempt_resume(jax_make(ref, mixed), JAX_PKG,
                                kv_dtype=kv_dtype)
    eng, got = preempt_resume(port_make(ref, mixed), PORT_PKG,
                              kv_dtype=kv_dtype)
    assert got == want
    _held("preempt_resume", got)
    assert_pools_within_one_code_step(eng, jeng, kv_dtype)


def check_sampled_resume(ref, mixed):
    """A sampled stream preempted mid-decode equals the same request
    served alone: the resume restores the generator's state."""
    make = port_make(ref, mixed)
    _, alone = preempt_sampled(make, PORT_PKG, preempt=False)
    _, hit = preempt_sampled(make, PORT_PKG)
    u = hit["target"]
    assert hit["stats"]["preemptions"] >= 1
    assert hit["done"][u][2] >= 1 and alone["done"][u][2] == 0
    assert hit["done"][u][0] == alone["done"][u][0]
    assert len(set(alone["done"][u][0])) > 1     # it really sampled


def check_stress(ref, mixed):
    eng, done, uids = stress(port_make(ref, mixed), PORT_PKG)
    assert eng.kv.num_in_use == 0
    assert set(uids) == set(done)
    assert {c.finish_reason for c in done.values()} <= TERMINAL
    assert eng.stats["preemptions"] + eng.stats["sheds"] > 0


def check_synthetic_failure(ref, mixed):
    """A real (not injected) failure inside a serving program tears the
    engine down and propagates: the pool verifies, nothing is held, and
    the torn-down requests finish "error"."""
    eng = port_make(ref, mixed)(num_slots=1)
    rng = np.random.default_rng(15)
    done = {}
    u = eng.add_request(list(rng.integers(1, 97, size=8)), 20)
    eng.add_request(list(rng.integers(1, 97, size=8)), 4)
    until_decoding(eng, u, done)

    def boom(*a, **k):
        raise RuntimeError("synthetic dispatch failure")

    setattr(eng._fns, "mixed" if mixed else "decode_step", boom)
    with pytest.raises(RuntimeError, match="synthetic"):
        eng.step()
    eng.kv.verify()
    assert eng.kv.num_in_use == 0 and not eng._slots and not eng._pending
    failed = eng.close()
    assert {c.finish_reason for c in failed.values()} == {"error"}
    assert len(failed[u].tokens) >= 2 and not eng.has_work


def check_migration(ref, mixed, temperature):
    """``eject`` of a decoding request and ``admit_migrated`` into a
    second engine: the migrated stream equals an unmigrated run, and the
    request keeps its priority, tenant and arrival time."""
    make = port_make(ref, mixed)
    rng = np.random.default_rng(30)
    prompt = list(rng.integers(1, 97, size=12))
    other = list(rng.integers(1, 97, size=9))
    kw = dict(temperature=temperature, seed=5)
    base = make()
    u = base.add_request(prompt, 20, **kw)
    base.add_request(other, 10)
    want = base.run()[u].tokens

    src, dst = make(), make()
    done = {}
    u = src.add_request(prompt, 20, priority=2, tenant="a", **kw)
    v = src.add_request(other, 10)
    q = src.add_request(other, 3)          # stays queued: 2 slots
    until_decoding(src, u, done)
    live = {r["uid"]: r for r in src.inflight()}
    assert live[u]["queued"] is False and live[q]["queued"] is True
    assert live[u]["tenant"] == "a" and live[u]["tokens_out"] >= 2
    queued = src.eject(q)
    assert queued.uid == q and queued.resume_out is None
    req = src.eject(u)
    assert len(req.resume_out) == live[u]["tokens_out"]
    assert (req.resume_key is None) == (temperature == 0)
    assert {r["uid"] for r in src.inflight()} == {v}
    with pytest.raises(KeyError):
        src.eject(u)
    w = dst.admit_migrated(req)
    assert dst._pending.find_uid(w).t_arrival == req.t_arrival
    got = dst.run()[w]
    assert got.tokens == want
    assert (got.priority, got.tenant, got.preemptions) == (2, "a", 1)
    assert got.ttft_s == req.ttft_s is not None
    assert dst.stats["resumes"] == 1
    drain(src, done)
    for eng in (src, dst):
        eng.kv.verify()
        assert eng.kv.num_in_use == 0


def check_shared_prefix_admitted_together(ref, seed):
    """ROADMAP C14: two requests sharing a 16-token prefix (two pages of
    8), admitted in one step, 12 new tokens each. The second maps the
    first's prefix pages at admission; its tail chunk must wait until the
    first's chunks have written them. The mixed engine's tokens equal the
    per-phase engine's (the JAX mixed engine parts from it at seeds 3, 4
    and 5, where its second request reads the unwritten page)."""
    prefix = np.random.default_rng(21).integers(1, 97, 16)
    rng = np.random.default_rng(seed)
    prompts = [list(np.concatenate([prefix, rng.integers(1, 97, 4)]))
               for _ in range(2)]
    outs = []
    for mixed in (False, True):
        eng = port_make(ref, mixed)()
        uids = [eng.add_request(p, 12) for p in prompts]
        done = drain(eng, {}, verify=True)
        assert eng.stats["prefix_hits"] == 2
        outs.append([done[u].tokens for u in uids])
    assert outs[0] == outs[1]


def check_teardown_past_a_failing_abort(ref, mixed, spec):
    """ROADMAP C15: ``replica_down`` escapes ``step()`` while two requests
    decode and one waits in the queue, and the teardown's first
    ``_abort_slot`` raises: the sweep goes on, every slot and page is
    released (the failed slot on the next sweep), the pool verifies, the
    speculative draft's generators are cleared, and the exception that
    escapes is the replica's, not the abort's."""
    inj = tinf.FaultInjector()
    kw = dict(speculative=1, draft_k=3) if spec else {}
    eng = port_make(ref, mixed)(fault_injector=inj, **kw)
    rng = np.random.default_rng(29)
    done = {}
    uids = [eng.add_request(list(rng.integers(1, 97, size=10)), 24,
                            temperature=0.8, seed=3 + i) for i in range(2)]
    eng.add_request(list(rng.integers(1, 97, size=8)), 6)
    for u in uids:
        until_decoding(eng, u, done)
    if spec:
        assert all(g is not None for g in eng.spec.gens)
    real, failed = eng._abort_slot, []

    def abort_once(slot, reason, requeue=False):
        if not failed:
            failed.append(slot)
            raise RuntimeError("abort failed")
        return real(slot, reason, requeue)

    eng._abort_slot = abort_once
    inj.inject("replica_down")
    with pytest.raises(tinf.ReplicaDown):
        eng.step()
    assert failed
    eng.kv.verify()
    assert not eng._slots and not eng._pending and eng.kv.num_in_use == 0
    assert sorted(eng._free_slots) == list(range(eng.num_slots))
    if spec:
        assert all(g is None for g in eng.spec.gens)
    aborted = eng.close()
    assert {c.finish_reason for c in aborted.values()} == {"error"}
    assert len(aborted) == 3 and not eng.has_work
