"""Serving resilience of the PyTorch port (priorities with page-pool
preemption and resume, deadlines, cancellation, shedding, fault
injection, teardown, eject/admit_migrated:
paddle_tpu_torch/inference/{serving,faults}.py) on the per-phase engine,
against the JAX reference engine ``ServingEngine(attention="jax")`` on
the traffic of the reference's tests/test_resilience.py. The drills and
their checks are in tests/serving_drills.py; the mixed-step engine runs
the same drills in tests/test_torch_resilience_mixed.py.

- every deterministic drill (preempt-and-resume, ``preemption=False``,
  ``deadline_s=0``, cancel in each state, the three shed policies, each
  per-request fault kind, ``page_exhaustion``, ``replica_down``,
  ``close()``) gives the JAX engine's tokens, finish reasons and
  counters (``preemptions``, ``resumes``, ``collateral_requeues``,
  ``prefill_chunks``, ...), the pool verifying after each;
- greedy preempt-and-resume over int8 and fp8 pools, every pool element
  within one code step of the JAX engine's;
- a sampled preempted stream equals the port's own unpreempted run;
- the drills that depend on wall time (deadlines mid-prefill and
  mid-decode through a stall, the shared-prefill pair) give the JAX
  engine's finish reasons; the K clamp against the JAX engine's on the
  same state;
- the port's FaultInjector and RequestQueue against the reference's on
  the same sequences; the overload stress with ``verify()`` after every
  step; a failure inside a program tears down and re-raises;
  ``eject``/``admit_migrated`` between two port engines gives the
  unmigrated stream; the teardown finishes its sweep when an abort
  raises and re-raises the step's own exception (ROADMAP C15), with and
  without speculation."""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.scheduler import RequestQueue as JaxQueue
import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch.inference.scheduler import RequestQueue

import serving_drills as drills

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref():
    return drills.reference()


@pytest.mark.parametrize("name", list(drills.DETERMINISTIC))
def test_drill_matches_the_jax_engine(ref, name):
    drills.check_deterministic(ref, name, mixed=False)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_preempt_resume_over_quantized_pools(ref, kv_dtype):
    drills.check_preempt_resume_quant(ref, False, kv_dtype)


def test_sampled_preempted_stream_equals_the_unpreempted_run(ref):
    drills.check_sampled_resume(ref, False)


@pytest.mark.parametrize("name", list(drills.TIMED))
def test_timed_drill_finish_reasons(ref, name):
    drills.check_timed(ref, name, mixed=False)


def test_overload_stress_verifies_after_every_step(ref):
    drills.check_stress(ref, False)


def test_a_failing_program_tears_down_and_reraises(ref):
    drills.check_synthetic_failure(ref, False)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_eject_and_admit_migrated(ref, temperature):
    drills.check_migration(ref, False, temperature)


# -- host pieces against the reference's --------------------------------------

def test_fault_injector_matches_the_reference():
    """The same arm/fire sequence on both injectors: the same hits, logs,
    armed kinds and errors."""
    def run(pkg):
        inj = pkg.FaultInjector()
        out = []
        for bad in (dict(kind="meteor_strike"),
                    dict(kind="stall", count=0)):
            with pytest.raises(ValueError):
                inj.inject(**bad)
        inj.inject("stall").inject("prefill_error", uid=3) \
            .inject("decode_error", count=2) \
            .inject("nonfinite_logits", uid=7)
        out.append(inj.armed)
        out.append(inj.stall())                          # 0-second arm
        out.append(inj.stall())                          # disarmed
        out.append(inj.fire("prefill_error", uid=2))     # not its target
        out.append(inj.fire("prefill_error", uid=3))
        out.append(inj.fire("nonfinite_logits", uids=[1, 5]))
        out.append(inj.fire("nonfinite_logits", uids=[5, 7]))
        for uids in ([4, 9], None):
            try:
                inj.maybe_raise("decode_error", uids=uids)
            except RuntimeError as e:
                out.append((type(e).__name__, e.kind, e.uid))
        out.append(inj.fire("decode_error", uids=[1]))
        out.append(inj.armed)
        out.append([(f.kind, f.uid) for f in inj.fired()])
        out.append([(f.kind, f.uid) for f in inj.fired("stall")])
        return out

    assert run(drills.PORT_PKG) == run(drills.JAX_PKG)
    assert issubclass(tinf.InjectedFault, RuntimeError)
    assert not issubclass(tinf.ReplicaDown, tinf.InjectedFault)


class _Q:
    def __init__(self, uid, priority, seq):
        self.uid, self.priority, self.seq = uid, priority, seq


def test_request_queue_matches_the_reference():
    """Priority order, requeue position (a preempted request keeps its
    seq and re-enters ahead of later arrivals of its class), find/remove
    by uid and the shed victims, step by step against the reference's
    queue."""
    def run(q):
        out = []
        for uid, pr, seq in ((0, 0, 0), (1, 2, 1), (2, 0, 2), (3, 2, 3)):
            q.push(_Q(uid, pr, seq))
        out.append([r.uid for r in q])
        victim = q.pop(0)
        q.push(_Q(4, 2, 4))
        q.push(victim)
        out.append([r.uid for r in q])
        out.append(q.find_uid(3).uid)
        out.append(q.remove(q.find_uid(3)))
        out.append(q.find_uid(3))
        out.append(q.remove(_Q(3, 2, 3)))
        for pr in (5, 2, 0):
            for policy in ("reject", "shed_oldest",
                           "shed_lowest_priority"):
                v = q.pick_shed_victim(pr, policy)
                out.append(None if v is None else v.uid)
        out.append([r.uid for r in q])
        return out

    assert run(RequestQueue()) == run(JaxQueue())
    assert run(RequestQueue())[1] == [1, 3, 4, 0, 2]


def test_block_clamp_and_pending_cancels_match_the_jax_engine(ref):
    """``_clamp_k_deadline`` (the per-step EMA against the nearest live
    deadline) and ``_choose_block_k``'s pending-cancel rule on the same
    state in both engines."""
    kw = dict(num_slots=2, decode_block="adaptive",
              decode_block_buckets=(1, 4, 8, 16))
    out = []
    for make in (drills.jax_make(ref, False), drills.port_make(ref, False)):
        eng = make(**kw)
        free = eng.add_request(np.arange(1, 9), 40)
        eng.add_request(np.arange(3, 12), 40, deadline_s=1000.0)
        eng.step()
        got = []
        for ema in (None, 100.0, 400.0, 1e-3):
            eng._step_ema = ema
            got.append([eng._clamp_k_deadline(k) for k in (1, 4, 16)])
        eng._step_ema = 1e-3
        eng._cancel_pending.add(free)
        got.append(eng._choose_block_k())
        out.append(got)
    assert out[0] == out[1]
    assert out[1] == [[1, 1, 1], [1, 4, 8], [1, 1, 1], [1, 4, 16], 1]


def test_add_request_validation(ref):
    eng = drills.port_make(ref, False)()
    with pytest.raises(ValueError, match="deadline_s"):
        eng.add_request([1, 2], 4, deadline_s=-1.0)
    with pytest.raises(ValueError, match="max_queue"):
        drills.port_make(ref, False)(max_queue=0)
    with pytest.raises(ValueError, match="shed policy"):
        drills.port_make(ref, False)(shed_policy="yolo")
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.admit_migrated(tinf.Request(0, np.arange(60), 10))
    assert not eng.has_work


def test_the_fault_injector_is_a_lever(ref):
    """``ServingEngine(fault_injector=FaultInjector())`` constructs on
    both engine modes, and both export the resilience surface."""
    for mixed in (False, True):
        eng = drills.port_make(ref, mixed)(
            fault_injector=tinf.FaultInjector())
        for name in ("cancel", "close", "inflight", "eject",
                     "admit_migrated"):
            assert callable(getattr(eng, name)), name
        assert eng.faults is not None and eng.preemption


def test_resumed_request_cancelled_mid_prefill_keeps_its_tokens(ref):
    """A request preempted mid-decode and cancelled while its resume
    prefill runs: the port's Completion keeps the tokens it emitted
    before the preemption, as a queued resumed request's does. The JAX
    engine returns none there (its slot's token list starts empty until
    the first sample: ROADMAP C13)."""
    out = []
    for make in (drills.jax_make(ref, False), drills.port_make(ref, False)):
        rng = np.random.default_rng(0)
        eng = make(num_pages=9, prefix_cache=False,
                   prefill_chunks_per_step=1)
        done = {}
        low = eng.add_request(list(rng.integers(1, 97, size=12)), 24)
        drills.until_decoding(eng, low, done)
        eng.add_request(list(rng.integers(1, 97, size=20)), 20, priority=5)
        emitted = None
        for _ in range(200):
            drills.step(eng, done)
            st = next((s for s in eng._slots.values() if s.uid == low),
                      None)
            if st is not None and 0 < st.pf_base < st.pf_end:
                emitted = list(st.resume_out)
                break
        assert emitted and eng.cancel(low)
        drills.drain(eng, done)
        out.append((emitted, done[low]))
    (j_emitted, jc), (emitted, c) = out
    assert j_emitted == emitted and c.finish_reason == jc.finish_reason \
        == "cancelled" and c.preemptions == jc.preemptions == 1
    assert [int(t) for t in c.tokens] == emitted
    assert list(jc.tokens) == []


@pytest.mark.parametrize("spec", [False, True])
def test_teardown_survives_a_failing_abort(ref, spec):
    drills.check_teardown_past_a_failing_abort(ref, False, spec)
