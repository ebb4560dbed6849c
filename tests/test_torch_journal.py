"""The serving journal of the PyTorch port (``paddle_tpu_torch/observability/
journal.py``, ``ServingEngine(journal=...)``, ``FaultInjector.bind_journal``)
against the JAX reference's on the CPU.

The model is the reference's tiny GPT built after ``paddle.seed(0)``
(vocab 97, hidden 32, 2 layers, 4 heads, 64 positions; pages and chunks
of 8), its weights carried to the port through numpy. Held:

- a greedy journal recorded by the JAX engine replays through a fresh
  port engine with 0 divergences on all five axes of
  ``check_divergence`` (token streams, outcomes, ledger conservation,
  scale decisions, anatomy segments), and a port-recorded one through a
  fresh JAX engine, per phase (shared prefixes, fused decode blocks)
  and with ``mixed_step=True`` on traffic whose shared-prefix requests
  are never admitted in one step (ROADMAP C14);
- sampled traffic recorded by the port replays through the port with 0
  divergences (the two packages' generators differ, so sampled streams
  are held port against port only);
- ``config_fingerprint()`` key for key against the reference's for the
  same configuration and weights; the values too, but ``attention``
  (the implementation's name: ``jax`` in the reference, ``auto`` in the
  port) and so ``fingerprint``, the hash of the record;
- ``bind_journal``: the fault arms of a drill recorded with their step
  and replica by both engines alike, and the replay re-arming them;
- the recorded C14 case: the JAX mixed engine's journal of two requests
  sharing a prefix admitted in one step replays through the port's mixed
  engine with the second request's tokens as its only token divergence;
- the writer and reader: a torn tail, a corrupt line, rotation, the
  postmortem flush; ``write_workload`` byte for byte the reference's;
- ``bench_serving --workload --gen-workload`` and ``--overload
  --journal`` at ``--model tiny``: the reference's line keys, the
  workload's bytes, and the recorded overload leg replayed through a
  fresh engine of its fingerprint's configuration with 0 divergences.
Tolerances: none; every comparison is exact."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import FaultInjector as JaxFaultInjector
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import journal as jjnl
from paddle_tpu_torch.inference import FaultInjector
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import journal as jnl
from paddle_tpu_torch.observability import tracing as trc

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)
KW = dict(page_size=8, prefill_chunk=8, max_seq_len=64, num_slots=3)


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(**CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _jax(ref, **kw):
    return JaxEngine(ref[0], attention="jax", cost_analysis=False,
                     registry=JaxRegistry(), **dict(KW, **kw))


def _port(ref, **kw):
    return ServingEngine(GPTConfig(**CFG), ref[1], device="cpu",
                         registry=MetricsRegistry(), **dict(KW, **kw))


def _traffic(seed, n=6, shared=True, sampled=False):
    """Paced arrivals (one every 2 steps): prompts of 4-14 tokens, every
    other behind a shared 16-token prefix when ``shared``; with
    ``sampled`` every third request at temperature 0.8."""
    rng = np.random.default_rng(seed)
    prefix = list(rng.integers(1, 97, 16))
    items = []
    for i in range(n):
        tail = list(rng.integers(1, 97, int(rng.integers(4, 15))))
        items.append(dict(
            prompt=np.asarray(prefix + tail if shared and i % 2 else tail),
            max_new_tokens=int(rng.integers(4, 13)),
            temperature=0.8 if sampled and i % 3 == 2 else 0.0,
            seed=100 + i))
    return jnl.schedule_from_stream(items, arrival_steps=2)


def _record(make, pkg, sched, path, **kw):
    eng = make(journal=str(path), **kw)
    pkg.replay(sched, eng)
    eng.close()
    return eng


CASES = {"per_phase": dict(), "mixed": dict(mixed_step=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_jax_journal_replays_through_the_port(ref, case, tmp_path):
    kw = CASES[case]
    sched = _traffic(3, shared=case == "per_phase")
    path = tmp_path / "jax.jsonl"
    _record(lambda **k: _jax(ref, **k), jjnl, sched, path, **kw)
    res = jnl.replay(str(path), _port(ref, **kw))
    rep = jnl.check_divergence(str(path), res)
    assert rep["requests"] == len(sched) == rep["replayed"]
    assert rep["divergences"] == 0, rep["first"]
    assert rep["anatomy"] == {"recorded": 6, "replayed": 6}
    assert rep["conservation"]["replayed"] == {
        f"e{res.target.engine_id}": True}


@pytest.mark.parametrize("case", list(CASES))
def test_port_journal_replays_through_the_jax_engine(ref, case, tmp_path):
    kw = CASES[case]
    sched = _traffic(4, shared=case == "per_phase")
    path = tmp_path / "port.jsonl"
    eng = _record(lambda **k: _port(ref, **k), jnl, sched, path, **kw)
    res = jjnl.replay(str(path), _jax(ref, **kw))
    rep = jjnl.check_divergence(str(path), res)
    assert rep["requests"] == len(sched)
    assert rep["divergences"] == 0, rep["first"]
    events = jnl.read_journal(str(path))
    assert events.meta["recorder"] == "ServingEngine"
    assert [e["kind"] for e in events][:2] == ["meta", "config"]
    assert events.summary()["stats"]["tokens_emitted"] == \
        eng.stats["tokens_emitted"]
    assert events.summary()["conserved"] == {f"e{eng.engine_id}": True}


@pytest.mark.parametrize("case", list(CASES))
def test_port_sampled_journal_replays_through_the_port(ref, case, tmp_path):
    kw = CASES[case]
    sched = _traffic(5, shared=case == "per_phase", sampled=True)
    path = tmp_path / "sampled.jsonl"
    _record(lambda **k: _port(ref, **k), jnl, sched, path, **kw)
    rec = jnl.read_journal(str(path)).completes()
    assert any(jnl.read_journal(str(path)).submits()[u]["temperature"] > 0
               for u in rec)
    res = jnl.replay(str(path), _port(ref, **kw))
    rep = jnl.check_divergence(str(path), res)
    assert rep["divergences"] == 0, rep["first"]


@pytest.mark.parametrize("kw", [dict(), dict(mixed_step=True,
                                             kv_dtype="int8")],
                         ids=["default", "mixed_int8"])
def test_config_fingerprint_matches_the_reference_key_for_key(ref, kw):
    want = _jax(ref, **kw).config_fingerprint()
    got = _port(ref, **kw).config_fingerprint()
    assert list(got) == list(want)
    assert got["model"] == want["model"]
    assert got["weights_digest"] == want["weights_digest"]
    differ = {k for k in want if got[k] != want[k]}
    # the implementation's name, and the hash over the record holding it
    assert differ == {"attention", "fingerprint"}
    assert (want["attention"], got["attention"]) == ("jax", "auto")


def _fault_drill(make, inj, path):
    """Two greedy requests; a decode fault armed on the first at step 3
    and a stall at step 5 through the bound injector; then the drain."""
    eng = make(fault_injector=inj, journal=str(path))
    rng = np.random.default_rng(8)
    eng.add_request(list(rng.integers(1, 97, 10)), 10)
    eng.add_request(list(rng.integers(1, 97, 12)), 10)
    for i in range(1, 8):
        eng.step()
        if i == 3:
            inj.inject("decode_error", uid=0)
        if i == 5:
            inj.inject("stall", seconds=0.0)
    eng.run()
    eng.close()
    return eng


def test_bind_journal_records_fault_arms_and_replay_rearms_them(ref,
                                                                tmp_path):
    jpath, ppath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jeng = _fault_drill(lambda **k: _jax(ref, **k), JaxFaultInjector(),
                        jpath)
    peng = _fault_drill(lambda **k: _port(ref, **k), FaultInjector(), ppath)

    def faults(path, eng):
        return [{k: v for k, v in e.items() if k not in ("seq", "t")}
                | {"replica": e["replica"] == f"e{eng.engine_id}"}
                for e in jnl.read_journal(str(path)).by_kind("fault")]
    got = faults(ppath, peng)
    assert got == faults(jpath, jeng)
    assert [(f["fault"], f["step"], f["uid"]) for f in got] == [
        ("decode_error", 3, 0), ("stall", 5, None)]
    assert all(f["replica"] for f in got)
    assert jnl.read_journal(str(ppath)).completes()[0]["finish_reason"] \
        == "error"
    # the replay re-arms each fault on the fresh engine's own injector
    res = jnl.replay(str(jpath), _port(ref, fault_injector=FaultInjector()))
    assert not res.skipped
    rep = jnl.check_divergence(str(jpath), res)
    assert rep["divergences"] == 0, rep["first"]


def test_recorded_c14_case_diverges_on_the_second_request(ref, tmp_path):
    """ROADMAP C14 (kept on purpose): the JAX mixed engine runs the second
    request's tail chunk beside the first one's chunk 0, reading a prefix
    page not yet written; the port's mixed engine holds that row back.
    The recorded journal (tests/serving_drills.py's pair, seed 3) replays
    through the port's mixed engine with the second request's tokens
    diverging and the first request's identical."""
    prefix = np.random.default_rng(21).integers(1, 97, 16)
    rng = np.random.default_rng(3)
    sched = jnl.schedule_from_stream(
        [dict(prompt=np.concatenate([prefix, rng.integers(1, 97, 4)]),
              max_new_tokens=12) for _ in range(2)], arrival_steps=0)
    kw = dict(num_slots=2, decode_block=1, mixed_step=True)
    path = tmp_path / "c14.jsonl"
    _record(lambda **k: _jax(ref, **k), jjnl, sched, path, **kw)
    res = jnl.replay(str(path), _port(ref, **kw))
    rep = jnl.check_divergence(str(path), res)
    tokens = [d["uid"] for d in rep["all"] if d["field"] == "tokens"]
    assert tokens == [1]
    assert rep["first"]["uid"] == 1
    # and the port's mixed stream is its per-phase engine's
    per_phase = jnl.replay(str(path), _port(ref, num_slots=2,
                                            decode_block=1))
    assert res.completions[1].tokens == per_phase.completions[1].tokens


def test_journal_writer_reader_torn_tail_corrupt_line_and_flush(tmp_path):
    path = str(tmp_path / "j.jsonl")
    w = jnl.JournalWriter(path, meta={"model": "tiny"}, buffer_events=4)
    assert trc._postmortems and any(
        h["tracer"]() is w for h in trc._postmortems)
    w.event("submit", uid=0, step=0, prompt=[1, 2], max_new_tokens=2)
    # buffered: nothing but the meta line on disk until a flush
    assert len(open(path).read().splitlines()) == 0
    # the postmortem hook flushes it, as it dumps span trees
    trc.dump_all_postmortems(reason="test")
    assert len(open(path).read().splitlines()) == 2
    w.event("complete", uid=0, step=3, tokens=[5, 6],
            finish_reason="length")
    w.close()
    with pytest.raises(jnl.JournalError):
        w.event("summary", step=3)
    with pytest.raises(jnl.JournalError):
        jnl.JournalWriter(str(tmp_path / "k.jsonl")).event("nope")
    data = open(path).read()
    lines = data.splitlines()
    # a corrupt line in the middle is skipped and reported, a torn tail
    # (no newline) dropped as the crash tail; strict raises on either
    bad = "\n".join([lines[0], "{not json", *lines[1:]]) + "\n" + \
        lines[-1][:10]
    open(path, "w").write(bad)
    r = jnl.JournalReader(path)
    assert [e["kind"] for e in r] == ["meta", "submit", "complete"]
    assert r.truncated and len(r.errors) == 1
    with pytest.raises(jnl.JournalError):
        jnl.JournalReader(path, strict=True)
    # the reference's reader takes the port's file alike
    jr = jjnl.JournalReader(path)
    assert [e["kind"] for e in jr] == ["meta", "submit", "complete"]
    assert jr.meta["format"] == jnl.JOURNAL_FORMAT == jjnl.JOURNAL_FORMAT


def test_journal_rotation_stitches_generations(tmp_path):
    path = str(tmp_path / "r.jsonl")
    w = jnl.JournalWriter(path, buffer_events=1, max_bytes=300)
    for i in range(12):
        w.event("submit", uid=i, step=i, prompt=[i], max_new_tokens=1)
    w.close()
    assert os.path.exists(path + ".1")
    r = jnl.JournalReader(path)
    assert not r.errors
    assert sorted(r.submits())[-1] == 11
    seqs = [e["seq"] for e in r.events if e["kind"] == "submit"]
    assert seqs == sorted(seqs)
    metas = r.by_kind("meta")
    assert metas[-1]["continues"] == w.journal_id


@pytest.mark.parametrize("kw", [dict(seed=7, requests=40, vocab=97),
                                dict(seed=3, requests=64, vocab=50304,
                                     tenants={"a": 1, "b": (2, 1)},
                                     prefix_groups=3)],
                         ids=["tiny", "tenants"])
def test_write_workload_is_byte_identical_to_the_reference(tmp_path, kw):
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    jnl.write_workload(a, **kw)
    jjnl.write_workload(b, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    ev, params = jnl.generate_workload(**kw)
    assert (ev, params) == jjnl.generate_workload(**kw)
    for e in ev[:8]:
        assert np.array_equal(jnl.expand_prompt(e), jjnl.expand_prompt(e))


def test_generated_workload_replays_through_the_port_and_jax(ref, tmp_path):
    """A generated workload (greedy only: sampled streams differ between
    the packages) recorded by the port's per-phase engine replays through
    the JAX engine with 0 divergences."""
    wl = str(tmp_path / "wl.jsonl")
    jnl.write_workload(wl, seed=11, requests=10, vocab=97, max_prompt=24,
                       max_new=8, prefix_len=8, sample_frac=0.0)
    rec = str(tmp_path / "rec.jsonl")
    eng = _port(ref, journal=rec)
    res = jnl.replay(wl, eng)
    eng.close()
    assert len(res.completions) == 10
    rep = jjnl.check_divergence(rec, jjnl.replay(rec, _jax(ref)))
    assert rep["divergences"] == 0, rep["first"]


def test_shared_journal_writer_is_flushed_not_closed(ref, tmp_path):
    path = str(tmp_path / "shared.jsonl")
    w = jnl.JournalWriter(path, buffer_events=1000)
    eng = _port(ref, journal=w)
    eng.add_request([1, 2, 3], 3)
    eng.run()
    eng.close()
    kinds = [e["kind"] for e in jnl.read_journal(path)]
    assert kinds == ["meta", "config", "submit", "complete", "summary"]
    w.event("meta", note="still open")
    w.close()


def test_bench_serving_journal_and_workload_legs(tmp_path, capsys):
    """``bench_serving`` at ``--model tiny`` on the CPU: ``--workload
    --gen-workload`` writes the workload byte for byte as the reference's
    ``write_workload`` with the same arguments and prints the reference's
    ``workload_replay`` keys; ``--overload --journal`` records the
    resilient leg (its SLO and watchdog columns filled), and the recorded
    journal replays through a fresh engine of the fingerprint's
    configuration with 0 divergences."""
    from paddle_tpu_torch.models.gpt import gpt2_tiny, init_params
    from paddle_tpu_torch.tools import bench_serving
    common = ["--model", "tiny", "--device", "cpu", "--slots", "2",
              "--max-new", "8", "--min-prompt", "4", "--max-prompt", "12",
              "--page-size", "8", "--prefill-chunk", "8",
              "--warmup-requests", "1"]
    wl = str(tmp_path / "wl.jsonl")
    # --prefix-len sizes the engine for the generated prefix groups (as in
    # the reference, a 0 prefix length generates 2-page prefixes that the
    # engine's max_seq_len does not count)
    bench_serving.main(common + ["--requests", "12", "--workload", wl,
                                 "--gen-workload", "--seed", "3",
                                 "--prefix-len", "16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "gpt2_tiny_workload_replay_tokens_per_sec"
    assert {"value", "unit", "workload", "workload_meta", "requests",
            "rejected", "ticks", "completions", "prefix_cache_hits",
            "prefix_cached_tokens", "attribution_conserved", "platform",
            "chips"} <= set(line)
    assert line["requests"] == 12 and line["attribution_conserved"] == 1.0
    meta = jnl.read_journal(wl).meta["workload"]
    ref = str(tmp_path / "ref.jsonl")
    jjnl.write_workload(ref, **{k: meta[k] for k in (
        "seed", "requests", "vocab", "min_prompt", "max_prompt", "min_new",
        "max_new", "prefix_groups", "prefix_len")})
    assert open(wl, "rb").read() == open(ref, "rb").read()
    rec = str(tmp_path / "overload.jsonl")
    bench_serving.main(common + ["--requests", "10", "--max-prompt", "24",
                                 "--overload", "--journal", rec])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["slo"] for r in line["slo"]] == ["overload-gold",
                                               "overload-bulk"]
    assert set(line["slo_alerts"]) == {"overload-gold", "overload-bulk"}
    assert isinstance(line["watchdog_trips_total"], int)
    assert line["journal"] == rec
    events = jnl.read_journal(rec)
    fp = events.by_kind("config")[0]["fingerprint"]
    cfg = gpt2_tiny(**{k: v for k, v in fp["model"].items()
                       if not k.startswith("moe_")})
    eng = ServingEngine(
        cfg, init_params(cfg, seed=0, device="cpu"), device="cpu",
        registry=MetricsRegistry(),
        **{k: fp[k] for k in ("num_slots", "page_size", "num_pages",
                              "max_seq_len", "prefill_chunk",
                              "prefill_chunks_per_step", "admit_lookahead",
                              "max_queue", "shed_policy", "preemption")})
    # the recording engine's warm-up is in the journal too (submitted on
    # its step clock before the window): the replay serves it as well
    assert fp["weights_digest"] == eng.config_fingerprint()["weights_digest"]
    res = jnl.replay(rec, eng)
    rep = jnl.check_divergence(rec, res)
    assert rep["requests"] == len(events.completes()) > 1
    assert rep["divergences"] == 0, rep["first"]
