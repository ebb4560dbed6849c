"""The fleet journal of the PyTorch port — a ``FleetRouter(journal=...)``
window recorded by one package and replayed through the other's fleet —
and the port's fleet tools (``paddle_tpu_torch/tools/replay.py``,
``autoscale_sim.py`` and ``bench_serving --fleet / --autoscale``) on the
CPU.

The model is the reference's fleet-test GPT (vocab 97, hidden 32, 2
layers, 4 heads, 64 positions) built after ``paddle.seed(0)``, its weights
carried to the port through numpy (``params=`` of ``build_fleet``): a
journal records the weights' digest, not the weights, and the port's
``--param-seed`` does not make the reference's. Held:

- a greedy 2-replica window (shared prefixes, a saturated fleet whose
  priority-2 arrivals preempt across replicas, replica j0 killed
  mid-trace) recorded by the JAX fleet replays through a port fleet
  rebuilt from the journal's config events with 0 divergences on every
  axis, and the port's recording through a JAX fleet likewise;
- a sampled window recorded by the port replays through the port with 0
  divergences (sampled streams are held within a package);
- a tampered token trips the checker with span context;
- ``replay.py`` on the JAX journal with the port's own seed: the weights
  digest mismatch is a problem, exit 2; on a port journal: exit 0, its
  ``--out`` journal cross-linked; ``--selfcheck`` passes; ``--mesh``
  exits 2;
- ``bench_serving --device cpu --model tiny --fleet 2 --kill-replica 12
  --journal ...`` prints ``survived_frac`` 1.0 and a replay line of 0.0,
  and its journal replays through ``replay.py`` too;
- ``--autoscale 3 --workload ... --gen-workload --journal ...`` prints the
  reference's two lines (elastic 1 -> N -> 1, conserved, 0.0);
- ``autoscale_sim`` prints five legs with the chip-step ledger balanced.
Tolerances: none; every comparison is exact."""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import EngineReplica as JaxReplica
from paddle_tpu.inference import FaultInjector as JaxFaultInjector
from paddle_tpu.inference import FleetRouter as JaxRouter
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import journal as jjnl
from paddle_tpu_torch.inference import (EngineReplica, FaultInjector,
                                        FleetRouter, ServingEngine)
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import journal as jnl
from paddle_tpu_torch.tools import autoscale_sim, bench_serving, replay

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64, dropout=0.0)
KW = dict(num_slots=2, page_size=8, prefill_chunk=8, max_seq_len=64,
          decode_block=1)


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(**CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _jax_fleet(ref, journal=None):
    engines = [JaxEngine(ref[0], attention="jax", cost_analysis=False,
                         registry=JaxRegistry(),
                         fault_injector=JaxFaultInjector() if i == 0
                         else None, **KW) for i in range(2)]
    return JaxRouter([JaxReplica(e, f"j{i}") for i, e in enumerate(engines)],
                     registry=JaxRegistry(), journal=journal,
                     saturation_depth=2)


def _port_fleet(ref, journal=None):
    engines = [ServingEngine(GPTConfig(**CFG), ref[1], device="cpu",
                             registry=MetricsRegistry(),
                             fault_injector=FaultInjector() if i == 0
                             else None, **KW) for i in range(2)]
    return FleetRouter([EngineReplica(e, f"j{i}")
                        for i, e in enumerate(engines)],
                       registry=MetricsRegistry(), journal=journal,
                       saturation_depth=2)


def _window(sampled=False):
    """8 low-tier arrivals saturate 4 slots (two shared-prefix groups),
    then 3 priority-2 arrivals land on the saturated fleet (a remote
    preemption), and j0 dies mid-trace; with ``sampled`` every third
    request decodes at a temperature."""
    rng = np.random.RandomState(11)
    pref_a, pref_b = rng.randint(0, 97, 16), rng.randint(0, 97, 16)
    items = []
    for i in range(8):
        items.append({
            "prompt": np.concatenate([pref_a if i % 2 else pref_b,
                                      rng.randint(0, 97, 4 + i % 3)]),
            "max_new_tokens": 6 + i % 3,
            "temperature": 0.9 if sampled and i % 3 == 0 else 0.0,
            "seed": 100 + i, "priority": 0, "tenant": "bulk"})
    for i in range(3):
        items.append({
            "prompt": rng.randint(0, 97, 5 + i), "max_new_tokens": 5,
            "temperature": 0.7 if sampled and i % 2 == 0 else 0.0,
            "seed": 200 + i, "priority": 2, "tenant": "gold"})
    events = jnl.schedule_from_stream(items, arrival_steps=1)
    events.append({"kind": "fault", "step": 9, "seq": 99,
                   "fault": "replica_down", "replica": "j0"})
    return events


def _record(make, pkg, path, sampled=False):
    router = make(journal=str(path))
    pkg.replay(_window(sampled), router)
    router.close()
    assert router.stats["replica_deaths"] == 1
    assert router.stats["preempts_remote"] >= 1
    assert router.stats["requeued"] >= 1
    return router


def _args(journal, **kw):
    a = dict(journal=str(journal), out=None, kv_dtype="keep",
             weight_dtype="keep", decode_block="keep", param_seed=0,
             device="cpu", quiet=True)
    a.update(kw)
    return argparse.Namespace(**a)


def _jax_fleet_from(ref, rec):
    """A JAX fleet rebuilt from a journal's config events (the reference's
    ``tools/replay.build_fleet`` with ``attention="jax"``)."""
    cfgs = rec.by_kind("config")
    rfp = next(e["fingerprint"] for e in cfgs
               if e["fingerprint"].get("kind") == "router")
    reps = []
    for e in cfgs:
        fp = e["fingerprint"]
        if not fp.get("model"):
            continue
        eng = JaxEngine(ref[0], attention="jax", cost_analysis=False,
                        registry=JaxRegistry(),
                        fault_injector=JaxFaultInjector(),
                        num_slots=fp["num_slots"],
                        page_size=fp["page_size"],
                        num_pages=fp["num_pages"],
                        max_seq_len=fp["max_seq_len"],
                        prefill_chunk=fp["prefill_chunk"],
                        decode_block=fp["decode_block"])
        reps.append(JaxReplica(eng, e["replica"]))
    return JaxRouter(reps, registry=JaxRegistry(), name=rfp["name"],
                     saturation_depth=rfp["saturation_depth"],
                     seed=rfp["seed"])


def test_jax_fleet_journal_replays_through_the_port(ref, tmp_path):
    path = tmp_path / "jax.jsonl"
    _record(lambda **k: _jax_fleet(ref, **k), jjnl, path)
    rec = jnl.read_journal(str(path))
    router, problems = replay.build_fleet(rec, _args(path),
                                          MetricsRegistry(),
                                          params=ref[1])
    assert problems == []          # the carried weights' digest matches
    res = jnl.replay(rec, router)
    rep = jnl.check_divergence(rec, res)
    assert rep["requests"] == rep["replayed"] == 11
    assert rep["divergences"] == 0, rep["first"]
    assert rep["anatomy"] == {"recorded": 11, "replayed": 11}
    assert router.stats["replica_deaths"] == 1
    assert router.stats["preempts_remote"] >= 1
    router.close()


def test_port_fleet_journal_replays_through_the_jax_fleet(ref, tmp_path):
    path = tmp_path / "port.jsonl"
    rec_router = _record(lambda **k: _port_fleet(ref, **k), jnl, path)
    rec = jjnl.read_journal(str(path))
    assert rec.meta["recorder"] == "FleetRouter"
    kinds = [e["kind"] for e in rec]
    for kind in ("config", "submit", "fault", "replica_dead", "complete",
                 "summary"):
        assert kind in kinds, kind
    assert rec.summary()["stats"] == rec_router.stats
    dead = rec.by_kind("replica_dead")
    assert [e["replica"] for e in dead] == ["j0"]
    assert "injected replica death" in dead[0]["reason"]
    router = _jax_fleet_from(ref, rec)
    res = jjnl.replay(rec, router)
    rep = jjnl.check_divergence(rec, res)
    assert rep["requests"] == 11
    assert rep["divergences"] == 0, rep["first"]
    assert router.stats == rec_router.stats
    router.close()


def test_port_sampled_fleet_journal_replays_through_the_port(ref,
                                                             tmp_path):
    path = tmp_path / "sampled.jsonl"
    _record(lambda **k: _port_fleet(ref, **k), jnl, path, sampled=True)
    rec = jnl.read_journal(str(path))
    router, problems = replay.build_fleet(rec, _args(path),
                                          MetricsRegistry(),
                                          params=ref[1])
    assert problems == []
    res = jnl.replay(rec, router)
    rep = jnl.check_divergence(rec, res)
    assert rep["divergences"] == 0, rep["first"]
    # the checker trips on a tampered token, with span context
    tampered = json.loads(json.dumps(rec.events))
    for e in tampered:
        if e["kind"] == "complete" and e.get("tokens"):
            e["tokens"][0] = (e["tokens"][0] + 1) % 97
            break
    bad = jnl.check_divergence(tampered, res)
    assert not bad["identical"]
    assert bad["first"]["field"] == "tokens" and "span" in bad["first"]
    router.close()


def test_replay_tool_exit_codes(ref, tmp_path, capsys):
    """``replay.py``: a JAX journal against the port's own seed reports
    the weights digest as a problem and exits 2; a port journal of
    ``init_params`` weights replays with exit 0 and a cross-linked
    ``--out``; the int8 collective without ``--mesh`` exits 2 (the mesh
    replay itself: tests/test_torch_tp_tools.py); ``--selfcheck``
    passes."""
    jpath = tmp_path / "jax.jsonl"
    _record(lambda **k: _jax_fleet(ref, **k), jjnl, jpath)
    assert replay.main(["--journal", str(jpath), "--device", "cpu",
                        "--quiet"]) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert any("weights digest" in p for p in line["problems"])
    from paddle_tpu_torch.models.gpt import init_params
    own = (ref[0], init_params(GPTConfig(**CFG), seed=0, device="cpu"))
    ppath = tmp_path / "port.jsonl"
    _record(lambda **k: _port_fleet(own, **k), jnl, ppath)
    out = tmp_path / "replayed.jsonl"
    assert replay.main(["--journal", str(ppath), "--device", "cpu",
                        "--out", str(out), "--quiet"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["identical"] and line["divergences"] == 0
    assert line["problems"] == [] and line["requests"] == 11
    assert jnl.read_journal(str(out)).meta["replayed_from"] == \
        jnl.read_journal(str(ppath)).meta["id"]
    # an A/B lever that changes the schedule's outcome is reported, and
    # --expect-divergence keeps the exit code 0
    assert replay.main(["--journal", str(ppath), "--device", "cpu",
                        "--kv-dtype", "int8", "--expect-divergence",
                        "--quiet"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        replay.main(["--journal", str(ppath), "--device", "cpu",
                     "--collective-dtype", "int8"])
    assert e.value.code == 2
    assert replay.main(["--selfcheck", "--device", "cpu", "--quiet"]) == 0


def test_bench_serving_fleet_leg(tmp_path, capsys):
    path = str(tmp_path / "fleet.jsonl")
    bench_serving.main([
        "--device", "cpu", "--model", "tiny", "--fleet", "2",
        "--requests", "16", "--slots", "2", "--max-new", "8",
        "--min-prompt", "4", "--max-prompt", "12", "--page-size", "8",
        "--prefill-chunk", "8", "--warmup-requests", "1",
        "--kill-replica", "12", "--journal", path])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [ln["metric"] for ln in lines] == [
        "gpt2_tiny_fleet_router_affinity_hit_rate",
        "gpt2_tiny_fleet_journal_replay"]
    fl, rp = lines
    assert fl["survived_frac"] == 1.0
    assert fl["replica_deaths"] == 1 and fl["requeued"] >= 1
    assert len(fl["replica_dead_reasons"]) == 1
    assert "injected replica death" in fl["replica_dead_reasons"][0]
    assert fl["value"] > fl["random_hit_rate"]
    assert fl["anatomy_conserved_frac"] == 1.0
    assert fl["decode_compiles_max"] == fl["prefill_compiles_max"] == 1
    for ln in lines:
        assert (ln["platform"], ln["chips"], ln["replicas"]) == \
            ("cpu", 1, 2)
    assert rp["value"] == 0.0 and rp["replay_identical"] == 1.0
    assert rp["anatomy_divergences"] == 0 and rp["requests"] == 16
    # the bench's weights are init_params(seed 0): replay.py rebuilds
    # them from the journal alone
    assert replay.main(["--journal", path, "--device", "cpu",
                        "--quiet"]) == 0


def test_bench_serving_autoscale_leg_and_the_simulator(tmp_path, capsys):
    wl = str(tmp_path / "wl.jsonl")
    bench_serving.main([
        "--device", "cpu", "--model", "tiny", "--autoscale", "3",
        "--workload", wl, "--gen-workload", "--journal",
        str(tmp_path / "auto.jsonl"), "--requests", "24", "--slots", "2",
        "--max-new", "8", "--max-prompt", "32", "--page-size", "8",
        "--prefill-chunk", "8", "--seed", "3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [ln["metric"] for ln in lines] == [
        "gpt2_tiny_autoscale_chip_steps_saved_frac",
        "gpt2_tiny_autoscale_replay"]
    au, rp = lines
    assert au["elastic_1_n_1"] == 1.0
    assert au["chip_accounting_conserved"] == 1.0
    assert au["chip_steps_under_static"] == 1.0
    assert au["gold_burn_under_1"] == 1.0
    assert au["router_joins"] - 1 == au["decisions"]["scale_out"] == \
        len(au["joins"]) >= 1
    assert (au["platform"], au["chips"], au["replicas"]) == ("cpu", 1, 3)
    for ln in lines:
        assert (ln["join_failed"], ln["join_errors"], ln["replica_deaths"],
                ln["replica_dead_reasons"]) == (0, [], 0, [])
    assert all(au["placements_by_replica"][j["replica"]] >= 1
               for j in au["joins"])
    assert rp["value"] == 0.0 and rp["replay_identical"] == 1.0
    assert rp["scale_decisions"]["recorded"] == \
        rp["scale_decisions"]["replayed"] > 0
    assert autoscale_sim.main([wl, "--max-replicas", "3", "--slots", "1",
                               "--json"]) == 0
    legs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [leg["policy"] for leg in legs] == [
        "static-1", "static-3", "aggressive", "conservative", "default"]
    assert all(leg["conserved"] and leg["completed"] == 24
               for leg in legs)
    static = {leg["policy"]: leg for leg in legs}
    assert static["static-3"]["chip_steps"] == 3 * static["static-3"][
        "ticks"]
    assert max(leg["peak"] for leg in legs) >= 2
