"""The tools' mesh flags on the CPU (two ``gloo`` ranks a leg):

- ``bench_serving --mesh 1,2 --collective-dtype f32,int8`` prints one
  line a leg with the reference's mesh columns: tokens/s/chip divided by
  mp, ``tokens_per_chip_vs_mp1``, the per-chip pool bytes, the counted
  decode-step collective bytes equal to the prediction, the int8 leg's
  logit error, the backend (``gloo``) and ``captured`` (False);
- a journal recorded by a fleet of single-card engines (a replica killed
  mid-stream) replays through ``replay --mesh 2`` to the same tokens
  (``identical``, 0 divergences) under f32 collectives.
"""
import json

import numpy as np

from paddle_tpu_torch.inference import (EngineReplica, FaultInjector,
                                        FleetRouter, ServingEngine)
from paddle_tpu_torch.models.gpt import GPTConfig, init_params
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.tools import bench_serving, replay


def test_bench_serving_mesh_sweep(capsys):
    bench_serving.main([
        "--model", "tiny", "--device", "cpu", "--requests", "4",
        "--slots", "2", "--max-new", "6", "--min-prompt", "4",
        "--max-prompt", "12", "--page-size", "8", "--prefill-chunk", "8",
        "--warmup-requests", "1", "--mesh", "1,2",
        "--collective-dtype", "f32,int8"])
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert [(r["mp"], r["collective_dtype"]) for r in out] == \
        [(1, "f32"), (2, "f32"), (2, "int8")]
    one, two, q = out
    assert one["backend"] is None and one["tokens_per_chip_vs_mp1"] is None
    for r in (two, q):
        assert r["chips"] == 2 and r["kv_shard"] == "heads"
        assert r["backend"] == "gloo" and r["captured"] is False
        assert r["tokens_per_chip_vs_mp1"] > 0
        assert r["kv_pool_bytes_per_chip"] * 2 == r["kv_pool_bytes"]
        assert r["decode_collective_bytes_counted"] == \
            r["decode_collective_bytes_predicted"] > 0
        assert r["collective_bytes_per_token"] > 0
        assert r["mbu_per_chip"] <= r["mbu"]
        assert r["attribution_conserved"] == 1.0
    # gpt2_tiny: H 64, 2 layers, 2 slots
    assert two["decode_collective_bytes_predicted"] == 2 * (2 * 2 * 64 * 4)
    assert q["decode_collective_bytes_predicted"] == 2 * (2 * 2 * 2 * 68)
    assert one["collective_bytes_total"] == 0
    assert q["quant_logit_err_absmax"] is not None
    assert two["quant_logit_err_absmax"] is None


def test_replay_on_a_mesh(tmp_path, capfd):
    cfg = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                    num_heads=4, max_position_embeddings=64, dropout=0.0)
    params = init_params(cfg, seed=0, device="cpu")

    def mk(inj):
        return ServingEngine(cfg, params, device="cpu", num_slots=2,
                             page_size=8, prefill_chunk=8, max_seq_len=64,
                             decode_block=1, registry=MetricsRegistry(),
                             fault_injector=inj)
    path = str(tmp_path / "rec.jsonl")
    e0 = mk(FaultInjector())
    router = FleetRouter([EngineReplica(e0, "f0"),
                          EngineReplica(mk(None), "f1")],
                         registry=MetricsRegistry(), journal=path,
                         saturation_depth=2)
    rng = np.random.RandomState(5)
    for i in range(8):
        router.submit(prompt=rng.randint(0, 97, 4 + i % 5),
                      max_new_tokens=5, temperature=0.8 if i % 3 else 0.0,
                      seed=i)
        router.step()
        if i == 4:
            e0.faults.inject("replica_down")
    router.run(max_steps=10_000)
    router.close()
    assert replay.main(["--journal", path, "--device", "cpu", "--mesh",
                        "2", "--quiet"]) == 0
    # rank 0 prints the line (a child process: capture its descriptor)
    line = json.loads([x for x in capfd.readouterr().out.splitlines()
                       if x.startswith("{")][-1])
    assert line["identical"] and line["divergences"] == 0
    assert line["mp"] == 2 and line["backend"] == "gloo"
    assert line["requests"] == 8 and line["problems"] == []
