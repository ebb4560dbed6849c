"""The PyTorch port's paged serving engine
(paddle_tpu_torch/inference/serving.py) against the JAX reference
engine ``paddle_tpu.inference.ServingEngine(attention="jax")`` on the
same weights (2 layers, hidden 64, 4 heads, vocab 128):

- greedy token streams identical and the scheduler's counters
  (``dispatches``, ``prefill_chunks``, ``decode_blocks``,
  ``prefix_hits``, ``cow_copies``) equal, with adaptive decode blocks,
  a shared prefix and a fully cached prompt (copy-on-write);
- the page allocator (``refcount`` and ``unregister`` included) and the
  prefix-cache digests against the reference's, operation by operation;
- a sampled request emits the same tokens alone or in a busy batch;
- ``mesh=`` takes a ``make_mesh`` handle (one rank: the single-card
  engine), and unknown quantization formats raise ValueError (the quantized levers
  themselves: tests/test_torch_quant_serving.py; ``mixed_step``:
  tests/test_torch_mixed_step.py)."""
import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference.serving import PagedKVCache as JaxKV
from paddle_tpu.inference.serving import _page_digests as jax_digests
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu_torch.inference.scheduler import QueueFullError
from paddle_tpu_torch.inference.serving import (PagedKVCache, Request,
                                                ServingEngine, _page_digests)
from paddle_tpu_torch.models.gpt import gpt2_tiny, params_from_numpy
from paddle_tpu_torch.observability import Tracer

# tiny shapes: a few threads are plenty, and the suite runs several
# workers at once beside timing-sensitive tests
torch.set_num_threads(2)

STATS = ("dispatches", "prefill_chunks", "decode_blocks", "prefix_hits",
         "cow_copies", "tokens_emitted", "fused_blocks", "steps")


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        max_position_embeddings=128, dropout=0.0))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _traffic(kind):
    rng = np.random.RandomState(0 if kind == "mixed" else 1)
    prefix = rng.randint(0, 128, 24)
    reqs = []
    for i in range(6):
        plen = int(rng.choice([5, 12, 23, 40]))
        p = rng.randint(0, 128, plen)
        if i in (2, 4):                    # two share a 24-token prefix
            p = np.concatenate([prefix, p[:8]])
        reqs.append((p, int(rng.choice([3, 9, 20, 40]))))
    if kind == "cow":
        # a prompt of whole pages sent again once its pages are cached:
        # the second copy maps every page and clones the last one
        whole = rng.randint(0, 128, 16)
        reqs[1] = (whole, 6)
        reqs[5] = (whole.copy(), 30)
    return reqs


@pytest.mark.parametrize("kind,kw", [
    ("mixed", dict(num_slots=3)),
    ("cow", dict(num_slots=2, prefill_chunks_per_step=2,
                 admit_lookahead=2)),
    ("mixed", dict(num_slots=2, prefix_cache=False,
                   decode_block_buckets=(1, 2, 8))),
])
def test_greedy_streams_and_counters_match_jax_engine(ref, kind, kw):
    m, params = ref
    kw = dict(kw, page_size=8, prefill_chunk=8, max_seq_len=128,
              decode_block="adaptive")
    reqs = _traffic(kind)
    jeng = JaxEngine(m, attention="jax", cost_analysis=False, **kw)
    juids = [jeng.add_request(p, n) for p, n in reqs]
    jdone = jeng.run(max_steps=2000)
    eng = ServingEngine(gpt2_tiny(), params, device="cpu", **kw)
    uids = [eng.add_request(p, n) for p, n in reqs]
    done = eng.run(max_steps=2000)
    for ju, u in zip(juids, uids):
        assert done[u].tokens == jdone[ju].tokens, f"request {u} diverged"
        assert done[u].finish_reason == jdone[ju].finish_reason
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["fused_blocks"] > 0
    assert (eng.stats["prefix_hits"] > 0) == kw.get("prefix_cache", True)
    if kind == "cow":
        assert eng.stats["cow_copies"] > 0
    eng.kv.verify()
    assert eng.kv.num_in_use == 0


def test_fixed_decode_block_is_token_identical_to_per_token(ref):
    _, params = ref
    reqs = _traffic("mixed")
    outs = []
    for block in (1, 4):
        eng = ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=3,
                            page_size=8, prefill_chunk=8, max_seq_len=128,
                            decode_block=block)
        uids = [eng.add_request(p, n) for p, n in reqs]
        done = eng.run(max_steps=2000)
        outs.append([done[u].tokens for u in uids])
        if block == 4:
            assert eng.stats["fused_blocks"] > 0
    assert outs[0] == outs[1]


def test_sampled_request_same_alone_or_in_a_busy_batch(ref):
    _, params = ref
    rng = np.random.RandomState(3)
    target = rng.randint(0, 128, 13)
    others = [(rng.randint(0, 128, int(n)), int(k), float(t), int(s))
              for n, k, t, s in ((9, 30, 0.9, 11), (20, 12, 0.0, 0),
                                 (31, 25, 1.2, 12))]
    kw = dict(page_size=8, prefill_chunk=8, max_seq_len=128)
    solo = ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=1,
                         **kw)
    u = solo.add_request(target, 24, temperature=0.9, seed=7)
    alone = solo.run(max_steps=500)[u].tokens
    busy = ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=4,
                         **kw)
    for p, n, t, s in others:
        busy.add_request(p, n, temperature=t, seed=s)
    busy.step()
    busy.step()                      # the target joins mid-flight
    u = busy.add_request(target, 24, temperature=0.9, seed=7)
    together = busy.run(max_steps=500)[u].tokens
    assert together == alone
    assert busy.stats["fused_blocks"] > 0 or solo.stats["fused_blocks"] > 0
    assert len(set(alone)) > 1       # it really sampled


def test_eos_finishes_a_request(ref):
    _, params = ref
    prompt = np.arange(3, 20)
    eng = ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=2,
                        page_size=8, prefill_chunk=8, max_seq_len=128)
    u = eng.add_request(prompt, 20)
    full = eng.run()[u].tokens
    eos = full[4]
    cut = full[:full.index(eos) + 1]
    u = eng.add_request(prompt, 20, eos_id=eos)
    got = eng.run()[u]
    assert got.finish_reason == "eos" and got.tokens == cut
    eng.kv.verify()


def test_page_digests_are_byte_identical_to_jax():
    tokens = np.random.RandomState(4).randint(0, 50000, 77)
    assert _page_digests(tokens, 16) == jax_digests(tokens, 16)
    assert _page_digests(tokens[:15], 16) == jax_digests(tokens[:15], 16)


def test_kv_allocator_matches_jax_op_for_op():
    import jax.numpy as jnp
    ours = PagedKVCache(1, 12, 4, 2, 8, torch.float32, prefix_cache=True,
                        device="cpu")
    theirs = JaxKV(1, 12, 4, 2, 8, jnp.float32, prefix_cache=True)
    d = _page_digests(np.arange(40), 4)

    def both(op, *args):
        a, b = getattr(ours, op)(*args), getattr(theirs, op)(*args)
        assert a == b, (op, args, a, b)
        assert (ours.num_free, ours.num_cached, ours.num_in_use,
                ours.num_shared) == (theirs.num_free, theirs.num_cached,
                                     theirs.num_in_use, theirs.num_shared)
        ours.verify()
        theirs.verify()
        return a

    p1 = both("alloc", 4)
    for i, p in enumerate(p1[:3]):
        both("register", d[i], p)
    both("share", p1[0])
    p2 = both("alloc", 5)
    both("release", p1)
    assert both("lookup", d[1]) == p1[1]
    both("share", p1[1])                  # a cache-only page comes back
    both("release", p2)
    assert [both("refcount", p) for p in p1] == [1, 1, 0, 0]
    assert both("unregister", d[2])       # orphans a cache-only page
    assert not both("unregister", d[2])
    assert both("unregister", d[1])       # an in-use page stays in use
    assert both("refcount", p1[1]) == 1 and both("lookup", d[1]) is None
    with pytest.raises(RuntimeError):
        ours.release([p2[0]])             # double free
    both("alloc", 9)                      # evicts cache-only pages LRU
    assert both("alloc", 50) is None


def test_kv_verify_detects_a_broken_pool():
    kv = PagedKVCache(1, 6, 4, 2, 8, torch.float32, device="cpu")
    kv.alloc(2)
    kv._free.append(kv._free[0])
    with pytest.raises(RuntimeError):
        kv.verify()


def test_bf16_weights_and_pool_serve_on_cpu(ref):
    _, params = ref
    eng = ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=2,
                        page_size=8, prefill_chunk=8, max_seq_len=128,
                        weight_dtype="bf16", kv_dtype="bf16")
    assert eng.kv.k[0].dtype == torch.bfloat16
    assert eng.params["wte"].dtype == torch.bfloat16
    uids = [eng.add_request(np.arange(1, 1 + n), 10) for n in (7, 19)]
    done = eng.run(max_steps=500)
    assert [len(done[u].tokens) for u in uids] == [10, 10]
    eng.kv.verify()


def test_queue_bound_sheds_or_rejects(ref):
    _, params = ref
    kw = dict(device="cpu", num_slots=1, page_size=8, prefill_chunk=8,
              max_seq_len=64, max_queue=1)
    rej = ServingEngine(gpt2_tiny(), params, **kw)
    rej.add_request([1, 2, 3], 2)
    with pytest.raises(QueueFullError):
        rej.add_request([4, 5, 6], 2)
    shed = ServingEngine(gpt2_tiny(), params, shed_policy="shed_oldest",
                         **kw)
    first = shed.add_request([1, 2, 3], 2)
    second = shed.add_request([4, 5, 6], 2)
    done = shed.run()
    assert done[first].finish_reason == "shed"
    assert done[second].finish_reason == "length"


@pytest.mark.parametrize("lever", [
    dict(mesh=object()), dict(speculative=True, tracer=Tracer("t")),
    dict(trace_ctx={"trace_id": "t"}), dict(journal="j.jsonl"),
    dict(tracer=Tracer("t")), dict(watchdog=True),
])
def test_unported_levers_raise(ref, lever, tmp_path):
    """Every lever of this list is ported now. ``mesh=`` takes a
    ``make_mesh`` handle (anything else raises TypeError; one rank is the
    single-card engine; tests/test_torch_tp_serving.py holds the sharded
    engine to the reference's). The tracer (speculative engines too),
    ``add_request``'s and ``admit_migrated``'s ``trace_ctx=``, the
    journal and the watchdog serve (tests/test_torch_serving_telemetry.py,
    tests/test_torch_journal.py and tests/test_torch_slo.py hold them to
    the reference's)."""
    _, params = ref
    kw = dict(device="cpu", num_slots=1, page_size=8, prefill_chunk=8,
              max_seq_len=64, postmortem_path=str(tmp_path / "pm.json"))
    if "mesh" in lever:
        from paddle_tpu_torch.inference.tp import make_mesh
        with pytest.raises(TypeError, match="make_mesh"):
            ServingEngine(gpt2_tiny(), params, **kw, **lever)
        outs = []
        for mesh in (None, make_mesh(1)):
            eng = ServingEngine(gpt2_tiny(), params, mesh=mesh, **kw)
            u = eng.add_request([1, 2, 3], 4)
            outs.append(eng.run()[u].tokens)
            assert eng.chips == 1 and eng.tp is None
            eng.close()
        assert outs[0] == outs[1]
        return
    if "journal" in lever or "watchdog" in lever:
        if "journal" in lever:
            lever = dict(journal=str(tmp_path / lever["journal"]))
        eng = ServingEngine(gpt2_tiny(), params, **kw, **lever)
        u = eng.add_request([1, 2, 3], 2)
        assert set(eng.run()) == {u}
        eng.close()
        if "journal" in lever:
            kinds = [json.loads(x)["kind"]
                     for x in open(lever["journal"]).read().splitlines()]
            assert kinds == ["meta", "config", "submit", "complete",
                             "summary"]
        else:
            assert eng.watchdog is not None
        return
    if "trace_ctx" in lever or "tracer" in lever:
        ctx = lever.pop("trace_ctx", None)
        eng = ServingEngine(gpt2_tiny(), params, **kw, **lever)
        a = eng.add_request([1, 2, 3], 2, trace_ctx=ctx)
        b = eng.admit_migrated(Request(0, np.arange(3), 2), trace_ctx=ctx)
        assert set(eng.run()) == {a, b}
        assert eng._tracer.get(f"e{eng.engine_id}:req{b}").root.attrs[
            "migrated"] is True
        eng.close()
        return
    raise AssertionError(f"lever {lever} has no case")


@pytest.mark.parametrize("lever,match", [
    (dict(kv_dtype="fp4"), "kv_dtype"),
    (dict(weight_dtype="int4"), "weight_dtype"),
])
def test_unknown_quantization_levers_raise_value_error(ref, lever, match):
    """The reference's lever validation (tests/test_quant_decode.py
    ``test_lever_validation``): an unknown format is a ValueError."""
    _, params = ref
    with pytest.raises(ValueError, match=match):
        ServingEngine(gpt2_tiny(), params, device="cpu", num_slots=1,
                      page_size=8, prefill_chunk=8, max_seq_len=64, **lever)
