"""The PyTorch port's mixed-step serving engine
(``ServingEngine(mixed_step=True)``, paddle_tpu_torch/inference/serving.py)
against the JAX reference's mixed-step engine
``paddle_tpu.inference.ServingEngine(attention="jax", mixed_step=True)``
on the same weights, and the serving programs' tensor-only signatures
that let a CUDA graph capture them.

Traffic: the reference's own mixed-step pin (tests/test_ragged_kernel.py
``_run``): 2 layers, hidden 32, 4 heads, vocab 97, 3 slots, pages of 8,
``max_seq_len`` 64, chunks of 16, prompts of 5, 19, 33, 7 and 24 tokens,
8 new tokens each. The reference's Pallas ragged kernel is no oracle
under this JAX version (ROADMAP C1): the oracle is its gather route.

- greedy streams equal the JAX mixed engine's over float32, int8 and fp8
  pools and with int8 weights, its dispatch counters equal, and its
  dispatches strictly below the port's per-phase engine's; over
  quantized pools every dequantized element within one code step of the
  reference's (tests/test_torch_quant_serving.py's rule); with int8
  weights an element past one step must be past it in the per-phase
  engines too, and within two;
- sampled streams (temperature 0.8) equal the port's per-phase engine's
  (one Gumbel draw of ``[V]`` per emitted token from the slot's
  generator in both);
- ``prefill_chunks_per_step`` on a mixed engine raises ValueError;
- the closed-form emit/EOS/budget mask equals the reference's scan;
- the prefill program with 0-d tensor ``base``/``last_idx``, the page
  copy with tensor pages, and the decode programs with a zero noise
  buffer give exactly the outputs of ints and ``noise=None``.

Engines run on the CPU here, eagerly (CUDA graphs exist on the card
only: tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry
from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                _build_serving_fns,
                                                _emit_block)
from paddle_tpu_torch.models.gpt import (GPTConfig, make_layer_core,
                                         params_from_numpy)

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
KW = dict(num_slots=3, page_size=8, max_seq_len=64, prefill_chunk=16)
STATS = ("dispatches", "mixed_steps", "prefill_chunks", "steps",
         "decode_blocks", "tokens_emitted", "prefix_hits", "cow_copies")


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _jax(ref, **kw):
    return JaxEngine(ref[0], attention="jax", cost_analysis=False,
                     registry=MetricsRegistry(), **dict(KW, **kw))


def _port(ref, **kw):
    return ServingEngine(GPTConfig(**CFG), ref[1], device="cpu",
                         **dict(KW, **kw))


def _run(eng, temp=0.0):
    """tests/test_ragged_kernel.py ``_run``: five prompts at once, so
    prefill chunks and decode rows share dispatches."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 97, size=n).tolist()
               for n in (5, 19, 33, 7, 24)]
    uids = [eng.add_request(p, max_new_tokens=8, temperature=temp,
                            seed=100 + i) for i, p in enumerate(prompts)]
    done = eng.run(max_steps=400)
    eng.kv.verify()
    assert eng.kv.num_in_use == 0
    return [done[u].tokens for u in uids]


def test_mixed_greedy_matches_the_jax_mixed_engine(ref):
    jeng, eng, legacy = _jax(ref, mixed_step=True), \
        _port(ref, mixed_step=True), _port(ref)
    assert _run(eng) == _run(jeng) == _run(legacy)
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["mixed_steps"] > 0
    assert eng.stats["dispatches"] < legacy.stats["dispatches"]
    assert legacy.stats["mixed_steps"] == 0


def test_mixed_sampled_equals_the_per_phase_engine(ref):
    mixed = _run(_port(ref, mixed_step=True), temp=0.8)
    assert mixed == _run(_port(ref), temp=0.8)
    assert all(len(set(t)) > 1 for t in mixed)     # it really sampled


def _code_step(mag, fmt):
    """The code grid's spacing at code magnitude ``mag`` (int8: 1; e4m3:
    2^(e - 3) in the binade [2^e, 2^(e+1)), 2^-9 below 2^-6)."""
    if fmt == "int8":
        return np.ones_like(mag)
    e = np.floor(np.log2(np.maximum(mag, 2.0 ** -6)))
    return 2.0 ** (e - 3)


def _codes(t):
    return np.asarray(t.astype(jax.numpy.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


def _far_codes(eng, jeng, fmt):
    """Every dequantized pool element of ``eng`` more than one code step
    from ``jeng``'s (tests/test_torch_quant_serving.py's rule), as
    ``{(pool, layer, index): distance in code steps}``, and the share of
    codes equal. Page 0 is the trash page (dead rows and duplicates land
    there) and is left out."""
    far, same, total = {}, 0, 0
    for kind, pools, jpools, scales, jscales in (
            ("k", eng.kv.k, jeng.kv.k, eng.kv.k_scale, jeng.kv.k_scale),
            ("v", eng.kv.v, jeng.kv.v, eng.kv.v_scale, jeng.kv.v_scale)):
        for li in range(CFG["num_layers"]):
            c, jc = _codes(pools[li])[1:], _codes(jpools[li])[1:]
            s = scales[li].numpy()[1:, None, :, None]
            js = np.asarray(jscales[li])[1:, None, :, None]
            mag = np.maximum(np.abs(c), np.abs(jc))
            step = _code_step(mag, fmt) * np.maximum(s, js)
            err = np.abs(c * s - jc * js) - mag * np.abs(s - js)
            # an unused page has zero scales on both sides: no step, no error
            dist = np.divide(err, step, out=np.zeros_like(err),
                             where=step > 0)
            for i in np.argwhere(dist > 1 + 1e-6):
                far[(kind, li, tuple(i.tolist()))] = float(dist[tuple(i)])
            same += int((c == jc).sum())
            total += c.size
    return far, same / total


@pytest.mark.parametrize("kv_dtype,weight_dtype", [
    ("int8", None), ("fp8", None), ("int8", "int8"), ("fp8", "int8")])
def test_quantized_mixed_matches_the_jax_mixed_engine(ref, kv_dtype,
                                                      weight_dtype):
    kw = dict(mixed_step=True, kv_dtype=kv_dtype, weight_dtype=weight_dtype)
    jeng, eng = _jax(ref, **kw), _port(ref, **kw)
    assert _run(eng) == _run(jeng)
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    far, same = _far_codes(eng, jeng, kv_dtype)
    if weight_dtype is None:
        assert not far
        assert same >= 0.999
        return
    # with int8 weights the products over the widened weights round
    # otherwise than the reference's, and a moved code moves the later
    # rows: an element past one code step must be one the per-phase
    # engines (the same weights and traffic) show too, and within two
    kw["mixed_step"] = False
    jphase, phase = _jax(ref, **kw), _port(ref, **kw)
    assert _run(phase) == _run(jphase)
    far_phase, _ = _far_codes(phase, jphase, kv_dtype)
    assert set(far) == set(far_phase)
    assert all(d <= 2 + 1e-6 for d in (*far.values(), *far_phase.values()))
    assert same >= 0.995


def test_mixed_with_a_shared_prefix_and_copy_on_write(ref):
    """The page copy and the prefix cache under the mixed dispatch: a
    prompt of whole pages served twice (the second maps every page and
    clones the last) beside requests sharing a prefix."""
    rng = np.random.RandomState(7)
    shared = rng.randint(1, 97, 16)
    reqs = [(shared, 6), (np.concatenate([shared, rng.randint(1, 97, 5)]),
                          10), (rng.randint(1, 97, 9), 12)]
    outs = []
    for eng in (_jax(ref, mixed_step=True), _port(ref, mixed_step=True)):
        uids, done = [], {}
        for i, (p, n) in enumerate(reqs):
            uids.append(eng.add_request(p, n))
            if i == 0:                    # drain: its pages turn cached
                done.update(eng.run(max_steps=400))
        done.update(eng.run(max_steps=400))
        uids.append(eng.add_request(shared, 8))   # every page cached
        done.update(eng.run(max_steps=400))
        outs.append(([done[u].tokens for u in uids],
                     {k: eng.stats[k] for k in STATS}))
        eng.kv.verify()
    assert outs[0] == outs[1]
    assert outs[1][1]["cow_copies"] >= 1 and outs[1][1]["prefix_hits"] > 0


def test_mixed_step_refuses_prefill_chunks_per_step(ref):
    with pytest.raises(ValueError, match="prefill_chunks_per_step"):
        _port(ref, mixed_step=True, prefill_chunks_per_step=2)


def test_mixed_engine_logs_the_per_phase_logits(ref):
    """``record_logits`` on the mixed engine: the prefill row's logits at
    activation, then the decode rows' for every emitted token, as the
    per-phase engine logs them."""
    logs = []
    for mixed in (True, False):
        eng = _port(ref, mixed_step=mixed, record_logits=True)
        _run(eng)
        logs.append(eng.logit_log)
    assert logs[0].keys() == logs[1].keys()
    for uid in logs[0]:
        assert len(logs[0][uid]) == len(logs[1][uid]) == 8
        for a, b in zip(logs[0][uid], logs[1][uid]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _scan(chain, n_emit, active, eos_ids, remaining):
    """The reference's ``mask_body`` scan (serving.py:1226-1236), step by
    step."""
    act, rem = active.clone(), remaining.clone()
    toks, emits = [], []
    for j in range(chain.shape[1]):
        emit = act & (j < n_emit)
        hit = emit & (chain[:, j] == eos_ids)
        rem = rem - emit.to(rem.dtype)
        act = emit & ~hit & (rem > 0)
        toks.append(chain[:, j])
        emits.append(emit)
    return torch.stack(toks), torch.stack(emits)


@pytest.mark.parametrize("seed", range(4))
def test_emit_block_equals_the_reference_scan(seed):
    g = torch.Generator().manual_seed(seed)
    S, QB = 16, 6
    chain = torch.randint(0, 4, (S, QB), generator=g)
    n_emit = torch.randint(0, QB + 1, (S,), generator=g)
    active = torch.rand(S, generator=g) > 0.2
    eos_ids = torch.randint(-1, 4, (S,), generator=g)
    remaining = torch.randint(0, QB + 2, (S,), generator=g)
    toks, emits = _emit_block(chain, n_emit, active, eos_ids, remaining)
    want_t, want_e = _scan(chain, n_emit, active, eos_ids, remaining)
    assert torch.equal(toks, want_t) and torch.equal(emits, want_e)
    assert emits.any() and not emits.all()


# -- the programs' tensor-only signatures -------------------------------------

S, PS, MP, C = 2, 8, 8, 8


def _programs(ref, quant):
    cfg = GPTConfig(**CFG)
    progs = _build_serving_fns(make_layer_core(cfg), num_slots=S,
                               page_size=PS, pages_per_slot=MP,
                               prefill_chunk=C, attention="auto",
                               device=torch.device("cpu"), quant=quant)
    g = torch.Generator().manual_seed(3)
    shape = (S * MP + 1, PS, 4, 8)
    if quant:
        from paddle_tpu_torch.quantization.kv import quantize_per_page
        pools = [[quantize_per_page(torch.randn(shape, generator=g),
                                    dtype=quant) for _ in range(2)]
                 for _ in range(2)]
        kv = ([p[0] for p in pools[0]], [p[0] for p in pools[1]],
              [p[1] for p in pools[0]], [p[1] for p in pools[1]])
    else:
        kv = ([torch.randn(shape, generator=g) for _ in range(2)],
              [torch.randn(shape, generator=g) for _ in range(2)], (), ())
    bt = torch.arange(1, S * MP + 1, dtype=torch.int32).reshape(S, MP)
    return progs, kv, bt


def _clone(kv):
    return tuple([t.clone() for t in ts] for ts in kv)


def _same_pools(a, b):
    for ts, us in zip(a, b):
        for t, u in zip(ts, us):
            assert torch.equal(t.view(torch.uint8) if t.element_size() == 1
                               else t, u.view(torch.uint8)
                               if u.element_size() == 1 else u)


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_tensor_scalars_give_the_int_programs_outputs(ref, quant):
    progs, kv, bt = _programs(ref, quant)
    params = ref[1]
    rng = np.random.RandomState(4)
    chunk = torch.from_numpy(rng.randint(0, 97, C).astype(np.int64))
    a, b = _clone(kv), _clone(kv)
    for base, last in ((0, 5), (8, 0), (16, 7)):
        la = progs.prefill(params, *a, bt[1], base, chunk, last)
        lb = progs.prefill(params, *b, bt[1], torch.tensor(base),
                           chunk, torch.tensor(last))
        assert torch.equal(la, lb)
    _same_pools(a, b)
    progs.copy_page(*a, 11, 3)
    progs.copy_page(*b, torch.tensor(11), torch.tensor(3))
    _same_pools(a, b)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_zero_noise_gives_the_greedy_programs_outputs(ref, quant):
    progs, kv, bt = _programs(ref, quant)
    params = ref[1]
    lengths = torch.tensor([13, 30])
    tokens = torch.tensor([5, 61])
    active = torch.tensor([True, True])
    temps = torch.zeros(S)
    a, b = _clone(kv), _clone(kv)
    na, la = progs.decode_step(params, *a, bt, lengths, tokens, active,
                               temps, None)
    nb, lb = progs.decode_step(params, *b, bt, lengths, tokens, active,
                               temps, torch.zeros(S, CFG["vocab_size"]))
    assert torch.equal(na, nb) and torch.equal(la, lb)
    eos, rem = torch.tensor([-1, int(na[1])]), torch.tensor([4, 9])
    outs = [progs.decode_block(4, params, *pools, bt, lengths, tokens,
                               active, temps, eos, rem, noise,
                               collect_logits=True)
            for pools, noise in ((a, None),
                                 (b, torch.zeros(4, S, CFG["vocab_size"])))]
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    _same_pools(a, b)
