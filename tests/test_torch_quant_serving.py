"""Quantized serving of the PyTorch port (int8/fp8 paged KV pools,
int8 weights: paddle_tpu_torch/inference/serving.py with
kernels/paged_attention.py and quantization/) against the JAX reference
engine ``paddle_tpu.inference.ServingEngine(attention="jax")`` on the
same weights (2 layers, hidden 32, 4 heads, vocab 97 — the reference's
tests/test_kv_quant.py and tests/test_quant_decode.py model).

The reference's Pallas kernel is no oracle under this JAX version
(ROADMAP C1), so the oracle is the reference engine's gather path: its
``gather_kv`` dequantizes a slot's pages, ``ragged_attn_one`` and the
prefill chunk's einsum attend over them.

Tolerances, and why:

- plain quantized attention against the gather formula rebuilt from the
  reference's jnp ops on the same codes and scales: 2e-5 (float32 sums
  in another order);
- engine against engine on the reference's own traffic, float32
  compute: greedy streams, counters and ``pool_bytes()`` exactly. After
  the run, every dequantized element within one step of its page's code
  grid (one int8 code, or one float8 spacing at its magnitude) times the
  scale, and at least 99.9% of the codes identical with float32 weights,
  99.5% with int8 weights: the K/V rows that enter the pages differ in
  the last bits between the two frameworks' products, which can move a
  code across a rounding boundary, and a moved code moves the rows
  computed from it. Every live page's scale within 1e-6 relative while
  every code agrees, and within 1/127 relative once a code has moved;
- the weight x KV matrix: every cell completes, verifies and repeats its
  own stream; cells with float32 compute (weights None or int8) over int8
  or fp8 pools give the reference's tokens; bf16-weight cells hold the
  decode-logit abs-max within 10% of the float32 engine's (the port's
  attention returns q's dtype, the reference's gather route float32:
  ROADMAP C10, so their bf16 streams may differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry
from paddle_tpu.quantization import kv as JKV
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.quantization import kv as TKV

torch.set_num_threads(2)

STATS = ("dispatches", "prefill_chunks", "decode_blocks", "prefix_hits",
         "cow_copies", "tokens_emitted", "fused_blocks", "steps")
CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, params_from_numpy(tree, "cpu")


def _engines(ref, **kw):
    m, params = ref
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_seq_len", 64)
    jeng = JaxEngine(m, attention="jax", cost_analysis=False,
                     registry=MetricsRegistry(), **kw)
    eng = ServingEngine(GPTConfig(**CFG), params, device="cpu", **kw)
    return jeng, eng


# -- the plain quantized attention against the reference's gather path ------

def _quant_pools(rng, fmt, NP=13, PS=8, NH=4, HD=16):
    mag = 10.0 ** rng.uniform(-2, 1, (NP, 1, NH, 1))
    kf = (rng.randn(NP, PS, NH, HD) * mag).astype(np.float32)
    vf = (rng.randn(NP, PS, NH, HD) * mag[::-1]).astype(np.float32)
    kq, ks = TKV.quantize_per_page(torch.from_numpy(kf), dtype=fmt)
    vq, vs = TKV.quantize_per_page(torch.from_numpy(vf), dtype=fmt)
    return kq, vq, ks, vs


def _jax_codes(q):
    a = q.view(torch.uint8).numpy() if q.dtype == torch.float8_e4m3fn \
        else q.numpy()
    return jnp.asarray(a).view(jnp.float8_e4m3fn) \
        if q.dtype == torch.float8_e4m3fn else jnp.asarray(a)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_plain_decode_rows_match_the_reference_gather_path(fmt):
    """``ragged_attn_one`` (serving.py:837-846) over ``gather_kv``
    (:829-835) under ``jax.vmap``, rebuilt from its jnp ops."""
    rng = np.random.RandomState(0)
    kq, vq, ks, vs = _quant_pools(rng, fmt)
    S, NH, HD, PS, MP = 4, 4, 16, 8, 3
    q = rng.randn(S, NH, HD).astype(np.float32)
    bt = rng.permutation(np.arange(1, 13))[:S * MP].reshape(S, MP) \
        .astype(np.int32)
    n_valid = np.array([17, 1, 24, 9], np.int32)
    T = MP * PS
    jk, jv = _jax_codes(kq), _jax_codes(vq)
    jks, jvs = jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())

    def one(qs, btr, n):
        k = JKV.dequantize_per_page(jk[btr], jks[btr]).reshape(T, NH, HD)
        v = JKV.dequantize_per_page(jv[btr], jvs[btr]).reshape(T, NH, HD)
        s = jnp.einsum("hd,thd->ht", qs, k) * (1.0 / HD ** 0.5)
        s = jnp.where(jnp.arange(T)[None, :] < n, s, -1e30)
        return jnp.einsum("ht,thd->hd", jax.nn.softmax(s, axis=-1), v)

    want = np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(bt),
                                    jnp.asarray(n_valid)))
    got = pa.paged_decode_attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(bt),
        torch.from_numpy(n_valid), k_scale=ks, v_scale=vs).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_plain_prefill_rows_match_the_reference_chunk_einsum(fmt):
    """The prefill chunk's attention (serving.py:1018-1025): C rows at
    positions base..base+C-1 over the gathered, dequantized slot, row j
    attending positions <= base + j — the ragged row with q_len = C and
    kv_len = base + C."""
    rng = np.random.RandomState(1)
    kq, vq, ks, vs = _quant_pools(rng, fmt)
    NH, HD, PS, MP, C, base = 4, 16, 8, 3, 8, 11
    q = rng.randn(C, NH, HD).astype(np.float32)
    bt = np.array([5, 2, 9], np.int32)
    T = MP * PS
    k = JKV.dequantize_per_page(_jax_codes(kq)[bt], jnp.asarray(
        ks.numpy())[bt]).reshape(T, NH, HD)
    v = JKV.dequantize_per_page(_jax_codes(vq)[bt], jnp.asarray(
        vs.numpy())[bt]).reshape(T, NH, HD)
    pos = base + jnp.arange(C)
    s = jnp.einsum("qhd,thd->qht", jnp.asarray(q), k) * (1.0 / HD ** 0.5)
    s = jnp.where(jnp.arange(T)[None, None, :] <= pos[:, None, None], s,
                  -1e30)
    want = np.asarray(jnp.einsum("qht,thd->qhd", jax.nn.softmax(s, -1), v))
    got = pa.ragged_paged_attention(
        torch.from_numpy(q)[None], kq, vq, torch.from_numpy(bt)[None],
        torch.tensor([base + C], dtype=torch.int32),
        torch.tensor([C], dtype=torch.int32), k_scale=ks,
        v_scale=vs)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_version_takes_both_scales_or_neither():
    kq, vq, ks, vs = _quant_pools(np.random.RandomState(2), "int8")
    q = torch.zeros(1, 1, 4, 16)
    bt = torch.ones(1, 3, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    for kw in (dict(k_scale=ks), dict(v_scale=vs), {}):
        with pytest.raises(ValueError):
            pa.ragged_paged_attention(q, kq, vq, bt, lens, lens, **kw)
    with pytest.raises(ValueError):   # scales over a float pool
        pa.ragged_paged_attention(q, kq.float(), vq.float(), bt, lens, lens,
                                  k_scale=ks, v_scale=vs)


# -- engine against engine on the reference's own traffic --------------------

def _traffic(kind):
    if kind == "mixed":            # tests/test_kv_quant.py:156-159
        rng = np.random.RandomState(3)
        return [(rng.randint(0, 97, int(rng.randint(3, 18))),
                 int(rng.randint(4, 14))) for _ in range(5)], \
            dict(num_slots=3), False
    if kind == "straddle":         # tests/test_kv_quant.py:220-243
        rng = np.random.RandomState(17)
        return [(rng.randint(0, 97, 10), 6), (rng.randint(0, 97, 17), 5)], \
            dict(page_size=12, prefill_chunk=8, max_seq_len=24), False
    prompt = np.arange(1, 25)      # :201-217, fully cached re-admission
    return [(prompt, 8), (prompt, 8)], {}, True


def _run(eng, reqs, serial):
    """Serve ``reqs``; ``serial`` drains the engine between requests (the
    second copy of a cached prompt re-admits through copy-on-write)."""
    uids, done = [], {}
    for p, n in reqs:
        uids.append(eng.add_request(p, n))
        if serial:
            done.update(eng.run(max_steps=500))
    done.update(eng.run(max_steps=2000))
    return [done[u].tokens for u in uids]


def _code_step(mag, fmt):
    """The spacing of the code grid at code magnitude ``mag``: 1 for
    int8; for float8 e4m3 (3 mantissa bits) 2^(e - 3) in the binade
    [2^e, 2^(e+1)), and 2^-9 among the subnormals below 2^-6."""
    if fmt == "int8":
        return np.ones_like(mag)
    e = np.floor(np.log2(np.maximum(mag, 2.0 ** -6)))
    return 2.0 ** (e - 3)


def _np_pool(t):
    return np.asarray(t.astype(jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


@pytest.mark.parametrize("kind", ["mixed", "straddle", "cow"])
@pytest.mark.parametrize("kv_dtype,weight_dtype", [
    ("int8", None), ("fp8", None), ("int8", "int8"), ("fp8", "int8")])
def test_engine_matches_the_reference_engine(ref, kind, kv_dtype,
                                             weight_dtype):
    reqs, kw, serial = _traffic(kind)
    jeng, eng = _engines(ref, kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                         **kw)
    assert _run(eng, reqs, serial) == _run(jeng, reqs, serial)
    for key in STATS:
        assert eng.stats[key] == jeng.stats[key], key
    if kind == "cow":
        assert eng.stats["cow_copies"] == 1
        assert eng.stats["prefix_hits"] > 0
    assert eng.kv.pool_bytes() == jeng.kv.pool_bytes()
    eng.kv.verify()
    jeng.kv.verify()
    pairs = [(p[li], jp[li], sc[li].numpy()[1:], np.asarray(jsc[li])[1:])
             for p, jp, sc, jsc in (
                 (eng.kv.k, jeng.kv.k, eng.kv.k_scale, jeng.kv.k_scale),
                 (eng.kv.v, jeng.kv.v, eng.kv.v_scale, jeng.kv.v_scale))
             for li in range(2)]
    codes_same = codes_all = 0
    for pool, jpool, s, js in pairs:
        # page 0 is the trash page: duplicate writes land there
        c, jc = _np_pool(pool)[1:], _np_pool(jpool)[1:]
        d, jd = c * s[:, None, :, None], jc * js[:, None, :, None]
        mag = np.maximum(np.abs(c), np.abs(jc))
        # one code step at the larger scale, plus the codes' share of the
        # two scales' difference
        bound = _code_step(mag, kv_dtype) * np.maximum(s, js)[
            :, None, :, None] + mag * np.abs(s - js)[:, None, :, None]
        assert np.all(np.abs(d - jd) <= bound * (1 + 1e-6))
        codes_same += int((c == jc).sum())
        codes_all += c.size
    # int8 weights: the reference's products over the widened weights
    # round otherwise than torch's, and a moved code reaches the later
    # rows (0.17% of the codes measured moved, each by one step, in the
    # fp8 copy-on-write cell, with identical tokens)
    assert codes_same >= (0.999 if weight_dtype is None else 0.995) \
        * codes_all
    # While every code agrees, the scales agree to the last bits of the
    # rows that set them. A code that crossed a rounding boundary moves
    # its value by one step, and with it the later layers' rows and the
    # abs-max they set: then a scale may move by a fraction of a step
    # (4.8e-5 relative measured for int8, 3.6e-4 for fp8, with int8
    # weights and the copy-on-write re-admission).
    rtol = 1e-6 if codes_same == codes_all else 1 / TKV.QMAX
    for _, _, s, js in pairs:
        np.testing.assert_allclose(s, js, rtol=rtol, atol=0)


def test_active_slots_write_distinct_private_pages(ref):
    """Every decode dispatch writes each active slot's next positions into
    pages no other slot writes and no other sequence holds (refcount 1),
    and every prefill chunk writes only its slot's private pages: the
    quantized write's duplicate page indices can only be the trash
    page's. Traffic with a shared prefix and a fully cached prompt."""
    _, params = ref
    eng = ServingEngine(GPTConfig(**CFG), params, device="cpu", num_slots=3,
                        page_size=8, prefill_chunk=8, max_seq_len=64,
                        kv_dtype="int8")
    fns, kv, PS = eng._fns, eng.kv, 8
    seen = {"decode": 0, "prefill": 0}

    def check_decode(k, bt, lengths, active):
        owners = {}
        for s in np.nonzero(active.numpy())[0]:
            for t in range(int(lengths[s]) - 1, int(lengths[s]) - 1 + k):
                page = int(bt[s, min(t, bt.shape[1] * PS - 1) // PS])
                if page == 0:
                    continue
                assert owners.setdefault(page, s) == s, page
                assert kv._ref[page] == 1, page
        seen["decode"] += 1

    def decode_step(params, kp, vp, ks, vs, bt, lengths, tokens, active,
                    *rest):
        check_decode(1, bt, lengths, active)
        return step(params, kp, vp, ks, vs, bt, lengths, tokens, active,
                    *rest)

    def decode_block(K, params, kp, vp, ks, vs, bt, lengths, tokens,
                     active, *rest, **kw):
        check_decode(K, bt, lengths, active)
        return block(K, params, kp, vp, ks, vs, bt, lengths, tokens, active,
                     *rest, **kw)

    def prefill(params, kp, vp, ks, vs, bt_row, base, tok_chunk, last):
        for t in range(base, base + 8):
            page = int(bt_row[t // PS])
            assert page == 0 or kv._ref[page] == 1, page
        seen["prefill"] += 1
        return pf(params, kp, vp, ks, vs, bt_row, base, tok_chunk, last)

    step, block, pf = fns.decode_step, fns.decode_block, fns.prefill
    fns.decode_step, fns.decode_block, fns.prefill = \
        decode_step, decode_block, prefill
    rng = np.random.RandomState(5)
    shared = rng.randint(0, 97, 16)
    reqs = [(np.concatenate([shared, rng.randint(0, 97, n)]), m)
            for n, m in ((3, 20), (9, 12), (0, 15))]
    _run(eng, reqs[:1], True)
    _run(eng, reqs[1:] + [(shared, 10), (rng.randint(0, 97, 5), 30)], False)
    assert eng.stats["cow_copies"] >= 1 and eng.stats["prefix_hits"] > 0
    assert seen["decode"] > 0 and seen["prefill"] > 0
    kv.verify()


# -- the weight x KV matrix (tests/test_quant_decode.py:274-303) -------------

def _stream(eng):
    rng = np.random.RandomState(3)
    uids = [eng.add_request(rng.randint(0, 97, int(rng.randint(3, 14))), 8)
            for _ in range(4)]
    done = eng.run(max_steps=2000)
    eng.kv.verify()
    return [done[u].tokens for u in uids]


def _port(ref, **kw):
    return ServingEngine(GPTConfig(**CFG), ref[1], device="cpu",
                         num_slots=2, page_size=8, prefill_chunk=8,
                         max_seq_len=64, record_logits=True, **kw)


def _decode_absmax(eng):
    return max(float(lg.abs().max()) for log in eng.logit_log.values()
               for lg in log[1:])


@pytest.fixture(scope="module")
def f32_absmax(ref):
    eng = _port(ref)
    _stream(eng)
    return _decode_absmax(eng)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("weight_dtype", [None, "bf16", "int8"])
def test_weight_by_kv_matrix(ref, f32_absmax, weight_dtype, kv_dtype):
    toks = []
    for _ in range(2):
        eng = _port(ref, weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        toks.append(_stream(eng))
        assert all(len(t) == 8 for t in toks[-1])
        assert _decode_absmax(eng) == pytest.approx(f32_absmax, rel=0.10)
    assert toks[0] == toks[1]                      # self-deterministic
    if weight_dtype != "bf16" and kv_dtype != "bf16":
        jeng = JaxEngine(ref[0], attention="jax", cost_analysis=False,
                         registry=MetricsRegistry(), num_slots=2,
                         page_size=8, prefill_chunk=8, max_seq_len=64,
                         weight_dtype=weight_dtype, kv_dtype=kv_dtype)
        assert toks[0] == _stream(jeng)
