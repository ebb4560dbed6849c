"""GPT-2 math of the PyTorch port (paddle_tpu_torch/models/gpt.py and
the serving programs of paddle_tpu_torch/inference/serving.py) against
the JAX reference on the reference's own weights, carried across with
``params_from_numpy(_gen_params(model))``:

- the layer core (``ln``, ``qkv_proj``, ``attn_out``, dense
  ``mlp_tail``) against ``paddle_tpu.models.gpt._make_layer_core``;
- the prefill-chunk program against the reference's jitted
  ``prefill_chunk_fn`` (gather attention), logits and written pools;
- the decode step against the reference's dense-cache ``step_layer``
  (logits) and its paged ``decode_step`` (greedy tokens, pools).

Tolerances: float32 on both sides; logits at rtol 1e-4 / atol 1e-5
(sums run in another order in the two frameworks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.serving import _build_serving_fns as jax_build
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import (GPTForCausalLM, _gen_params,
                                   _make_layer_core, _model_kinds)
from paddle_tpu_torch.inference.serving import _build_serving_fns
from paddle_tpu_torch.models.gpt import (GPTConfig, gpt2_small, gpt2_tiny,
                                         init_params, make_layer_core,
                                         params_from_numpy)

# tiny shapes: a few threads are plenty, and the suite runs several
# workers at once beside timing-sensitive tests
torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
S, PS, MP, C = 2, 8, 8, 8


@pytest.fixture(scope="module")
def ref():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        max_position_embeddings=128, dropout=0.0))
    m.eval()
    jparams = _gen_params(m)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    kinds = _model_kinds(m)
    jcore = _make_layer_core(m.gpt.cfg, kinds, m.gpt.ln_f._epsilon)
    params = params_from_numpy(tree, "cpu")
    core = make_layer_core(gpt2_tiny(), eps=m.gpt.ln_f._epsilon)
    return dict(m=m, jparams=jparams, tree=tree, kinds=kinds, jcore=jcore,
                params=params, core=core)


def _np(t):
    return t.detach().cpu().numpy()


def test_params_from_numpy_keeps_the_reference_tree(ref):
    tree, params = ref["tree"], ref["params"]
    assert set(params) == {"wte", "wpe", "lnf", "layers"}
    assert len(params["layers"]) == len(tree["layers"]) == 2
    lay, jlay = params["layers"][1], tree["layers"][1]
    for key in ("ln1", "ln2", "qkv", "proj", "mlp"):
        assert isinstance(lay[key], tuple)
        for a, b in zip(lay[key], jlay[key]):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(_np(a), b)
    bf = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert bf["wte"].dtype == torch.bfloat16


def test_layer_core_matches_jax(ref):
    core, jcore = ref["core"], ref["jcore"]
    lay_t, lay_j = ref["params"]["layers"][0], ref["jparams"]["layers"][0]
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    o = rng.randn(3, 5, 64).astype(np.float32)
    xt, ot = torch.from_numpy(x), torch.from_numpy(o)
    np.testing.assert_allclose(
        _np(core.ln(xt, *lay_t["ln1"])),
        np.asarray(jcore.ln(jnp.asarray(x), *lay_j["ln1"])),
        rtol=RTOL, atol=ATOL)
    for a, b in zip(core.qkv_proj(lay_t, xt),
                    jcore.qkv_proj(lay_j, jnp.asarray(x))):
        assert tuple(a.shape) == b.shape == (3, 5, 4, 16)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(
        _np(core.attn_out(lay_t, xt, ot)),
        np.asarray(jcore.attn_out(lay_j, jnp.asarray(x), jnp.asarray(o))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        _np(core.mlp_tail(lay_t, xt)),
        np.asarray(jcore.mlp_tail(lay_j, ("dense", None, None),
                                  jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def _both_programs(ref):
    jprogs = jax_build(ref["jcore"], ref["kinds"], num_slots=S,
                       page_size=PS, pages_per_slot=MP, prefill_chunk=C,
                       attention="jax", interpret=True)
    progs = _build_serving_fns(ref["core"], num_slots=S, page_size=PS,
                               pages_per_slot=MP, prefill_chunk=C,
                               attention="auto", device=torch.device("cpu"))
    NP = S * MP + 1
    shape = (NP, PS, 4, 16)
    jk = [jnp.zeros(shape, jnp.float32) for _ in range(2)]
    jv = [jnp.zeros(shape, jnp.float32) for _ in range(2)]
    tk = [torch.zeros(shape) for _ in range(2)]
    tv = [torch.zeros(shape) for _ in range(2)]
    bt = np.zeros((S, MP), np.int32)
    bt[0] = np.arange(1, MP + 1)
    bt[1] = np.arange(MP + 1, 2 * MP + 1)
    return jprogs, progs, [jk, jv], [tk, tv], bt


def _prefill_both(ref, jprogs, progs, jpools, tpools, bt, prompts):
    """Chunked prefill of each slot's prompt through both programs;
    returns the per-slot last-chunk logits (jax, torch)."""
    out = []
    for slot, prompt in enumerate(prompts):
        P = len(prompt)
        pf_end = -(-P // C) * C
        toks = np.zeros(pf_end, np.int32)
        toks[:P] = prompt
        for base in range(0, pf_end, C):
            last = P - 1 - base if base <= P - 1 < base + C else 0
            chunk = toks[base:base + C]
            (jpools[0], jpools[1], _, _, jl) = jprogs.prefill(
                ref["jparams"], jpools[0], jpools[1], (), (),
                jnp.asarray(bt[slot]), base, jnp.asarray(chunk), last)
            tl = progs.prefill(ref["params"], tpools[0], tpools[1], (), (),
                               torch.from_numpy(bt[slot].copy()), base,
                               torch.from_numpy(chunk.astype(np.int64)),
                               last)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=RTOL,
                                       atol=ATOL)
        out.append((np.asarray(jl), _np(tl)))
    return out


def test_prefill_chunks_match_jax_program(ref):
    jprogs, progs, jpools, tpools, bt = _both_programs(ref)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, 19), rng.randint(0, 128, 11)]
    _prefill_both(ref, jprogs, progs, jpools, tpools, bt, prompts)
    for layer in range(2):
        for kind in range(2):
            np.testing.assert_allclose(
                _np(tpools[kind][layer]), np.asarray(jpools[kind][layer]),
                rtol=RTOL, atol=ATOL)


def test_decode_step_matches_jax_dense_step_and_paged_step(ref):
    jprogs, progs, jpools, tpools, bt = _both_programs(ref)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 128, 19), rng.randint(0, 128, 11)]
    firsts = _prefill_both(ref, jprogs, progs, jpools, tpools, bt, prompts)
    tok0 = np.array([int(np.argmax(j)) for j, _ in firsts], np.int64)
    lengths = np.array([len(p) + 1 for p in prompts], np.int64)
    active = np.ones(S, bool)
    temps = np.zeros(S, np.float32)
    # the reference's dense-cache decode of the same position, per slot
    T = MP * PS
    jcore, jp = ref["jcore"], ref["jparams"]
    dense_logits = []
    for s in range(S):
        t = int(lengths[s] - 1)
        x = jp["wte"][tok0[s:s + 1]] + jp["wpe"][t]
        for li, lay in enumerate(jp["layers"]):
            kc = jpools[0][li][bt[s]].reshape(1, T, 4, 16)
            vc = jpools[1][li][bt[s]].reshape(1, T, 4, 16)
            x, _, _ = jcore.step_layer(lay, ("dense", None, None), x, kc,
                                       vc, t)
        dense_logits.append(np.asarray(jcore.ln(x, *jp["lnf"])
                                       @ jp["wte"].T)[0])
    nxt, lg32 = progs.decode_step(
        ref["params"], tpools[0], tpools[1], (), (), torch.from_numpy(bt),
        torch.from_numpy(lengths), torch.from_numpy(tok0),
        torch.from_numpy(active), torch.from_numpy(temps), None)
    np.testing.assert_allclose(_np(lg32), np.stack(dense_logits),
                               rtol=RTOL, atol=ATOL)
    (jk, jv, _, _, jnxt, _) = jprogs.decode_step(
        jp, jpools[0], jpools[1], (), (), jnp.asarray(bt),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(tok0.astype(np.int32)), jnp.asarray(active),
        jnp.asarray(temps), jnp.zeros((S, 2), jnp.uint32))
    np.testing.assert_array_equal(_np(nxt), np.asarray(jnxt))
    for layer in range(2):
        np.testing.assert_allclose(_np(tpools[0][layer]),
                                   np.asarray(jk[layer]), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_np(tpools[1][layer]),
                                   np.asarray(jv[layer]), rtol=RTOL,
                                   atol=ATOL)


def test_inactive_slots_write_only_the_trash_page(ref):
    _, progs, _, tpools, bt = _both_programs(ref)
    lengths = torch.tensor([5, 9])
    progs.decode_step(ref["params"], tpools[0], tpools[1], (), (),
                      torch.from_numpy(bt), lengths, torch.tensor([3, 4]),
                      torch.tensor([False, False]), torch.zeros(S), None)
    for pools in tpools:
        for pool in pools:
            assert torch.count_nonzero(pool[1:]) == 0


def test_init_params_is_seeded_and_shaped():
    cfg = gpt2_tiny()
    a, b = init_params(cfg, seed=3, device="cpu"), \
        init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    torch.testing.assert_close(a["wte"], b["wte"], rtol=0, atol=0)
    assert not torch.equal(a["wte"], c["wte"])
    assert tuple(a["wte"].shape) == (128, 64)
    assert tuple(a["wpe"].shape) == (128, 64)
    assert tuple(a["layers"][0]["qkv"][0].shape) == (64, 192)
    assert tuple(a["layers"][0]["mlp"][2].shape) == (256, 64)
    small = gpt2_small()
    assert (small.num_layers, small.hidden_size, small.num_heads,
            small.vocab_size) == (12, 768, 12, 50304)


def test_moe_config_is_refused():
    with pytest.raises(NotImplementedError):
        GPTConfig(num_experts=4)
