"""Tensor-parallel serving of the PyTorch port
(``ServingEngine(mesh=make_mesh(2), kv_shard=, collective_dtype=)``,
paddle_tpu_torch/inference/tp.py) against the JAX reference's
(paddle_tpu/inference/tp.py) on the reference's own cases
(tests/test_tp_serving.py): its tiny model (vocab 97, hidden 32, 2
layers, 4 heads, 64 positions), pages and chunks of 8, 3 slots, and the
shared ``_mixed_stream`` replay (greedy and fixed-seed sampled requests).

One rank set of two ``gloo`` processes on the CPU
(``distributed.spawn``; the rank function lives in tests/tp_ranks.py,
which imports no JAX) serves every sharded engine of the module in turn,
so the suite spawns once. The JAX engines gather their attention
(``attention="jax"``): the Pallas kernel on a mesh is no oracle under
this JAX version (ROADMAP C1).

- token identity: the port at mp = 2 (heads-sharded pools) emits the
  JAX single-chip engine's and the JAX ``mesh=make_mesh(2)`` engine's
  greedy streams, and exactly the port's own mp = 1 engine's streams,
  sampled ones included (the port's PRNG is its own); the same with
  replicated pools, int8 KV pools, int8 weights, the mixed step,
  speculation (per-phase, heads and replicated) and through the
  preempt/resume drill; ``record_logits`` within 1e-5 of the logits'
  max-abs of the mp = 1 engine's (float32 round-off), and within 2e-2
  of the JAX model's forward over the same tokens (the JAX engines keep
  no logits; the port's single-card engine sits 0.6-0.8% of max-abs
  from that forward on this model too);
- the counted collective census equals the ledger's closed form per
  position (``2 * 2 * 32 * 4`` bytes under heads; doubled, with the K/V
  all-gather, under replicated pools; ``2 * L * mp * (H + 4)`` under the
  int8 collective) for the decode step, the prefill chunk and one step
  of the fused block; the phase totals are exact and the per-tenant
  attribution conserves;
- the int8 collective's logit error, recorded in
  ``serving_quant_logit_err`` beside the JAX int8 mesh engine's;
- mp = 1 is the single-card engine; the validation errors; a follower's
  failure reaches the leader, naming its rank.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import truncate_draft as jax_truncate_draft
from paddle_tpu.inference.tp import make_mesh as jax_make_mesh
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.distributed.spawn import spawn
from paddle_tpu_torch.inference.serving import (ServingEngine,
                                                record_quant_logit_err)
from paddle_tpu_torch.inference.tp import Mesh, TPContext, make_mesh
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry

import tp_ranks

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
LOGIT_TOL = 1e-5      # of the logits' max-abs: float32 round-off
JAX_FORWARD_TOL = 2e-2   # of max-abs, against the JAX model's forward

# the sharded engines of the rank set, in order
SCENARIOS = [
    ("heads", {"traffic": "mixed", "engine": {"record_logits": True}}),
    ("replicated", {"traffic": "mixed",
                    "engine": {"kv_shard": "replicated"}}),
    ("int8_kv", {"traffic": "mixed", "args": {"n": 5},
                 "engine": {"kv_dtype": "int8"}}),
    ("int8_kv_replicated", {"traffic": "mixed", "args": {"n": 5},
                            "engine": {"kv_dtype": "int8",
                                       "kv_shard": "replicated"}}),
    ("w8", {"traffic": "mixed", "engine": {"weight_dtype": "int8"}}),
    ("mixed_step", {"traffic": "mixed", "engine": {"mixed_step": True}}),
    ("spec", {"traffic": "mixed", "args": {"n": 5, "seed": 3},
              "engine": {"speculative": 1, "draft_k": 3}}),
    ("spec_replicated", {"traffic": "mixed", "args": {"n": 5, "seed": 3},
                         "engine": {"speculative": 1, "draft_k": 3,
                                    "kv_shard": "replicated"}}),
    ("preempt", {"traffic": "preempt", "engine": {"num_pages": 9}}),
    ("census", {"traffic": "census", "engine": {"decode_block": 4}}),
    ("census_replicated", {"traffic": "census",
                           "engine": {"decode_block": 4,
                                      "kv_shard": "replicated"}}),
    ("census_int8", {"traffic": "census",
                     "engine": {"decode_block": 4,
                                "collective_dtype": "int8"}}),
    ("int8_coll", {"traffic": "mixed",
                   "engine": {"collective_dtype": "int8",
                              "record_logits": True}}),
]


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    return m


@pytest.fixture(scope="module")
def tree(model):
    return jax.tree_util.tree_map(np.asarray, _gen_params(model))


@pytest.fixture(scope="module")
def ranks(tree):
    """Every sharded engine's record, from one two-rank set."""
    recs = spawn(tp_ranks.serve, (CFG, tree, [sc for _, sc in SCENARIOS]),
                 nprocs=2, device="cpu")[0]
    return {name: rec for (name, _), rec in zip(SCENARIOS, recs)}


def _port(tree, **kw):
    kw = dict(dict(tp_ranks.KW, num_slots=3, registry=MetricsRegistry()),
              **kw)
    return ServingEngine(GPTConfig(**CFG), params_from_numpy(tree, "cpu"),
                         device="cpu", **kw)


def _jax(model, **kw):
    kw = dict(dict(tp_ranks.KW, num_slots=3, registry=JaxRegistry()), **kw)
    return JaxEngine(model, attention="jax", cost_analysis=False, **kw)


def _drive(eng, traffic="mixed", **args):
    res = tp_ranks.TRAFFIC[traffic](eng, **args)
    eng.close()
    return res


@pytest.fixture(scope="module")
def port_mp1(tree):
    """The port's own single-rank engines on the same traffic."""
    out = {}
    for name, kw, args in (
            ("plain", {"record_logits": True}, {}),
            ("int8_kv", {"kv_dtype": "int8"}, {"n": 5}),
            ("w8", {"weight_dtype": "int8"}, {}),
            ("mixed_step", {"mixed_step": True}, {}),
            ("spec", {"speculative": 1, "draft_k": 3}, {"n": 5, "seed": 3})):
        eng = _port(tree, **kw)
        out[name] = tp_ranks.mixed_stream(eng, **args)
        if name == "plain":
            out["logits"] = {u: [t.numpy() for t in lg]
                             for u, lg in eng.logit_log.items()}
        eng.close()
    out["solo"] = _drive(_port(tree, num_slots=1), "solo")[0]
    return out


@pytest.fixture(scope="module")
def jax_ref(model):
    """The JAX engines' streams: single-chip and mp = 2 on the shared
    replay, int8 pools and speculation single-chip."""
    out = {"single": _drive(_jax(model)),
           "mesh": _drive(_jax(model, mesh=jax_make_mesh(2))),
           "int8_kv": _drive(_jax(model, kv_dtype="int8"), n=5),
           "spec": _drive(_jax(model, speculative=jax_truncate_draft(
               model, 1), draft_k=3), n=5, seed=3)}
    return out


def _greedy(toks, n=8):
    """The greedy requests of ``mixed_stream`` (even uids)."""
    return {u: t for u, t in toks.items() if u % 2 == 0 and u < n}


# -- token identity ------------------------------------------------------------

def test_mp2_heads_token_identity(ranks, port_mp1, jax_ref):
    rec = ranks["heads"]
    assert rec["chips"] == 2 and rec["stats"]["backend"] == "gloo"
    assert _greedy(rec["tokens"]) == _greedy(jax_ref["single"])
    assert _greedy(rec["tokens"]) == _greedy(jax_ref["mesh"])
    assert jax_ref["single"] == jax_ref["mesh"]
    assert rec["tokens"] == port_mp1["plain"]
    # this rank's pool holds its half of the heads
    assert rec["pool_shape"] == (25, 8, 2, 8)
    assert rec["fingerprint"]["chips"] == 2


@pytest.mark.parametrize("name,ref", [
    ("replicated", "plain"), ("int8_kv", "int8_kv"),
    ("int8_kv_replicated", "int8_kv"), ("w8", "w8"),
    ("mixed_step", "plain"), ("spec", "spec"), ("spec_replicated", "spec")])
def test_mp2_parity(ranks, port_mp1, jax_ref, name, ref):
    """Every sharded variant emits the port's mp = 1 streams exactly and
    the JAX engine's greedy streams."""
    rec = ranks[name]
    assert rec["tokens"] == port_mp1[ref]
    jref = {"plain": "single", "int8_kv": "int8_kv", "spec": "spec",
            "w8": None}[ref]
    if jref is not None:
        n = 5 if ref in ("int8_kv", "spec") else 8
        assert _greedy(rec["tokens"], n) == _greedy(jax_ref[jref], n)
    if name.startswith("spec"):
        assert rec["stats"]["spec_rounds"] > 0
        heads = 4 if "replicated" in name else 2
        assert rec["draft_pool_shape"][2] == heads   # follows kv_shard
    if "replicated" in name:
        assert rec["pool_shape"][2] == 4
        if rec["scale_shape"] is not None:
            assert rec["scale_shape"] == (25, 4)
    elif name == "int8_kv":
        assert rec["scale_shape"] == (25, 2)


def test_mp2_preempt_resume_parity(ranks, port_mp1):
    """The preempt/resume drill on the mesh: the sampled victim resumes
    to its solo mp = 1 stream (the generator state carried)."""
    rec = ranks["preempt"]
    assert rec["stats"]["preemptions"] >= 1
    assert rec["preemptions"] >= 1
    assert rec["tokens"][0] == port_mp1["solo"][0]


def test_record_logits_agree(ranks, port_mp1, model):
    """The mp = 2 engine's logits against the mp = 1 engine's (within
    LOGIT_TOL of max-abs) and the JAX model's forward over the same
    tokens (greedy requests; JAX_FORWARD_TOL, the single-card port's own
    gap to that forward)."""
    rec = ranks["heads"]
    rng = np.random.RandomState(0)
    prompts = []
    for i in range(8):
        plen = int(rng.choice([3, 8, 17, 30]))
        rng.choice([2, 5, 9, 16])
        prompts.append(rng.randint(0, 97, plen))
    worst = 0.0
    for u, lgs in rec["logits"].items():
        one = port_mp1["logits"][u]
        assert len(one) == len(lgs)
        for a, b in zip(lgs, one):
            scale = float(np.abs(b).max())
            assert float(np.abs(a - b).max()) <= LOGIT_TOL * scale
        if u % 2:
            continue
        toks = rec["tokens"][u]
        seq = np.concatenate([prompts[u], np.asarray(toks[:-1])])
        full = np.asarray(model(paddle.to_tensor(seq[None])).numpy())[0]
        P = len(prompts[u])
        for i, a in enumerate(lgs):
            b = full[P - 1 + i]
            err = float(np.abs(a - b).max()) / float(np.abs(b).max())
            worst = max(worst, err)
    print(f"record_logits vs the JAX forward: worst {worst:.3g} of max-abs")
    assert worst <= JAX_FORWARD_TOL


def test_mp1_mesh_is_the_single_card_engine(tree, port_mp1):
    eng = _port(tree, mesh=make_mesh(1))
    assert eng.tp is None and eng.chips == 1
    assert tp_ranks.mixed_stream(eng) == port_mp1["plain"]
    assert eng.ledger.coll_bytes_per_position == 0
    assert sum(eng.ledger.totals()["coll_bytes"].values()) == 0
    assert eng.xla_costs == {}
    eng.close()


# -- the collective census -----------------------------------------------------

@pytest.mark.parametrize("name,per_pos,ops", [
    ("census", 2 * 2 * 32 * 4, {"all-reduce"}),
    ("census_replicated", 2 * 2 * 2 * 32 * 4, {"all-reduce", "all-gather"}),
    ("census_int8", 2 * 2 * 2 * (32 + 4), {"all-gather"})])
def test_census_equals_prediction(ranks, name, per_pos, ops):
    """Counted == predicted for the decode step (S positions), the
    prefill chunk (C) and one step of the fused block (S); the phase
    totals exact; the per-tenant attribution conserves."""
    rec = ranks[name]
    S, C = rec["num_slots"], rec["prefill_chunk"]
    assert rec["coll_bytes_per_position"] == per_pos
    for fn, positions in (("decode_step", S), ("prefill_chunk", C),
                          ("decode_block", S)):
        cost = rec["xla_costs"][fn]
        assert cost["collective_bytes"] == per_pos * positions, fn
        assert set(cost["collective_by_op"]) == ops, fn
    coll = rec["totals"]["coll_bytes"]
    chunks = rec["stats"]["prefill_chunks"]
    assert coll["prefill"] == chunks * C * per_pos
    assert coll["decode"] > 0 and coll["decode"] % (S * per_pos) == 0
    assert rec["summary"]["collective_bytes_total"] == sum(coll.values())
    assert 0 < rec["summary"]["mbu_per_chip"] < rec["summary"]["mbu"]
    assert rec["summary"]["mp"] == 2
    assert rec["attribution"]["conserved"]
    attributed = sum(sum(t.values()) for t in rec["tenant_coll"].values())
    assert attributed == sum(coll.values())


def test_replicated_pool_ledger_constants(ranks):
    heads, rep = ranks["heads"], ranks["replicated"]
    assert rep["coll_bytes_per_position"] == \
        2 * heads["coll_bytes_per_position"]
    assert rep["kv_bytes_per_token_chip"] == rep["kv_bytes_per_token"]
    assert heads["kv_bytes_per_token_chip"] == \
        pytest.approx(heads["kv_bytes_per_token"] / 2)


def test_spec_draft_collectives_priced(ranks):
    coll = ranks["spec"]["totals"]["coll_bytes"]
    assert coll["spec_draft"] > 0 and coll["spec_verify"] > 0
    costs = ranks["spec"]["xla_costs"]
    # the draft (1 layer) pays half the target's pair a position
    assert costs["spec_propose"]["collective_bytes"] == 3 * 1 * 2 * 32 * 4


def _jax_tp_forward(model, collective_dtype):
    """The JAX reference's tensor-parallel forward over one whole
    sequence on ``make_mesh(2)``: its ``TPContext.qkv_proj`` and, under
    ``collective_dtype="int8"``, its ``attn_out_q`` / ``mlp_tail_q``
    (the quantized collective ``qar``), with the layer core the serving
    programs use. Returns ``ids -> logits [P, V]`` (numpy)."""
    import jax.numpy as jnp
    from paddle_tpu.inference.tp import TPContext as JaxTP
    from paddle_tpu.models.gpt import _make_layer_core, _model_kinds
    tp = JaxTP(jax_make_mesh(2), model, collective_dtype=collective_dtype)
    kinds = _model_kinds(model)
    core = _make_layer_core(model.gpt.cfg, kinds, model.gpt.ln_f._epsilon)
    params = tp.prepare_params(_gen_params(model))
    q8 = collective_dtype == "int8"

    @jax.jit
    def fwd(params, ids):
        P = ids.shape[0]
        x = params["wte"][ids] + params["wpe"][:P]
        causal = jnp.tril(jnp.ones((P, P), bool))[None]
        for lay, kind in zip(params["layers"], kinds):
            q, k, v = tp.qkv_proj(core, lay, core.ln(x, *lay["ln1"]))
            sc = jnp.einsum("qhd,khd->hqk", q, k) * core.scale
            p = jax.nn.softmax(jnp.where(causal, sc, -1e30), axis=-1)
            o = jnp.einsum("hqk,khd->qhd", p, v).reshape(P, core.H)
            if q8:
                x = tp.attn_out_q(core, lay, x, o)
                x = tp.mlp_tail_q(core, lay, kind, x)
            else:
                x = core.mlp_tail(lay, kind, core.attn_out(lay, x, o))
        return core.ln(x, *params["lnf"]) @ params["wte"].T
    return lambda ids: np.asarray(fwd(params, jnp.asarray(ids)))


def _mixed_prompts(n=8, seed=0):
    """``mixed_stream``'s prompts, drawn as it draws them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rng.choice([3, 8, 17, 30]))
        rng.choice([2, 5, 9, 16])
        out.append(rng.randint(0, 97, plen))
    return out


def _rel(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def test_int8_collective_against_the_jax_int8_mesh(ranks, model):
    """The port's int8 collective (``qar``: one float32 scale per rank
    and position, the dequantized partials summed in float32) against
    the JAX reference's on ``make_mesh(2)``, on the greedy requests of
    the shared replay:

    - its logits against the JAX int8 forward over the same tokens:
      both quantize the same partials, so only float32 round-off parts
      them (``LOGIT_TOL`` of max-abs), except after round-off has moved
      a partial across an int8 rounding boundary: one code of one
      partial moves by a step, its scale (max-abs / 127), and every
      later step that attends that position moves with it, by up to
      ``INT8_FLIP_TOL`` of max-abs. At least ``INT8_EXACT`` of the
      steps are held to round-off, all of them to ``INT8_FLIP_TOL``
      (on this replay 42 of 50 steps sit at 1e-7 to 4e-7, and one
      request's last 8 at 1.3e-3 to 5.7e-3 after one flip). A scale per
      tensor instead of per position, or partials summed in bfloat16,
      would move every step;
    - its greedy tokens equal the JAX int8 mesh engine's up to the first
      top-2 margin below ``INT8_TIE`` of max-abs;
    - its error against the port's f32 collective (max-abs of the
      difference over max-abs, the tokens agreeing) within a factor
      ``INT8_ERR_FACTOR`` of the JAX int8 forward's against the JAX f32
      forward on the same tokens; published as
      ``serving_quant_logit_err{lever="collective_int8"}``."""
    INT8_FLIP_TOL, INT8_EXACT, INT8_TIE, INT8_ERR_FACTOR = \
        1e-2, 0.75, 1e-2, 1.25
    q8, f32 = ranks["int8_coll"], ranks["heads"]
    jax8 = _drive(_jax(model, mesh=jax_make_mesh(2),
                       collective_dtype="int8"))
    fwd8, fwd32 = _jax_tp_forward(model, "int8"), \
        _jax_tp_forward(model, "f32")
    prompts = _mixed_prompts()
    gaps, err, jax_err, compared = [], 0.0, 0.0, 0
    for u in _greedy(q8["tokens"]):
        toks, lgs = q8["tokens"][u], q8["logits"][u]
        for i, row in enumerate(lgs):       # tokens up to a near-tie
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] < INT8_TIE * float(np.abs(row).max()):
                break
            assert toks[i] == jax8[u][i], (u, i)
            compared += 1
        seq = np.concatenate([prompts[u], np.asarray(toks[:-1])])
        P = len(prompts[u])
        ref8, ref32 = fwd8(seq)[P - 1:], fwd32(seq)[P - 1:]
        gaps += [_rel(a, ref8[i]) for i, a in enumerate(lgs)]
        for i, (a, b) in enumerate(zip(lgs, f32["logits"][u])):
            if toks[:i] != f32["tokens"][u][:i]:
                break
            err = max(err, _rel(a, b))
            jax_err = max(jax_err, _rel(ref8[i], ref32[i]))
    exact = sum(g <= LOGIT_TOL for g in gaps) / len(gaps)
    print(f"int8 collective: port vs JAX int8 forward: {exact:.3g} of "
          f"{len(gaps)} steps within round-off, worst {max(gaps):.3g} of "
          f"max-abs; error vs f32: port {err:.4g}, JAX {jax_err:.4g}; "
          f"{compared} greedy tokens compared")
    assert compared >= 20
    assert exact >= INT8_EXACT and max(gaps) <= INT8_FLIP_TOL
    assert jax_err / INT8_ERR_FACTOR <= err <= jax_err * INT8_ERR_FACTOR
    reg = MetricsRegistry()
    assert record_quant_logit_err(reg, "collective_int8", err) == err
    assert reg.get("serving_quant_logit_err").labels(
        lever="collective_int8").value == err


# -- validation and failures ---------------------------------------------------

def test_mesh_validation_errors(tree):
    cfg = GPTConfig(**CFG)
    with pytest.raises(ValueError, match="divide num_heads"):
        _port(tree, mesh=Mesh(3, 0))
    with pytest.raises(ValueError, match="kv_shard"):
        _port(tree, mesh=Mesh(2, 0), kv_shard="nope")
    with pytest.raises(ValueError, match="collective_dtype"):
        _port(tree, mesh=Mesh(2, 0), collective_dtype="fp8")
    with pytest.raises(ValueError, match="needs a mesh"):
        _port(tree, collective_dtype="int8")
    with pytest.raises(ValueError, match="MoE"):
        TPContext(Mesh(2, 0), type("C", (), dict(
            num_experts=2, num_heads=4, intermediate_size=128))())
    with pytest.raises(ValueError):
        make_mesh(0)
    with pytest.raises(ValueError):
        make_mesh(1 << 20)      # more ranks than this process's world
    with pytest.raises(TypeError, match="make_mesh"):
        TPContext(object(), cfg)


def test_follower_failure_fails_the_leader(tree):
    """A follower whose third program run raises: the leader's next
    collective breaks and it raises the follower's error, naming rank 1;
    the rank set's failure names both ranks, the follower first."""
    sc = {"traffic": "mixed", "args": {"n": 2}, "fail_follower_at": 3}
    with pytest.raises(RuntimeError) as e:
        spawn(tp_ranks.serve, (CFG, tree, [sc]), nprocs=2, device="cpu",
              timeout=60)
    msg = str(e.value)
    assert "rank 1" in msg and "injected follower failure" in msg
    assert "mesh follower(s) failed: rank 1" in msg
    assert msg.index("--- rank 1 ---") < msg.index("--- rank 0 ---")


# -- with no processes ---------------------------------------------------------

@pytest.mark.parametrize("weights", ["f32", "bf16", "int8"])
def test_prepare_params_shards_concatenate_back(tree, weights):
    """Each rank's Megatron shard (its q, k and v columns, proj rows,
    fc_in columns, fc_out rows; an int8 artifact's scales cut with their
    columns) put back together is the full tree, bit for bit."""
    from paddle_tpu_torch.quantization.weights import (
        cast_params, params_nbytes, quantize_weights_int8)
    cfg = GPTConfig(**CFG)
    full = params_from_numpy(tree, "cpu")
    full = {"f32": lambda p: p, "bf16": cast_params,
            "int8": quantize_weights_int8}[weights](full)
    shards = [TPContext(Mesh(2, r), cfg).prepare_params(full)
              for r in range(2)]
    H, hl = 32, 16

    def leaves(x):
        return x if isinstance(x, tuple) else (x,)

    def cat(parts, dim):
        return torch.cat(parts, dim)
    for li, lay in enumerate(full["layers"]):
        sl = [s["layers"][li] for s in shards]
        for i, want in enumerate(leaves(lay["qkv"][0])):
            got = [leaves(s["qkv"][0])[i] for s in sl]
            back = torch.cat([torch.cat([g[..., j * hl:(j + 1) * hl]
                                         for g in got], -1)
                              for j in range(3)], -1)
            assert torch.equal(back, want)
        bq = [s["qkv"][1] for s in sl]
        assert torch.equal(torch.cat([torch.cat(
            [b[j * hl:(j + 1) * hl] for b in bq]) for j in range(3)]),
            lay["qkv"][1])
        assert torch.equal(cat([leaves(s["proj"][0])[0] for s in sl], 0),
                           leaves(lay["proj"][0])[0])
        assert torch.equal(cat([leaves(s["mlp"][0])[0] for s in sl], -1),
                           leaves(lay["mlp"][0])[0])
        assert torch.equal(cat([s["mlp"][1] for s in sl], -1),
                           lay["mlp"][1])
        assert torch.equal(cat([leaves(s["mlp"][2])[0] for s in sl], 0),
                           leaves(lay["mlp"][2])[0])
        if weights == "int8":
            assert torch.equal(cat([s["mlp"][0][1] for s in sl], -1),
                               lay["mlp"][0][1])
            for s in sl:      # row cuts keep the per-column scales whole
                assert s["proj"][0][1] is lay["proj"][0][1]
                assert s["mlp"][2][1] is lay["mlp"][2][1]
        for s in sl:
            assert s["ln1"] is lay["ln1"] and s["mlp"][3] is lay["mlp"][3]
    for s in shards:
        assert s["wte"] is full["wte"] and s["wpe"] is full["wpe"]
    per_chip = TPContext(Mesh(2, 0), cfg).param_bytes_per_chip(full)
    assert per_chip == params_nbytes(shards[0]) < params_nbytes(full)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
def test_plain_version_head_offset_is_the_contiguous_slice(pool):
    """``ragged_paged_attention_ref(..., h0=)`` over pools of 4 heads
    equals the plain version on heads h0, h0 + 1 copied out (and their
    scales), for every offset."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.quantization.kv import quantize_per_page
    rng = np.random.RandomState(3)
    q = torch.tensor(rng.randn(4, 8, 2, 16), dtype=torch.float32)
    k = torch.tensor(rng.randn(17, 8, 4, 16), dtype=torch.float32)
    v = torch.tensor(rng.randn(17, 8, 4, 16), dtype=torch.float32)
    bt = torch.tensor(rng.permutation(np.arange(1, 17)).reshape(4, 4),
                      dtype=torch.int32)
    kl = torch.tensor([27, 8, 12, 0], dtype=torch.int32)
    ql = torch.tensor([1, 8, 4, 1], dtype=torch.int32)
    sc = {}
    if pool in ("int8", "fp8"):
        k, ks = quantize_per_page(k, dtype=pool)
        v, vs = quantize_per_page(v, dtype=pool)
        sc = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(getattr(torch, pool)), v.to(getattr(torch, pool))
    for h0 in range(3):
        got = pa.ragged_paged_attention(q, k, v, bt, kl, ql, h0=h0, **sc)
        cut = {n: t[:, h0:h0 + 2].contiguous() for n, t in sc.items()}
        want = pa.ragged_paged_attention_ref(
            q, pa.byte_view(k)[:, :, h0:h0 + 2].contiguous().view(k.dtype),
            pa.byte_view(v)[:, :, h0:h0 + 2].contiguous().view(v.dtype),
            bt, kl, ql, **cut)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="head offset"):
        pa._check(q, k, v, bt, kl, ql, *sc.values(), h0=3)


def test_c_entries_take_the_pool_heads_and_offset():
    """Each of the three C entries takes the pools' head count and the
    offset (``int PNH, int h0``) just before ``scale``, and binds with
    the argtypes the wrapper gives it (a pointer bound as an int would
    be cut to 32 bits)."""
    import ctypes
    import os
    import re
    from paddle_tpu_torch.kernels import paged_attention as pa
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "paddle_tpu_torch", "kernels", "csrc",
                             "paged_attention.cu")).read()
    for name, argtypes in (
            ("paged_attention_forward", pa.ARGTYPES),
            ("paged_attention_forward_split", pa.SPLIT_ARGTYPES),
            ("paged_attention_forward_split_quant",
             pa.SPLIT_QUANT_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                        re.S).group(1)
        params = [" ".join(p.split()) for p in sig.split(",")]
        assert params[-4:-2] == ["int PNH", "int h0"], name
        assert [ctypes.c_void_p if "*" in p else ctypes.c_float
                if p.startswith("float") else ctypes.c_int
                for p in params] == argtypes, name
    assert not re.search(r'extern "C" int \w*_heads\(', text)
