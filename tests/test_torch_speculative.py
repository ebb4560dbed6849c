"""Speculative decoding of the PyTorch port
(``ServingEngine(speculative=, draft_k=)``,
paddle_tpu_torch/inference/speculative.py and ``sampler.spec_accept``)
against the JAX reference (paddle_tpu/inference/speculative.py,
``paddle_tpu.inference.sampler.spec_accept``) on the reference's own
traffic (tests/test_speculative.py): its tiny model (vocab 97, hidden 32,
2 layers, 4 heads, 64 positions), the draft ``truncate_draft(·, 1)``,
pages and chunks of 8, 3 slots. The JAX engines gather their attention
(``attention="jax"``): the Pallas ragged kernel is no oracle under this
JAX version (ROADMAP C1).

- ``spec_accept``: the greedy chain and accepted count equal the
  reference's with proposals matching at no, some and all positions;
  sampled, 80 000 rounds on the port's generators with proposals drawn
  from q give a first token distributed as ``softmax(p0 / t)``;
- greedy streams of the spec engine, per phase and mixed, equal the JAX
  plain engine's and the JAX spec engine's (an EOS in mid-round
  included), and its round and dispatch counters equal the JAX spec
  engine's;
- randomized accept/reject stress keeps ``kv.verify()`` clean after
  every step and after ``close()``; the prefix cache and copy-on-write,
  preemption and resume and migration between engines (greedy and
  sampled: the draft generator is carried, ROADMAP C16) and int8 pools
  compose with speculation; fixed
  seeds give the same sampled streams; the constructor's validation.

Engines run on the CPU here, eagerly; captured spec engines are held to
eager ones on the card (tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.inference import sampler as jax_sampler
from paddle_tpu.inference import truncate_draft as jax_truncate_draft
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM, _gen_params
from paddle_tpu.observability import MetricsRegistry
from paddle_tpu_torch.inference import sampler, truncate_draft
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy

torch.set_num_threads(2)

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           max_position_embeddings=64)
KW = dict(page_size=8, prefill_chunk=8, max_seq_len=64)
SPEC = ("spec_rounds", "spec_proposed", "spec_accepted", "spec_rejected",
        "dispatches", "prefill_chunks")


@pytest.fixture(scope="module")
def ref():
    """The reference's ``_tiny()`` and ``truncate_draft(model, 1)``, and
    the target's weights as the port's parameter dict."""
    paddle.seed(0)
    m = GPTForCausalLM(JaxGPTConfig(dropout=0.0, **CFG))
    m.eval()
    tree = jax.tree_util.tree_map(np.asarray, _gen_params(m))
    return m, jax_truncate_draft(m, 1), params_from_numpy(tree, "cpu")


def _jax(ref, spec=False, **kw):
    kw.setdefault("num_slots", 3)
    if spec:
        kw.update(speculative=ref[1], draft_k=4)
    return JaxEngine(ref[0], attention="jax", cost_analysis=False,
                     registry=MetricsRegistry(), **dict(KW, **kw))


def _port(ref, spec=False, **kw):
    kw.setdefault("num_slots", 3)
    if spec:
        kw.update(speculative=1, draft_k=4)
    return ServingEngine(GPTConfig(**CFG), ref[2], device="cpu",
                         **dict(KW, **kw))


# -- spec_accept ---------------------------------------------------------------

def test_spec_accept_greedy_chain_matches_the_reference():
    """temp = 0, proposals matching the target's argmax at none, two and
    all of the k positions, batched over those three slots: the chain
    (padding included) and ``n_acc`` equal the reference's."""
    rng = np.random.RandomState(0)
    k, V = 4, 12
    pl = rng.randn(3, k + 1, V).astype(np.float32) * 2
    ql = rng.randn(3, k, V).astype(np.float32)
    tgt = pl.argmax(-1)
    prop = np.stack([(tgt[0, :k] + 1) % V,
                     [tgt[1, 0], tgt[1, 1], (tgt[1, 2] + 1) % V, tgt[1, 3]],
                     tgt[2, :k]]).astype(np.int64)
    chain, n_acc = sampler.spec_accept(
        torch.from_numpy(pl), torch.from_numpy(ql), torch.from_numpy(prop),
        torch.zeros(3))
    assert n_acc.tolist() == [0, 2, k]
    for s in range(3):
        want, want_n = jax_sampler.spec_accept(
            jax.numpy.asarray(pl[s]), jax.numpy.asarray(ql[s]),
            jax.numpy.asarray(prop[s].astype(np.int32)),
            jax.numpy.float32(0.0), jax.random.PRNGKey(s))
        assert chain[s].tolist() == np.asarray(want).tolist()
        assert int(n_acc[s]) == int(want_n)
    # the uniforms and the correction's noise do not move a greedy row
    chain2, n2 = sampler.spec_accept(
        torch.from_numpy(pl), torch.from_numpy(ql), torch.from_numpy(prop),
        torch.zeros(3), torch.rand(3, k), torch.randn(3, V))
    assert torch.equal(chain, chain2) and torch.equal(n_acc, n2)


def test_spec_accept_distribution_exact():
    """temp > 0 with proposals drawn from the draft's distribution (as the
    engine draws them): 80 000 rounds on the port's generators, the first
    emitted token's frequencies within 3.5 sigma + 1e-4 of softmax(p0/t)
    (the reference's ``test_spec_accept_distribution_exact``), both
    acceptance outcomes exercised."""
    rng = np.random.RandomState(1)
    k, V, n, t = 3, 8, 80_000, 0.8
    pl = torch.from_numpy(rng.randn(k + 1, V).astype(np.float32) * 2)
    ql = pl[:k] + torch.from_numpy(rng.randn(k, V).astype(np.float32))
    gen = torch.Generator().manual_seed(2)
    g_draft = sampler.gumbel_noise((n, k, V), gen, "cpu")
    prop = torch.argmax(ql / t + g_draft, -1)               # drawn from q
    u = torch.rand(n, k, generator=gen)
    g = sampler.gumbel_noise((n, V), gen, "cpu")
    chain, n_acc = sampler.spec_accept(
        pl.expand(n, k + 1, V), ql.expand(n, k, V), prop,
        torch.full((n,), t), u, g)
    emp = np.bincount(chain[:, 0].numpy(), minlength=V) / n
    want = torch.softmax(pl[0] / t, -1).numpy()
    sigma = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(emp - want) < 3.5 * sigma + 1e-4), \
        np.max(np.abs(emp - want))
    assert 0.0 < n_acc.float().mean() / k < 1.0


# -- engines -------------------------------------------------------------------

def _parity_reqs(ref):
    """tests/test_speculative.py ``test_greedy_spec_vs_plain_token_parity``:
    four random requests and one whose EOS is its 4th greedy token."""
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 97, int(rng.randint(3, 18))),
             int(rng.randint(6, 16)), None) for _ in range(4)]
    p_eos = rng.randint(0, 97, 6)
    eng = _port(ref)
    u = eng.add_request(p_eos, 12)
    reqs.append((p_eos, 12, int(eng.run()[u].tokens[3])))
    return reqs


def _serve(eng, reqs):
    uids = [eng.add_request(p, n, eos_id=e) for p, n, e in reqs]
    done = eng.run(max_steps=4000)
    eng.kv.verify()
    return ([done[u].tokens for u in uids],
            [done[u].finish_reason for u in uids])


@pytest.mark.parametrize("mixed", [False, True])
def test_greedy_spec_matches_the_jax_engines(ref, mixed):
    reqs = _parity_reqs(ref)
    jplain, jspec, spec = (_jax(ref, mixed_step=mixed),
                           _jax(ref, True, mixed_step=mixed),
                           _port(ref, True, mixed_step=mixed))
    want = _serve(jplain, reqs)
    assert _serve(jspec, reqs) == want
    assert _serve(spec, reqs) == want
    assert "eos" in want[1]
    for key in SPEC:
        assert spec.stats[key] == jspec.stats[key], key
    assert spec.stats["spec_rounds"] > 0
    assert spec.stats["mixed_steps"] == jspec.stats["mixed_steps"]


@pytest.mark.parametrize("mixed", [False, True])
def test_rollback_stress_keeps_the_pool_verified(ref, mixed):
    """tests/test_speculative.py ``test_rollback_page_leak_stress``: a
    tight pool (preemption live), EOS ids, priorities, a zero deadline and
    a cancel; ``verify()`` after every step and after ``close()``."""
    eng = _port(ref, True, num_pages=17, mixed_step=mixed)
    rng = np.random.RandomState(11)
    uids = []
    for wave in range(3):
        for _ in range(4):
            kw = {}
            if rng.rand() < 0.3:
                kw["eos_id"] = int(rng.randint(0, 97))
            if rng.rand() < 0.2:
                kw["priority"] = int(rng.randint(0, 3))
            uids.append(eng.add_request(
                rng.randint(0, 97, int(rng.randint(3, 20))),
                int(rng.randint(2, 14)), **kw))
        if wave == 1:
            eng.add_request(rng.randint(0, 97, 8), 4, deadline_s=0.0)
            eng.cancel(uids[-1])
        steps = 0
        while eng.has_work and steps < 2000:
            eng.step()
            eng.kv.verify()
            steps += 1
        assert not eng.has_work
    assert eng.stats["spec_rounds"] > 0
    assert eng.stats["spec_rejected"] > 0
    assert not eng.close()
    eng.kv.verify()
    assert eng.kv.num_in_use == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_prefix_cache_and_cow_under_spec(ref, mixed):
    """``test_prefix_cache_cow_parity_under_spec``: a shared prefix, then a
    prompt of whole pages served twice (the second clones its last page
    into the target's and the draft's pools): tokens equal the plain
    engine's."""
    prefix = np.arange(1, 17)
    tails = [np.array([40, 41, 42]), np.array([50, 51])]

    def run(spec):
        eng = _port(ref, spec, num_slots=2, mixed_step=mixed)
        outs = []
        for tail in tails:
            u = eng.add_request(np.concatenate([prefix, tail]), 8)
            outs.append(eng.run(max_steps=1000)[u].tokens)
        full = np.arange(1, 25)
        for _ in range(2):
            u = eng.add_request(full, 8)
            outs.append(eng.run(max_steps=1000)[u].tokens)
        eng.kv.verify()
        return outs, eng.stats

    plain, _ = run(False)
    spec, stats = run(True)
    assert spec == plain
    assert stats["cow_copies"] >= 1 and stats["prefix_hits"] > 0
    assert stats["spec_rounds"] > 0


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempt_resume_under_spec(ref, mixed, temperature):
    """``test_preempt_resume_parity_under_spec``: a request preempted by a
    higher-priority arrival on a pool too small for both resumes from the
    prefix cache; its tokens equal an unpreempted spec run's, greedy and
    sampled (the target's and the draft's generator states carried,
    ROADMAP C16). The arrival comes after 3 steps, not the reference's 6:
    on this model the request emits its 20 tokens within 6 steps, in the
    JAX engine too, and nothing is left to preempt."""
    kw = dict(temperature=temperature, seed=7)
    eng = _port(ref, True, num_slots=2, num_pages=9, mixed_step=mixed)
    rng = np.random.RandomState(1)
    p_low = rng.randint(1, 97, 12)
    u_low = eng.add_request(p_low, 20, priority=0, **kw)
    for _ in range(3):
        eng.step()
    assert len(eng._slots[0].out) > 1
    eng.add_request(rng.randint(1, 97, 20), 20, priority=5)
    done = eng.run(max_steps=10_000)
    eng.kv.verify()
    assert eng.stats["preemptions"] >= 1
    assert done[u_low].preemptions >= 1
    alone = _port(ref, True, num_slots=2, mixed_step=mixed)
    u = alone.add_request(p_low, 20, **kw)
    assert done[u_low].tokens == alone.run(max_steps=10_000)[u].tokens
    if temperature:
        assert len(set(done[u_low].tokens)) > 1     # it really sampled


@pytest.mark.parametrize("mixed", [False, True])
def test_eject_and_admit_migrated_under_spec(ref, mixed):
    """A sampled request ejected mid-decode from one spec engine and
    admitted by another continues the same stream: the Request carries
    both generator states."""
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 97, 10)
    kw = dict(temperature=0.8, seed=9)
    alone = _port(ref, True, mixed_step=mixed)
    u = alone.add_request(prompt, 24, **kw)
    want = alone.run()[u].tokens
    src, dst = (_port(ref, True, mixed_step=mixed) for _ in range(2))
    u = src.add_request(prompt, 24, **kw)
    while not src._slots or len(src._slots[0].out) < 6:
        src.step()
    req = src.eject(u)
    assert req.resume_key is not None and req.resume_draft_key is not None
    assert not src.has_work and src.kv.num_in_use == 0
    v = dst.admit_migrated(req)
    assert dst.run()[v].tokens == want
    assert len(set(want)) > 1


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kv_dtype,weight_dtype", [
    ("int8", None), ("fp8", None), ("int8", "int8"), (None, "int8")])
def test_spec_over_quantized_pools_and_weights(ref, kv_dtype, weight_dtype,
                                               mixed):
    """``test_spec_with_int8_kv``, and the same over fp8 pools and with
    int8 weights (the draft takes the target's weight lever): greedy spec
    tokens equal the JAX spec engine's, plain ones the JAX plain engine's,
    and spec ones the plain ones wherever the JAX engines' do. Over int8
    pools they do (the reference's empirical pin). Over fp8 pools, mixed,
    they part in both frameworks alike: a rejected tail's write
    requantizes a page the accepted tokens share, the reference's own
    caveat (``speculative.py:36-44``)."""
    rng = np.random.RandomState(13)
    reqs = [(rng.randint(0, 97, int(rng.randint(3, 14))),
             int(rng.randint(6, 14)), None) for _ in range(4)]
    kw = dict(kv_dtype=kv_dtype, weight_dtype=weight_dtype,
              mixed_step=mixed)
    spec, plain = _serve(_port(ref, True, **kw), reqs), \
        _serve(_port(ref, **kw), reqs)
    jspec, jplain = _serve(_jax(ref, True, **kw), reqs), \
        _serve(_jax(ref, **kw), reqs)
    assert spec == jspec and plain == jplain
    assert (spec == plain) == (jspec == jplain)
    if kv_dtype == "int8":
        assert spec == plain


@pytest.mark.parametrize("mixed", [False, True])
def test_fixed_seed_sampled_spec_streams_repeat(ref, mixed):
    """``test_sampled_fixed_seed_bit_parity``: the same seeds give the same
    sampled streams through the whole chain (draft proposals, uniforms,
    corrections)."""
    def run():
        eng = _port(ref, True, num_slots=2, mixed_step=mixed)
        rng = np.random.RandomState(3)
        u1 = eng.add_request(rng.randint(0, 97, 7), 14, temperature=1.0,
                             seed=11)
        u2 = eng.add_request(rng.randint(0, 97, 5), 10, temperature=0.7,
                             seed=5)
        done = eng.run(max_steps=2000)
        return (done[u1].tokens, done[u2].tokens,
                eng.stats["spec_rounds"], eng.stats["spec_rejected"])

    a = run()
    assert a == run()
    assert a[2] > 0 and a[3] > 0


def test_spec_validation(ref):
    with pytest.raises(ValueError, match="draft_k"):
        _port(ref, speculative=1, draft_k=0)
    assert _port(ref, speculative=False).spec is None
    other = GPTConfig(**dict(CFG, vocab_size=64, num_layers=1))
    from paddle_tpu_torch.models.gpt import init_params
    with pytest.raises(ValueError, match="vocab"):
        _port(ref, speculative=(other, init_params(other, device="cpu")))
    short = GPTConfig(**dict(CFG, max_position_embeddings=32, num_layers=1))
    with pytest.raises(ValueError, match="position table"):
        _port(ref, speculative=(short, init_params(short, device="cpu")))
    with pytest.raises(ValueError, match="num_layers"):
        truncate_draft(GPTConfig(**CFG), ref[2], 5)
    with pytest.raises(ValueError, match="num_layers"):
        truncate_draft(GPTConfig(**CFG), ref[2], 0)
    # the truncated weights are the target's, copied, and equal the JAX
    # draft's
    dcfg, d = truncate_draft(GPTConfig(**CFG), ref[2], 1)
    assert dcfg.num_layers == 1 and len(d["layers"]) == 1
    assert d["wte"].data_ptr() != ref[2]["wte"].data_ptr()
    want = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _gen_params(ref[1])), "cpu")
    flat = lambda t: jax.tree_util.tree_leaves(   # noqa: E731
        jax.tree_util.tree_map(lambda x: x.numpy(), t))
    for a, b in zip(flat(d), flat(want)):
        np.testing.assert_array_equal(a, b)
    assert truncate_draft(GPTConfig(**CFG), ref[2])[0].num_layers == 1
    eng = _port(ref, speculative=True)
    assert eng.spec.cfg.num_layers == 1 and eng.spec.k == 4
