"""Dense KV-cache generation of the PyTorch port
(``paddle_tpu_torch.models.gpt``: ``make_layer_core``'s ``step_layer``
and ``prefill_layer``, ``GPTForCausalLM.generate``, ``gpt2_medium``, and
``tools/bench_generate.py``) against the JAX reference on the CPU, on
``gpt2_tiny`` built after ``paddle.seed(0)`` with dropout 0, its weights
carried across by name with ``load_reference_state``.

Tolerances: the layer math at float32 within 1e-5 (sums run in another
order in the two frameworks); greedy streams token for token at float32;
at bf16 the two frameworks round at other places, so streams are held
token for token up to the first position whose top-2 logit margin is
below one bf16 step (the port's own bf16 logits decide where)."""
import json
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gen_params,
                                         gpt2_tiny, make_layer_core)
from paddle_tpu_torch.tools import bench_generate

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(seed=0, **kw):
    kw.setdefault("dropout", 0.0)
    paddle.seed(seed)
    ref = jgpt.gpt2_tiny(**kw)
    ref.eval()
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    port.eval()
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(b, n, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, n))


def _jax_generate(ref, ids, **kw):
    return np.asarray(ref.generate(paddle.to_tensor(ids), **kw).numpy())


def _core_pair(ref):
    jp = jgpt._gen_params(ref)
    tp = tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jcore = jgpt._make_layer_core(ref.gpt.cfg, jgpt._model_kinds(ref),
                                  ref.gpt.ln_f._epsilon)
    return jp, tp, jcore, make_layer_core(gpt2_tiny())


def test_prefill_layer_matches_the_reference(pair):
    ref, _ = pair
    jp, tp, jcore, core = _core_pair(ref)
    x = np.random.RandomState(1).randn(3, 11, 64).astype(np.float32)
    jx, jk, jv = jcore.prefill_layer(jp["layers"][1], ("dense", None, None),
                                     x)
    tx, tk, tv = core.prefill_layer(tp["layers"][1], torch.from_numpy(x))
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [0, 5, 15])
def test_step_layer_matches_the_reference(pair, t):
    ref, _ = pair
    jp, tp, jcore, core = _core_pair(ref)
    rng = np.random.RandomState(t)
    x = rng.randn(2, 64).astype(np.float32)
    kc = rng.randn(2, 16, 4, 16).astype(np.float32)
    vc = rng.randn(2, 16, 4, 16).astype(np.float32)
    jx, jk, jv = jcore.step_layer(jp["layers"][0], ("dense", None, None), x,
                                  kc, vc, t)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tx, tk2, tv2 = core.step_layer(tp["layers"][0], torch.from_numpy(x), tk,
                                   tv, torch.tensor(t))
    assert tk2 is tk and tv2 is tv      # written in place
    for got, want in ((tx, jx), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,prompt,new", [(2, 7, 0), (3, 7, 1), (2, 12, 5),
                                          (3, 95, 33)],
                         ids=["new0", "new1", "new5", "to_the_table"])
def test_greedy_generate_is_the_reference_token_for_token(pair, b, prompt,
                                                           new):
    ref, port = pair
    ids = _ids(b, prompt, seed=new)
    want = _jax_generate(ref, ids, max_new_tokens=new)
    got = port.generate(ids, max_new_tokens=new)
    assert got.dtype == torch.int64 and tuple(got.shape) == (b, prompt + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_one_sampling_is_greedy(pair):
    _, port = pair
    ids = _ids(2, 9, seed=3)
    greedy = port.generate(ids, max_new_tokens=12)
    for seed in (0, 7):
        np.testing.assert_array_equal(
            port.generate(ids, max_new_tokens=12, temperature=1.0, top_k=1,
                          seed=seed).numpy(), greedy.numpy())
    # sampling draws from the seed's generator: fixed by the seed
    a = port.generate(ids, max_new_tokens=12, temperature=1.0, top_k=5,
                      seed=4)
    b = port.generate(ids, max_new_tokens=12, temperature=1.0, top_k=5,
                      seed=4)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(a, greedy)


def test_overflow_raises_and_approx_topk_is_refused(pair):
    _, port = pair
    with pytest.raises(ValueError, match="exceeds max_position_embeddings"):
        port.generate(_ids(1, 100), max_new_tokens=29)
    with pytest.raises(NotImplementedError):
        port.generate(_ids(1, 5), max_new_tokens=2, temperature=1.0,
                      top_k=4, use_approx_topk=True)


def test_updated_weights_are_seen_between_calls():
    ref_a, port = _pair(seed=0)
    ref_b, _ = _pair(seed=5)
    ids = _ids(2, 10, seed=2)
    np.testing.assert_array_equal(port.generate(ids, max_new_tokens=8)
                                  .numpy(),
                                  _jax_generate(ref_a, ids, max_new_tokens=8))
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref_b.named_parameters()})
    np.testing.assert_array_equal(port.generate(ids, max_new_tokens=8)
                                  .numpy(),
                                  _jax_generate(ref_b, ids, max_new_tokens=8))
    # one program per shape: the second call replayed the first's
    assert len(port._gen_programs) == 1


def _bf16_step(x):
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def test_bf16_streams_match_up_to_a_bf16_tie(pair):
    ref, port = pair
    ids = _ids(3, 9, seed=6)
    want = _jax_generate(ref, ids, max_new_tokens=24, dtype="bfloat16")
    got = port.generate(ids, max_new_tokens=24, dtype="bfloat16").numpy()
    # the port's own bf16 logits over its stream decide where a tie is
    core = make_layer_core(port.gpt.cfg)
    p = tgpt.tree_map(lambda a: a.to(torch.bfloat16), gen_params(port))
    x = p["wte"][torch.from_numpy(got)] + p["wpe"][:got.shape[1]][None]
    for lay in p["layers"]:
        x, _, _ = core.prefill_layer(lay, x)
    logits = (core.ln(x, *p["lnf"]) @ p["wte"].T).float()
    held = 0
    for r in range(3):
        for i in range(9, got.shape[1]):
            top2 = torch.topk(logits[r, i - 1], 2).values
            if float(top2[0] - top2[1]) < _bf16_step(float(top2[0])):
                break
            assert got[r, i] == want[r, i], (r, i)
            held += 1
    assert held >= 24


def test_gpt2_medium_is_the_reference_config(monkeypatch):
    # the reference's gpt2_medium builds a model: keep only its config
    monkeypatch.setattr(jgpt, "GPTForCausalLM", lambda cfg: cfg)
    want = jgpt.gpt2_medium(vocab_size=50304)
    got = tgpt.gpt2_medium(vocab_size=50304)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_position_embeddings", "intermediate_size",
                  "layer_norm_epsilon", "dropout", "bf16_residual"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.num_layers, got.hidden_size, got.num_heads) == (24, 1024, 16)
    from paddle_tpu_torch.models import gpt2_medium
    assert gpt2_medium is tgpt.gpt2_medium


def test_bench_generate_prints_the_reference_keys(capsys):
    assert bench_generate.main(["--model", "tiny", "--device", "cpu",
                                "--batch", "2", "--new-tokens", "40",
                                "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "batch", "seq",
                "ms_per_token_step"):
        assert key in line, key
    assert line["metric"] == "gpt2_tiny_decode_tokens_per_sec_per_chip"
    assert line["batch"] == 2 and line["seq"] == 72
    assert line["approx_topk"] is False and line["device"] == "cpu"
    assert line["value"] > 0
