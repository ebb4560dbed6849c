"""Weight-only int8 of the PyTorch port
(paddle_tpu_torch/quantization/weights.py) against the JAX reference
(paddle_tpu/quantization/weights.py) on the ``_gen_params`` tree of a
tiny GPT (2 layers, hidden 32, 4 heads, vocab 97) and on a random MoE
expert stack.

Tolerance: none. Codes, scales, the dequantized weights (float32 and
bfloat16), the bf16 cast and the byte counts are bit-identical to the
reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM, _gen_params
from paddle_tpu.quantization import weights as J
from paddle_tpu_torch.models.gpt import params_from_numpy
from paddle_tpu_torch.quantization import weights as T

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trees():
    paddle.seed(0)
    m = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        max_position_embeddings=64, dropout=0.0))
    m.eval()
    jp = _gen_params(m)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _leaves(tree):
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_same_trees(jtree, ttree):
    jl, tl = jax.tree_util.tree_leaves(jtree), _leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert _np(b).shape == np.asarray(a).shape
        np.testing.assert_array_equal(_np(b), _np(a))


def test_int8_artifact_bit_identical(trees):
    jp, tp = trees
    jq, tq = J.quantize_weights_int8(jp), T.quantize_weights_int8(tp)
    _assert_same_trees(jq, tq)
    for lay in tq["layers"]:
        for slot in ("qkv", "proj"):
            q, s = lay[slot][0]
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert s.shape == (1, q.shape[1])          # per out-channel
    assert tq["wte"][1].shape == (tp["wte"].shape[0], 1)  # lm-head rows


def test_artifact_passes_norms_biases_and_wpe_by_reference(trees):
    _, tp = trees
    tq = T.quantize_weights_int8(tp)
    assert tq["wpe"] is tp["wpe"] and tq["lnf"] is tp["lnf"]
    for lay, qlay in zip(tp["layers"], tq["layers"]):
        assert qlay["ln1"] is lay["ln1"] and qlay["ln2"] is lay["ln2"]
        assert qlay["qkv"][1] is lay["qkv"][1]
        assert qlay["mlp"][1] is lay["mlp"][1]


def test_is_quantized_params(trees):
    _, tp = trees
    assert not T.is_quantized_params(tp)
    assert T.is_quantized_params(T.quantize_weights_int8(tp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_params_bit_identical(trees, dtype):
    jp, tp = trees
    jd = J.dequantize_params(J.quantize_weights_int8(jp),
                             getattr(jnp, dtype))
    td = T.dequantize_params(T.quantize_weights_int8(tp),
                             getattr(torch, dtype))
    _assert_same_trees(jd, td)
    assert td["wte"].dtype == getattr(torch, dtype)


def test_plain_tree_passes_through_dequantize(trees):
    _, tp = trees
    assert T.dequantize_params(tp) is tp


def test_requantizing_the_dequantized_artifact_is_the_identity(trees):
    _, tp = trees
    tq = T.quantize_weights_int8(tp)
    t2 = T.quantize_weights_int8(T.dequantize_params(tq))
    for a, b in zip(_leaves(tq), _leaves(t2)):
        if a.dtype == torch.int8:
            assert torch.equal(a, b)


def test_cast_params_bit_identical(trees):
    jp, tp = trees
    _assert_same_trees(J.cast_params(jp), T.cast_params(tp))
    assert all(t.dtype == torch.bfloat16
               for t in _leaves(T.cast_params(tp)))


def test_params_nbytes_equal_to_the_reference(trees):
    jp, tp = trees
    for jt, tt in ((jp, tp), (J.cast_params(jp), T.cast_params(tp)),
                   (J.quantize_weights_int8(jp),
                    T.quantize_weights_int8(tp))):
        assert T.params_nbytes(tt) == J.params_nbytes(jt)
    assert T.params_nbytes(T.quantize_weights_int8(tp)) < \
        0.40 * T.params_nbytes(tp)


def test_qw_per_expert_scales_bit_identical():
    """``expert_axis=0``: an [E, H, I] stack quantizes per (expert,
    out-channel), so a quiet expert keeps its own precision."""
    rng = np.random.RandomState(1)
    w = rng.randn(3, 16, 24).astype(np.float32)
    w[1] *= 0.01
    qj, sj = J._qw(jnp.asarray(w), -1, expert_axis=0)
    qt, st = T._qw(torch.from_numpy(w), -1, expert_axis=0)
    assert st.shape == (3, 1, 24)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    d = (qt.float() * st).numpy()
    for e in range(3):
        assert np.abs(d[e] - w[e]).max() <= np.abs(w[e]).max() / 254 * 1.01


def test_moe_layout_artifact_bit_identical():
    """The reference's MoE mlp tuple (gate, w1 [E,H,I], b1, w2 [E,I,H],
    b2) quantizes as the reference does."""
    rng = np.random.RandomState(2)
    E, H, I = 2, 8, 12

    def r(*s):
        return rng.randn(*s).astype(np.float32)
    lay = dict(ln1=(r(H), r(H)), ln2=(r(H), r(H)),
               qkv=(r(H, 3 * H), r(3 * H)), proj=(r(H, H), r(H)),
               mlp=(r(H, E), r(E, H, I), r(E, I), r(E, I, H), r(E, H)))
    tree = dict(wte=r(20, H), wpe=r(16, H), lnf=(r(H), r(H)), layers=[lay])
    jq = J.quantize_weights_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    tq = T.quantize_weights_int8(params_from_numpy(tree, "cpu"))
    _assert_same_trees(jq, tq)
    _assert_same_trees(J.dequantize_params(jq), T.dequantize_params(tq))
