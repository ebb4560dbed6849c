"""The transformer's incremental caches and the decoder stack of the
PyTorch port (``paddle_tpu_torch/nn/transformer.py``:
``MultiHeadAttention`` with ``Cache`` / ``StaticCache`` and
``gen_cache``, ``TransformerEncoder[Layer]`` with ``cache``,
``TransformerDecoderLayer``, ``TransformerDecoder`` with
``gen_cache(do_zip=)``, ``Transformer`` with
``generate_square_subsequent_mask``) against
``paddle_tpu.nn.layer.transformer`` on the CPU, the weights carried by
name (``load_named_state``), dropout 0.

Tolerances: float32 on both sides within 1e-5 (sums run in another order
in the two frameworks; the reference's attention is its XLA path, the
port's the plain flash forward with no mask and ``_sdpa_reference`` with
one). Stepwise cached decoding is held against the port's own full
forward under the square subsequent mask within 1e-5."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import (MultiHeadAttention, Transformer,
                                 TransformerDecoderLayer, TransformerEncoder,
                                 TransformerEncoderLayer)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
D, NH, FF = 32, 4, 64


def _carry(ref, port):
    nn.load_named_state(port, {n: np.asarray(p._array)
                                for n, p in ref.named_parameters()})
    ref.eval()
    port.eval()
    return ref, port


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jnp(t):
    return np.asarray(t.numpy(), np.float32)


def _pt(a):
    return paddle.to_tensor(a)


def test_parameter_names_match_the_reference():
    paddle.seed(0)
    ref = jnn.Transformer(D, NH, 2, 2, FF, dropout=0.0)
    port = Transformer(D, NH, 2, 2, FF, dropout=0.0, device="cpu")
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in ref.named_parameters()]


def test_multi_head_attention_caches_match():
    paddle.seed(0)
    ref, port = _carry(jnn.MultiHeadAttention(D, NH),
                       MultiHeadAttention(D, NH, device="cpu"))
    mem = _x(2, 6, D, seed=1)
    # StaticCache: the memory projected once, used as it is
    js = ref.gen_cache(_pt(mem), type=jnn.MultiHeadAttention.StaticCache)
    ts = port.gen_cache(torch.from_numpy(mem),
                        type=MultiHeadAttention.StaticCache)
    assert isinstance(ts, MultiHeadAttention.StaticCache)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(_np(a), _jnp(b), **TOL)
    # Cache: empty float32, grown by one step at a time
    jc = ref.gen_cache(_pt(mem))
    tc = port.gen_cache(torch.from_numpy(mem))
    assert tuple(tc.k.shape) == (2, 0, NH, D // NH)
    assert tc.k.dtype == torch.float32
    for step in range(3):
        q = _x(2, 1, D, seed=10 + step)
        jo, jc = ref(_pt(q), cache=jc)
        to, tc = port(torch.from_numpy(q), cache=tc)
        assert isinstance(tc, MultiHeadAttention.Cache)
        np.testing.assert_allclose(_np(to), _jnp(jo), **TOL)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(_np(a), _jnp(b), **TOL)
        jo, js2 = ref(_pt(q), _pt(mem), _pt(mem), cache=js)
        to, ts2 = port(torch.from_numpy(q), torch.from_numpy(mem),
                       torch.from_numpy(mem), cache=ts)
        assert ts2 is ts
        np.testing.assert_allclose(_np(to), _jnp(jo), **TOL)
    assert tuple(tc.k.shape) == (2, 3, NH, D // NH)
    # Cache(key, value) wraps what it is given
    given = port.gen_cache(tc.k, tc.v)
    assert given.k is tc.k and given.v is tc.v


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_with_cache_matches(normalize_before):
    paddle.seed(0)
    ref = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
        D, NH, FF, dropout=0.0, normalize_before=normalize_before), 2)
    port = TransformerEncoder(TransformerEncoderLayer(
        D, NH, FF, dropout=0.0, normalize_before=normalize_before,
        device="cpu"), 2)
    _carry(ref, port)
    src = _x(2, 5, D)
    np.testing.assert_allclose(_np(port(torch.from_numpy(src))),
                               _jnp(ref(_pt(src))), **TOL)
    jc = ref.gen_cache(_pt(src))
    tc = port.gen_cache(torch.from_numpy(src))
    for step in range(3):
        x = _x(2, 1, D, seed=step + 3)
        jo, jc = ref(_pt(x), cache=jc)
        to, tc = port(torch.from_numpy(x), cache=tc)
        np.testing.assert_allclose(_np(to), _jnp(jo), **TOL)
        assert len(tc) == 2
        for (a, b), (c, d) in zip(tc, jc):
            np.testing.assert_allclose(_np(a), _jnp(c), **TOL)
            np.testing.assert_allclose(_np(b), _jnp(d), **TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_and_transformer_match(normalize_before):
    paddle.seed(0)
    ref = jnn.Transformer(D, NH, 2, 2, FF, dropout=0.0,
                          normalize_before=normalize_before)
    port = Transformer(D, NH, 2, 2, FF, dropout=0.0,
                       normalize_before=normalize_before, device="cpu")
    _carry(ref, port)
    src, tgt = _x(2, 7, D, seed=1), _x(2, 5, D, seed=2)
    jmask = ref.generate_square_subsequent_mask(5)
    tmask = port.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(_np(tmask), _jnp(jmask))
    want = _jnp(ref(_pt(src), _pt(tgt), tgt_mask=jmask))
    got = _np(port(torch.from_numpy(src), torch.from_numpy(tgt),
                   tgt_mask=tmask))
    np.testing.assert_allclose(got, want, **TOL)
    # the decoder stepwise with its caches, against the reference's
    jmem = ref.encoder(_pt(src))
    tmem = port.encoder(torch.from_numpy(src))
    np.testing.assert_allclose(_np(tmem), _jnp(jmem), **TOL)
    jc = ref.decoder.gen_cache(jmem)
    tc = port.decoder.gen_cache(tmem)
    for i in range(5):
        jo, jc = ref.decoder(_pt(tgt[:, i:i + 1]), jmem, cache=jc)
        to, tc = port.decoder(torch.from_numpy(tgt[:, i:i + 1]), tmem,
                              cache=tc)
        np.testing.assert_allclose(_np(to), _jnp(jo), **TOL)
        np.testing.assert_allclose(_np(to)[:, 0], got[:, i], **TOL)
    zipped = port.decoder.gen_cache(tmem, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert isinstance(zipped[0][0], MultiHeadAttention.Cache)
    assert isinstance(zipped[1][0], MultiHeadAttention.StaticCache)


def test_decoder_layer_cache_is_the_pair():
    paddle.seed(0)
    ref = jnn.TransformerDecoderLayer(D, NH, FF, dropout=0.0)
    port = TransformerDecoderLayer(D, NH, FF, dropout=0.0, device="cpu")
    _carry(ref, port)
    mem = _x(2, 4, D, seed=3)
    jc = ref.gen_cache(_pt(mem))
    tc = port.gen_cache(torch.from_numpy(mem))
    x = _x(2, 1, D, seed=4)
    jo, (jinc, jst) = ref(_pt(x), _pt(mem), cache=jc)
    to, (tinc, tst) = port(torch.from_numpy(x), torch.from_numpy(mem),
                           cache=tc)
    np.testing.assert_allclose(_np(to), _jnp(jo), **TOL)
    assert tst is tc[1] and tuple(tinc.k.shape) == (2, 1, NH, D // NH)
    np.testing.assert_allclose(_np(tinc.k), _jnp(jinc.k), **TOL)


def test_o1_cache_dtypes_match():
    """Under O1 the Linear outputs are bf16; the empty float32 cache
    promotes the concatenation to float32 on both sides, and the output
    stays bf16."""
    paddle.seed(0)
    ref, port = _carry(jnn.MultiHeadAttention(D, NH),
                       MultiHeadAttention(D, NH, device="cpu"))
    mem = _x(2, 3, D)
    q = _x(2, 1, D, seed=1)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jo, jc = ref(_pt(q), cache=ref.gen_cache(_pt(mem)))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        to, tc = port(torch.from_numpy(q),
                      cache=port.gen_cache(torch.from_numpy(mem)))
    assert str(to.dtype).replace("torch.", "") == str(jo.dtype)
    assert str(tc.k.dtype).replace("torch.", "") == str(jc.k.dtype)
    assert tc.k.dtype == torch.float32 and to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), _jnp(jo), atol=2e-2, rtol=0)


def test_stepwise_decoding_equals_the_masked_forward():
    port = Transformer(D, NH, 2, 3, FF, dropout=0.0, device="cpu",
                       rng=np.random.default_rng(3))
    port.eval()
    src, tgt = torch.from_numpy(_x(3, 9, D, seed=5)), \
        torch.from_numpy(_x(3, 8, D, seed=6))
    full = port(src, tgt, tgt_mask=port.generate_square_subsequent_mask(8))
    mem = port.encoder(src)
    cache = port.decoder.gen_cache(mem)
    steps = []
    for i in range(8):
        out, cache = port.decoder(tgt[:, i:i + 1], mem, cache=cache)
        steps.append(out)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **TOL)
    assert tuple(cache[0][0].k.shape) == (3, 8, NH, D // NH)
