"""BERT of the PyTorch port (paddle_tpu_torch/models/bert.py on
nn/transformer.py) against the JAX reference on the CPU, on
``bert_tiny(dropout=0)`` built after ``paddle.seed(0)``, its weights
carried across by name with ``load_reference_state``.

- ``BertForSequenceClassification`` logits: unpacked, packed with
  ``start_positions`` and with ``dense=True`` (on the CPU the reference
  answers a packed mask through its dense route; the port through the
  plain packed functions), and packed against unpacked within the port.
- ``BertForPretraining`` logits; a pre-norm ``TransformerEncoderLayer``
  with a dense mask.
- 4 AdamW steps of ``TrainStep`` against
  ``paddle_tpu.parallel.api.TrainStep`` on bench_bert's packed loss
  (float32, no autocast), and the O1 bf16 dtypes at every layer, the
  pooled output, the logits and the loss.

Tolerances (float32 on both sides; sums in other orders): logits 1e-5
(rtol and atol, logits are O(1)); losses rtol 1e-5 (tighter than the
1e-4 parity limit); parameters rtol 1e-4 / atol 1e-6, the key bias (its exact
gradient is zero, so Adam steps rounding noise) within 2 x steps x lr."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.kernels.packed_flash_pallas import SegmentIds as JSegmentIds
from paddle_tpu.models.bert import BertForPretraining as JBertForPretraining
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JBertForSequenceClassification
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.kernels.packed_flash import SegmentIds
from paddle_tpu_torch.models.bert import (BertForPretraining,
                                          BertForSequenceClassification,
                                          bert_tiny)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.api import TrainStep
from paddle_tpu_torch.tools import bench_bert

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
SEQ, PACK, BATCH, K, LR = 32, 4, 8, 4, 3e-5


def _mesh():
    """A one-device mesh with the reference's axes."""
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _named(ref):
    return {n: np.asarray(p._array) for n, p in ref.named_parameters()}


def _classifiers(num_classes=2):
    paddle.seed(0)
    ref = JBertForSequenceClassification(jax_bert_tiny(dropout=0.0),
                                         num_classes=num_classes)
    ref.eval()
    port = BertForSequenceClassification(bert_tiny(dropout=0.0),
                                         num_classes=num_classes,
                                         device="cpu", seed=1)
    port.eval()
    port.load_reference_state(_named(ref))
    return ref, port


def _packed(k=None):
    """bench_bert's data at bert_tiny's vocabulary: (ids [rows, PACK *
    SEQ] or [k, ...], labels, segment ids, start positions)."""
    ids, y, seg, starts = bench_bert.make_data(BATCH, PACK, k=k or 1,
                                               vocab=256, seq=SEQ)
    return (ids if k else ids[0]), (y if k else y[0]), seg, starts


def _masks(seg, starts, dense=False):
    return (JSegmentIds(paddle.to_tensor(seg),
                        start_positions=paddle.to_tensor(starts),
                        dense=dense),
            SegmentIds(torch.from_numpy(seg),
                       start_positions=torch.from_numpy(starts),
                       dense=dense))


def _np(t):
    return t.detach().float().cpu().numpy()


def test_parameter_names_and_shapes_match_the_reference():
    ref, port = _classifiers()
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    got = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    assert got == want
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in dict(got)


@pytest.mark.parametrize("route", ["unpacked", "packed", "packed_dense"])
def test_classifier_logits_match(route):
    ref, port = _classifiers(num_classes=3)
    ids, _, seg, starts = _packed()
    if route == "unpacked":
        ids = ids.reshape(BATCH, SEQ)
        want = np.asarray(ref(paddle.to_tensor(ids))._array)
        got = _np(port(torch.from_numpy(ids)))
    else:
        jm, pm = _masks(seg, starts, dense=route == "packed_dense")
        want = np.asarray(ref(paddle.to_tensor(ids),
                              attention_mask=jm)._array)
        got = _np(port(torch.from_numpy(ids), attention_mask=pm))
        assert got.shape == (BATCH // PACK, PACK, 3)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_packed_equals_unpacked_within_the_port():
    """The same examples, PACK to a row: positions restart, no attention
    across sequences, one CLS pool each (tests/test_seq_packing.py)."""
    _, port = _classifiers(num_classes=3)
    ids, _, seg, starts = _packed()
    want = _np(port(torch.from_numpy(ids.reshape(BATCH, SEQ))))
    for dense in (False, True):
        _, pm = _masks(seg, starts, dense=dense)
        got = _np(port(torch.from_numpy(ids), attention_mask=pm))
        np.testing.assert_allclose(got.reshape(BATCH, -1), want,
                                   **LOGIT_TOL)


def test_pretraining_logits_match():
    paddle.seed(0)
    ref = JBertForPretraining(jax_bert_tiny(dropout=0.0))
    ref.eval()
    port = BertForPretraining(bert_tiny(dropout=0.0), device="cpu", seed=2)
    port.eval()
    port.load_reference_state(_named(ref))
    ids = np.random.RandomState(3).randint(0, 256, (2, 40))
    tt = np.random.RandomState(4).randint(0, 2, (2, 40))
    want = np.asarray(ref(paddle.to_tensor(ids),
                          paddle.to_tensor(tt))._array)
    got = _np(port(torch.from_numpy(ids), torch.from_numpy(tt)))
    assert got.shape == (2, 40, 256)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_pre_norm_encoder_layer_with_a_dense_mask_matches():
    paddle.seed(0)
    ref = jnn.TransformerEncoderLayer(32, 4, 48, dropout=0.0,
                                      activation="relu",
                                      normalize_before=True)
    ref.eval()
    port = nn.TransformerEncoderLayer(32, 4, 48, dropout=0.0,
                                      activation="relu",
                                      normalize_before=True, device="cpu")
    port.eval()
    nn.load_named_state(port, _named(ref))
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 32).astype(np.float32)
    mask = np.where(rng.rand(2, 1, 12, 12) < 0.3, -1e30, 0.0).astype(
        np.float32)
    mask[..., 0] = 0.0                      # every row sees a column
    want = np.asarray(ref(paddle.to_tensor(x),
                          paddle.to_tensor(mask))._array)
    got = _np(port(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    with pytest.raises(NotImplementedError):
        port(torch.from_numpy(x), cache=object())
    with pytest.raises(NotImplementedError):
        nn.TransformerEncoderLayer(32, 4, 48, activation="swish",
                                   device="cpu")


def _jax_packed_loss(mask, rows):
    def loss_fn(m, ids, y):
        logits = m(ids, attention_mask=mask)
        return JF.cross_entropy(paddle.reshape(logits, [rows * PACK, -1]),
                                paddle.reshape(y, [-1]))
    return loss_fn


def test_train_steps_on_the_packed_loss_match():
    ref, port = _classifiers()
    ref.train()
    port.train()
    ids, y, seg, starts = _packed(K)
    jm, pm = _masks(seg, starts)
    jstep = JaxTrainStep(ref, _jax_packed_loss(jm, seg.shape[0]),
                         jopt.AdamW(learning_rate=LR, weight_decay=0.01,
                                    parameters=ref.parameters()),
                         mesh=_mesh())
    jl = np.asarray(jstep.multi_step(ids, y)._array)
    step = TrainStep(port, bench_bert.make_loss_fn(pm, amp_level=None),
                     AdamW(learning_rate=LR, weight_decay=0.01),
                     device="cpu")
    pl = _np(step.multi_step(torch.from_numpy(ids), torch.from_numpy(y)))
    assert pl.shape == (K,)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    jp = _named(ref)
    for name, p in port.named_parameters():
        got, want = _np(p), jp[name]
        if name.endswith("self_attn.k_proj.bias"):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 * K * LR, err_msg=name)
            continue
        np.testing.assert_allclose(got, want, err_msg=name, **PARAM_TOL)


def _dtypes_jax(m, ids, mask):
    out = []
    t = paddle.to_tensor(ids)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        seg = mask if isinstance(mask, JSegmentIds) else None
        pos = None
        if seg is not None:
            from paddle_tpu.framework.core import Tensor
            from paddle_tpu.kernels.packed_flash_pallas import \
                segment_relative_positions
            pos = Tensor(np.asarray(segment_relative_positions(
                seg.ids._array)).astype(np.int64))
        x = m.bert.embeddings(t, None, pos)
        out.append(str(x.dtype))
        for layer in m.bert.encoder.layers:
            x = layer(x, mask)
            out.append(str(x.dtype))
        _, pooled = m.bert(t, attention_mask=mask)
        logits = m(t, attention_mask=mask)
        out += [str(pooled.dtype), str(logits.dtype)]
    out.append(str(JF.cross_entropy(
        paddle.reshape(logits, [-1, logits.shape[-1]]),
        paddle.to_tensor(np.zeros(int(np.prod(logits.shape[:-1])),
                                  np.int64))).dtype))
    return out


def _dtypes_port(m, ids, mask):
    from paddle_tpu_torch.kernels.packed_flash import \
        segment_relative_positions
    from paddle_tpu_torch.nn.functional import cross_entropy
    out = []
    t = torch.from_numpy(ids)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        pos = (segment_relative_positions(mask.ids).long()
               if isinstance(mask, SegmentIds) else None)
        x = m.bert.embeddings(t, None, pos)
        out.append(str(x.dtype))
        for layer in m.bert.encoder.layers:
            x = layer(x, mask)
            out.append(str(x.dtype))
        _, pooled = m.bert(t, attention_mask=mask)
        logits = m(t, attention_mask=mask)
        out += [str(pooled.dtype), str(logits.dtype)]
    out.append(str(cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.zeros(int(np.prod(logits.shape[:-1])), dtype=torch.long))
        .dtype))
    return [s.replace("torch.", "") for s in out]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_o1_dtypes_match_at_every_op_boundary(packed):
    """Lookups, layer_norm, the residual adds, gelu, tanh and the CLS
    gather follow their inputs (on neither list), ``linear_op`` and the
    attention ops go to bf16, and the cross entropy outside the autocast
    runs in the logits' dtype: the stream stays float32 between layers,
    the pooled output and the logits are bf16."""
    ref, port = _classifiers()
    ids, _, seg, starts = _packed()
    if packed:
        jm, pm = _masks(seg, starts)
    else:
        ids, jm, pm = ids.reshape(BATCH, SEQ), None, None
    want = _dtypes_jax(ref, ids, jm)
    assert _dtypes_port(port, ids, pm) == want
    assert want[-3:] == ["bfloat16", "bfloat16", "bfloat16"]
    assert want[1] == "float32"
