"""BERT — port of ``paddle_tpu/models/bert.py``.

:class:`BertConfig`, :func:`bert_base` and :func:`bert_tiny` are the
reference's configurations; :class:`BertEmbeddings`, :class:`BertModel`
(on the port's ``TransformerEncoder``, post-norm, erf ``gelu``),
:class:`BertForSequenceClassification` and :class:`BertForPretraining`
keep its attribute names, so parameter names match by name and
``load_reference_state`` carries the reference's weights across.

Packing (``:59-93``): pass ``attention_mask=SegmentIds(ids,
start_positions=None, dense=False)``. Attention then stays inside each
segment (the packed kernels, or with ``dense=True`` the dense
block-diagonal mask), position ids restart at each segment
(:func:`~paddle_tpu_torch.kernels.packed_flash.segment_relative_positions`),
and with ``start_positions [B, P]`` the pooler reads each segment's first
(CLS) token, gathered with ``torch.gather`` (the reference's
``take_along_axis``), so ``pooled`` is ``[B, P, hidden]``.

Weights are made on the host from numpy seed ``seed`` (XavierUniform
matrices and embeddings, zero biases, unit LayerNorm gains, as the
reference initialises them); dropout masks come from one
``torch.Generator`` a model, seeded with ``seed``. Runs on CUDA unless
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import nn
from ..device import resolve_device
from ..kernels.packed_flash import SegmentIds, segment_relative_positions
from ..nn import functional as F

__all__ = ["BertConfig", "bert_base", "bert_tiny", "BertEmbeddings",
           "BertModel", "BertForSequenceClassification",
           "BertForPretraining"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    """Test-scale config (the reference's ``bert_tiny``)."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 128)
    return BertConfig(**kw)


def _init(device, seed):
    """The weight rng, the dropout generator and the device of a model."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return dict(rng=np.random.default_rng(seed), generator=gen, device=dev)


class _Model(torch.nn.Module):
    def load_reference_state(self, named):
        """Copy ``{name: array}`` (the reference's ``named_parameters()``
        through ``np.asarray``) into the parameters of the same names;
        raises on a missing, extra or misshapen name."""
        nn.load_named_state(self, named)


class BertEmbeddings(torch.nn.Module):
    def __init__(self, cfg, *, rng=None, generator=None, device=None):
        super().__init__()
        kw = dict(rng=rng, device=device)
        self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                            cfg.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, device=device)
        self.dropout = nn.Dropout(cfg.dropout, generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        emb = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids)
        if token_type_ids is not None:
            emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(_Model):
    def __init__(self, cfg, device=None, seed=0, *, init=None):
        super().__init__()
        init = init or _init(device, seed)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **init)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu", **init)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                rng=init["rng"], device=init["device"])

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        """``(sequence output [B, L, hidden], pooled)``; ``pooled`` is
        ``[B, hidden]``, or ``[B, P, hidden]`` for a ``SegmentIds`` mask
        with ``start_positions``."""
        seg = None
        if isinstance(attention_mask, SegmentIds):
            # the ids go to the device once, not once a layer
            seg = SegmentIds(torch.as_tensor(attention_mask.ids,
                                             device=input_ids.device),
                             attention_mask.start_positions,
                             attention_mask.dense)
            attention_mask = seg
            if position_ids is None:
                position_ids = segment_relative_positions(seg.ids).long()
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, src_mask=attention_mask)
        if seg is not None and seg.start_positions is not None:
            starts = torch.as_tensor(seg.start_positions,
                                     device=x.device).long()
            cls = torch.gather(x, 1, starts[..., None].expand(
                -1, -1, x.shape[-1]))
            pooled = F.tanh(self.pooler(cls))
        else:
            pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(_Model):
    def __init__(self, cfg, num_classes=2, device=None, seed=0):
        super().__init__()
        init = _init(device, seed)
        self.bert = BertModel(cfg, init=init)
        self.dropout = nn.Dropout(cfg.dropout, init["generator"])
        self.classifier = nn.Linear(cfg.hidden_size, num_classes,
                                    rng=init["rng"], device=init["device"])

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForPretraining(_Model):
    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        init = _init(device, seed)
        self.bert = BertModel(cfg, init=init)
        self.mlm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                  rng=init["rng"], device=init["device"])

    def forward(self, input_ids, token_type_ids=None):
        seq, _ = self.bert(input_ids, token_type_ids)
        return self.mlm_head(seq)
