"""The transformer encoder stack — port of
``paddle_tpu/nn/layer/transformer.py:29-195`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

Attribute names are the reference's, so parameter names match by name
(``layers.N.self_attn.q_proj.weight``, ``linear1``, ``norm1``, ...), and
so does the math:

- :class:`MultiHeadAttention` projects q, k and v with separate
  ``Linear`` layers (``linear_op``), reshapes to ``[B, L, H, D]`` and runs
  :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
  with the mask it is given (dense, or ``SegmentIds``), passing
  ``dropout_p`` and ``training`` as the reference does, where they are
  ignored (ROADMAP C8). Incremental decoding (``cache``) is not ported and
  raises.
- :class:`TransformerEncoderLayer`: post-norm (the default) or
  ``normalize_before``; the activation by name from the port's functional
  ops (``gelu`` is the erf form); upscale-in-train dropouts after the
  attention, after the activation and after the feed-forward, each drawing
  from the model's one ``torch.Generator``.
- :class:`TransformerEncoder`: ``num_layers`` layers built alike (the
  first is the one given; the others are new layers with its arguments,
  so their weights differ), and an optional final norm.

Weights are made on the host from a numpy ``Generator`` (``rng``) and
placed on ``device``, as in ``nn/layers.py``.
"""
from __future__ import annotations

import torch

from . import functional as F
from .layers import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]


class MultiHeadAttention(torch.nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, rng=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        kw = dict(rng=rng, device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention: cache (incremental decoding) is not "
                "ported to paddle_tpu_torch yet")
        key = query if key is None else key
        value = query if value is None else value
        b = query.shape[0]
        shape = (b, -1, self.num_heads, self.head_dim)
        q = self.q_proj(query).reshape(shape)
        k = self.k_proj(key).reshape(shape)
        v = self.v_proj(value).reshape(shape)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training)
        out = self.out_proj(out.reshape(b, -1, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(torch.nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, rng=None, generator=None,
                 device=None):
        super().__init__()
        self._args = dict(d_model=d_model, nhead=nhead,
                          dim_feedforward=dim_feedforward, dropout=dropout,
                          activation=activation, attn_dropout=attn_dropout,
                          act_dropout=act_dropout,
                          normalize_before=normalize_before, rng=rng,
                          generator=generator, device=device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(rng=rng, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator)
        self.dropout2 = Dropout(dropout, generator)
        if activation not in F.__all__:
            raise NotImplementedError(
                f"activation {activation!r} is not ported to "
                "paddle_tpu_torch yet")
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoderLayer: cache is not ported to "
                "paddle_tpu_torch yet")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [encoder_layer] + [TransformerEncoderLayer(**encoder_layer._args)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerEncoder: cache is not ported to "
                "paddle_tpu_torch yet")
        output = src
        for mod in self.layers:
            output = mod(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
