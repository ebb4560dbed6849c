"""The transformer stack — port of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention``
``:29-105``, ``TransformerEncoderLayer`` ``:108-178``,
``TransformerEncoder``, ``TransformerDecoderLayer`` ``:206-273``,
``TransformerDecoder`` ``:276-304`` and ``Transformer`` ``:307-349``).

Attribute names are the reference's, so parameter names match by name
(``layers.N.self_attn.q_proj.weight``, ``linear1``, ``norm1``, ...), and
so does the math:

- :class:`MultiHeadAttention` projects q, k and v with separate
  ``Linear`` layers (``linear_op``), reshapes to ``[B, L, H, D]`` and runs
  :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
  with the mask it is given (dense, or ``SegmentIds``), passing
  ``dropout_p`` and ``training`` as the reference does, where they are
  ignored (ROADMAP C8). With no mask that is the flash kernel, also at
  one query against a cache.
- Incremental decoding, as the reference's: ``Cache(k, v)`` is the self
  attention's growing cache (the new k and v concatenated after it on the
  length axis, ``torch.cat`` promoting as ``jnp.concatenate`` does: the
  empty float32 cache of :meth:`MultiHeadAttention.gen_cache` makes an
  O1 bf16 k float32, and the flash op's cast takes it back to bf16);
  ``StaticCache(k, v)`` is the cross attention's projected memory, used
  as it is. ``forward(cache=)`` returns ``(out, cache)``.
- :class:`TransformerEncoderLayer` / :class:`TransformerDecoderLayer`:
  post-norm (the default) or ``normalize_before``; the activation by name
  from the port's functional ops (``gelu`` is the erf form);
  upscale-in-train dropouts after each attention, after the activation
  and after the feed-forward, each drawing from the model's one
  ``torch.Generator``. A decoder layer's cache is ``(Cache, StaticCache)``.
- :class:`TransformerEncoder` / :class:`TransformerDecoder`:
  ``num_layers`` layers built alike (the first is the one given; the
  others are new layers with its arguments, so their weights differ), an
  optional final norm, and ``gen_cache`` (the decoder's with ``do_zip``).
- :class:`Transformer`: the encoder-decoder with the reference's defaults
  and :meth:`Transformer.generate_square_subsequent_mask`.

Weights are made on the host from a numpy ``Generator`` (``rng``) and
placed on ``device``, as in ``nn/layers.py``.
"""
from __future__ import annotations

import collections

import torch

from . import functional as F
from .layers import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(torch.nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

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

    def _heads(self, x):
        return x.reshape(x.shape[0], -1, self.num_heads, self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=Cache):  # noqa: A002
        """``StaticCache``: ``key`` (and ``value``, default ``key``)
        projected once. ``Cache`` with no ``value``: empty ``[B, 0, H,
        D]`` caches in the default dtype; with one: ``Cache(key,
        value)``."""
        if type == MultiHeadAttention.StaticCache:
            return self.StaticCache(
                self._heads(self.k_proj(key)),
                self._heads(self.v_proj(value if value is not None
                                        else key)))
        if value is None:
            shape = (key.shape[0], 0, self.num_heads, self.head_dim)
            dt = torch.get_default_dtype()
            return self.Cache(torch.zeros(shape, dtype=dt, device=key.device),
                              torch.zeros(shape, dtype=dt, device=key.device))
        return self.Cache(key, value)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], -1, self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _activation(name):
    if name not in F.__all__:
        raise NotImplementedError(
            f"activation {name!r} is not ported to paddle_tpu_torch yet")
    return getattr(F, name)


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
        self.activation = _activation(activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = F.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = F.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerDecoderLayer(torch.nn.Module):
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
        self.cross_attn = MultiHeadAttention(d_model, nhead,
                                             dropout=attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout, generator)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout, generator)
        self.dropout2 = Dropout(dropout, generator)
        self.dropout3 = Dropout(dropout, generator)
        self.activation = _activation(activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = F.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = F.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)

        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = F.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class _Stack(torch.nn.Module):
    """``num_layers`` layers built alike and an optional final norm."""

    def __init__(self, layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [layer] + [type(layer)(**layer._args)
                       for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def _run(self, output, args, cache):
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, *args)
            else:
                output, new_cache = mod(output, *args, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerEncoder(_Stack):
    def forward(self, src, src_mask=None, cache=None):
        return self._run(src, (src_mask,), cache)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoder(_Stack):
    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        return self._run(tgt, (memory, tgt_mask, memory_mask), cache)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(torch.nn.Module):
    """The encoder-decoder transformer (reference ``:307``)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, custom_encoder=None,
                 custom_decoder=None, *, rng=None, generator=None,
                 device=None):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
        kw = dict(rng=rng, generator=generator, device=device)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=device) \
                if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """``[length, length]`` float32: 0 on and below the diagonal,
        ``-inf`` above, on the model's device."""
        dev = next(self.parameters()).device
        return torch.full((length, length), -float("inf"),
                          device=dev).triu(1)
