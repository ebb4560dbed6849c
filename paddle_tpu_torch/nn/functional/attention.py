"""Scaled dot-product attention — port of
``paddle_tpu/nn/functional/attention.py``.

:func:`scaled_dot_product_attention` takes ``[B, L, H, D]`` tensors at
scale ``1 / sqrt(D)`` and routes the mask as the reference does
(``:78-103``):

- no mask: cast as the white-listed ``flash_attention`` op (bf16 under
  O1) and run ``kernels.flash_attention.flash_attention``;
- a :class:`~paddle_tpu_torch.kernels.packed_flash.SegmentIds` with
  ``dense=False``: cast as ``packed_flash_attention`` (white-listed too)
  and run ``kernels.packed_flash.packed_flash_attention``;
- a ``SegmentIds`` with ``dense=True``: the same cast, then
  :func:`_sdpa_reference` with the block-diagonal float32 ``-1e30`` mask
  (the reference's XLA route, ``:70-75``);
- a dense additive mask: cast with q, k and v as ``flash_attention``
  (under O1 the mask goes low too, as the reference's ``run_op`` casts
  it), then :func:`_sdpa_reference`.

The kernel wrappers run the hand-written CUDA kernels for a CUDA tensor
and the plain PyTorch versions for a CPU tensor. The reference routes to
XLA when a Pallas kernel refuses a shape; the port's kernels take every
length, so there is no fallback. ``dropout_p`` and ``training`` are
accepted and ignored, as the reference ignores them (it never passes
``dropout_p`` on, ``:97-103``; ROADMAP C8).

:func:`_sdpa_reference` is the reference's plain oracle (``:24-38``):
scores masked with ``-1e30`` (bottom-right causal alignment,
``tril(k=lk-lq)``), softmax in float32, probabilities cast back to q's
dtype.
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...kernels.flash_attention import flash_attention
from ...kernels.packed_flash import SegmentIds, packed_flash_attention

__all__ = ["scaled_dot_product_attention", "_sdpa_reference"]


def _sdpa_reference(q, k, v, mask=None, *, causal, scale):
    """q ``[B, Lq, H, D]``, k and v ``[B, Lk, H, D]`` -> ``[B, Lq, H,
    D]``; ``mask`` additive, broadcastable to ``[B, H, Lq, Lk]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        cm = torch.ones(lq, lk, dtype=torch.bool,
                        device=q.device).tril(diagonal=lk - lq)
        logits = torch.where(cm, logits, torch.full((), -1e30,
                                                    dtype=logits.dtype,
                                                    device=q.device))
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_diagonal_mask(ids):
    """``[B, 1, L, L]`` float32: 0 within a segment, ``-1e30`` across."""
    keep = ids[:, None, :, None] == ids[:, None, None, :]
    return torch.where(keep, 0.0, -1e30).to(torch.float32)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """q/k/v: ``[batch, seq, heads, head_dim]`` (the reference's layout).
    ``attn_mask``: ``None``, a dense additive mask broadcastable to
    ``[B, H, Lq, Lk]``, or a ``SegmentIds``."""
    scale = 1.0 / math.sqrt(float(query.shape[-1]))
    causal = bool(is_causal)
    if isinstance(attn_mask, SegmentIds):
        q, k, v = amp.cast_inputs("packed_flash_attention", query, key,
                                  value)
        ids = torch.as_tensor(attn_mask.ids, device=q.device)
        if attn_mask.dense:
            return _sdpa_reference(q, k, v, _block_diagonal_mask(ids),
                                   causal=causal, scale=scale)
        return packed_flash_attention(q, k, v, ids, causal=causal,
                                      scale=scale)
    if attn_mask is not None:
        mask = torch.as_tensor(attn_mask, device=query.device)
        q, k, v, mask = amp.cast_inputs("flash_attention", query, key,
                                        value, mask)
        return _sdpa_reference(q, k, v, mask, causal=causal, scale=scale)
    q, k, v = amp.cast_inputs("flash_attention", query, key, value)
    return flash_attention(q, k, v, causal=causal, scale=scale)
