"""Scaled dot-product attention — port of
``paddle_tpu/nn/functional/attention.py``.

:func:`scaled_dot_product_attention` takes ``[B, L, H, D]`` tensors at
scale ``1 / sqrt(D)``, casts them as the white-listed
``flash_attention`` op (bf16 under O1), and runs
``kernels.flash_attention.flash_attention``: the hand-written CUDA
kernels for a CUDA tensor, the plain PyTorch version for a CPU tensor.
The reference routes to XLA when the Pallas kernel refuses a shape
(unaligned lengths, causal ``Lq != Lk``); the port's kernels take every
shape themselves and answer as :func:`_sdpa_reference` does, so there is
no fallback here.

:func:`_sdpa_reference` is the reference's plain oracle (``:24-38``):
scores masked with ``-1e30`` (bottom-right causal alignment,
``tril(k=lk-lq)``), softmax in float32, probabilities cast back to q's
dtype. The port never calls it on its path; the tests hold the kernels
and the plain versions against it.

Masks (dense or ``SegmentIds``) belong to the BERT slice and raise
``NotImplementedError`` until it is ported.
"""
from __future__ import annotations

import math

import torch

from ... import amp
from ...kernels.flash_attention import flash_attention

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


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """q/k/v: ``[batch, seq, heads, head_dim]`` (the reference's layout)."""
    if attn_mask is not None:
        raise NotImplementedError(
            "scaled_dot_product_attention: attn_mask (dense or SegmentIds) "
            "is not ported to paddle_tpu_torch yet")
    scale = 1.0 / math.sqrt(float(query.shape[-1]))
    q, k, v = amp.cast_inputs("flash_attention", query, key, value)
    return flash_attention(q, k, v, causal=bool(is_causal), scale=scale)
