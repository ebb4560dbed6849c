"""Functional ops the GPT and BERT training steps need — port of
``paddle_tpu/nn/functional/common.py`` (``linear``, ``dropout``,
``embedding``), ``activation.py`` (``gelu``, ``relu``, ``tanh``), ``norm.py``
(``layer_norm``) and ``ops/math.py`` (``matmul``).

Each keeps the reference's autocast name (``linear_op`` and
``matmul_v2`` are on the white list; the others are on no list and run
in their inputs' dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import amp

__all__ = ["linear", "matmul", "embedding", "dropout", "gelu", "relu",
           "tanh", "layer_norm"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with ``weight`` ``[in, out]`` (``linear_op``:
    under O1 the bias is cast to the low dtype too)."""
    x, weight, bias = amp.cast_inputs("linear_op", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def matmul(x, y, transpose_y=False):
    """``matmul_v2``: ``x @ y``, or ``x @ y^T``."""
    x, y = amp.cast_inputs("matmul_v2", x, y)
    return torch.matmul(x, y.transpose(-1, -2) if transpose_y else y)


def embedding(x, weight):
    """Rows of ``weight`` at ``x``, ids clamped into range as the
    reference's ``jnp.take`` with clipping does."""
    return weight[x.clamp(0, weight.shape[0] - 1)]


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout; the mask comes from ``generator`` (a
    ``torch.Generator`` on ``x``'s device). Identity, drawing nothing,
    when not training or ``p == 0``."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= float(p)
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def gelu(x, approximate=False):
    """The erf form by default, as the reference's (``activation.py:82``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def tanh(x):
    return torch.tanh(x)


def layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis: statistics and affine in float32,
    output in ``x``'s dtype (``norm.py:90-105``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), epsilon).to(x.dtype)
