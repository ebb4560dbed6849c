"""Layers the GPT training step needs, as ``torch.nn.Module``s under the
reference's attribute names — port of ``paddle_tpu/nn/layer/common.py``
(``Embedding``, ``Dropout``), ``nn/layer/norm.py`` (``LayerNorm``) and
``distributed/fleet/meta_parallel/mp_layers.py:48-122``
(``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear``) as they are on one device.

- :class:`Linear` holds its weight as ``[in, out]`` and computes
  ``x @ W + b`` as the white-listed ``linear_op`` (under O1 the bias is
  cast low too): ``ColumnParallelLinear`` on one device.
- :class:`RowParallelLinear` is the same parameters with the
  reference's row-parallel forward: ``matmul_v2`` (white), then the bias
  added by a plain add, which under O1 promotes the low-precision
  product to float32.
- :class:`Embedding`, :class:`LayerNorm`, :class:`Dropout`, :class:`ReLU`
  (``nn/layer/activation.py``).
- :func:`load_named_state`, which carries the reference's
  ``named_parameters()`` (and, given them, its ``named_buffers()``) as
  numpy arrays into a module by name; the models' ``load_reference_state``
  call it.

Weights are made on the host from a numpy ``Generator`` (XavierUniform
for matrices and embeddings, :func:`kaiming_uniform` for convolutions
(``nn/initializer.py:108``), zero biases, unit LayerNorm gains, as the
reference initialises them) and placed on ``device``, which follows the
port's device policy (CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import functional as F

__all__ = ["Linear", "RowParallelLinear", "Embedding", "LayerNorm",
           "Dropout", "ReLU", "load_named_state"]


def _param(array, device):
    return torch.nn.Parameter(torch.tensor(np.asarray(array, np.float32),
                                           device=device))


def xavier_uniform(rng, shape):
    """XavierUniform of a 2-D ``[fan_in, fan_out]`` weight."""
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    rng = rng if rng is not None else np.random.default_rng()
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def kaiming_uniform(rng, shape, fan_in):
    """KaimingUniform for ReLU: U(-sqrt(6 / fan_in), sqrt(6 / fan_in))."""
    limit = float(np.sqrt(6.0 / fan_in))
    rng = rng if rng is not None else np.random.default_rng()
    return rng.uniform(-limit, limit, shape).astype(np.float32)


class Linear(torch.nn.Module):
    def __init__(self, in_features, out_features, *, rng=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.weight = _param(xavier_uniform(rng, (in_features,
                                                  out_features)), dev)
        self.bias = _param(np.zeros(out_features), dev)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class RowParallelLinear(Linear):
    def forward(self, x):
        return F.add(F.matmul(x, self.weight), self.bias)


class Embedding(torch.nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, rng=None,
                 device=None):
        super().__init__()
        self.weight = _param(xavier_uniform(rng, (num_embeddings,
                                                  embedding_dim)),
                             resolve_device(device))

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(torch.nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self._epsilon = float(epsilon)
        self.weight = _param(np.ones(normalized_shape), dev)
        self.bias = _param(np.zeros(normalized_shape), dev)

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self._epsilon)


class Dropout(torch.nn.Module):
    """Upscale-in-train dropout whose masks come from ``generator`` (a
    ``torch.Generator`` on the activations' device, shared by a model's
    dropouts so a seed fixes them all)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = float(p)
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)


class ReLU(torch.nn.Module):
    def forward(self, x):
        return F.relu(x)


@torch.no_grad()
def load_named_state(module, named, buffers=None):
    """Copy ``{name: array}`` (the reference's ``named_parameters()``
    through ``np.asarray``) into ``module``'s parameters of the same
    names, and ``buffers`` (its ``named_buffers()``) into the buffers,
    when given; raises on a missing, extra or misshapen name. Every name
    is checked before anything is copied."""
    pairs = [("parameter", dict(module.named_parameters()), named)]
    if buffers is not None:
        pairs.append(("buffer", dict(module.named_buffers()), buffers))
    for kind, own, given in pairs:
        missing, extra = set(own) - set(given), set(given) - set(own)
        if missing or extra:
            raise KeyError(f"{kind} names differ: missing "
                           f"{sorted(missing)}, unexpected {sorted(extra)}")
        for name, t in own.items():
            shape = np.shape(given[name])
            if tuple(shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {shape} != "
                                 f"{tuple(t.shape)}")
    for _, own, given in pairs:
        for name, t in own.items():
            t.copy_(torch.tensor(np.asarray(given[name], np.float32)))
