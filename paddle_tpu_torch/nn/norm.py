"""``BatchNorm1D`` / ``BatchNorm2D`` — port of
``paddle_tpu/nn/layer/norm.py:16-47`` (``_BatchNormBase``) and ``:78``.

``weight`` starts at 1 and ``bias`` at 0 (float32 parameters); the
running mean (0) and variance (1) are float32 **buffers** under the
reference's names, ``_mean_buf`` and ``_variance_buf`` (``_mean`` and
``_variance`` read them), so ``named_buffers()`` matches the
reference's name for name. ``momentum=0.9`` weights the old running
value, ``epsilon=1e-5``; the forward is
:func:`~paddle_tpu_torch.nn.functional.norm.batch_norm` in the layer's
training mode, which updates the buffers in place once a call while it
normalises with the batch's statistics. ``weight_attr=False`` /
``bias_attr=False`` drop the affine; other parameter attributes raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .functional.norm import batch_norm
from .layers import _param

__all__ = ["BatchNorm1D", "BatchNorm2D"]


class _BatchNormBase(torch.nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, *, device=None):
        super().__init__()
        if weight_attr not in (None, False) or bias_attr not in (None,
                                                                 False):
            raise NotImplementedError(
                "BatchNorm: parameter attributes are not ported to "
                "paddle_tpu_torch yet")
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else _param(
            np.ones(num_features), dev)
        self.bias = None if bias_attr is False else _param(
            np.zeros(num_features), dev)
        self.register_buffer("_mean_buf", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance_buf", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    @property
    def _mean(self):
        return self._mean_buf

    @property
    def _variance(self):
        return self._variance_buf

    def forward(self, x):
        return batch_norm(x, self._mean_buf, self._variance_buf, self.weight,
                          self.bias, training=self.training,
                          momentum=self._momentum, epsilon=self._epsilon,
                          data_format=self._data_format,
                          use_global_stats=self._use_global_stats)


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, *, device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass
