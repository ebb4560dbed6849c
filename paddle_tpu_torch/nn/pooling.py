"""Pooling layers — port of ``paddle_tpu/nn/layer/pooling.py``
(``MaxPool2D`` ``:26``, ``AdaptiveAvgPool2D`` ``:70``): the functional
ops of ``nn/functional/pooling.py`` with the layer's window, stride,
padding and ``data_format``."""
from __future__ import annotations

import torch

from .functional import pooling as P

__all__ = ["MaxPool2D", "AdaptiveAvgPool2D"]


class MaxPool2D(torch.nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW"):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.return_mask = return_mask
        self.data_format = data_format

    def forward(self, x):
        return P.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AdaptiveAvgPool2D(torch.nn.Module):
    def __init__(self, output_size, data_format="NCHW"):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        return P.adaptive_avg_pool2d(x, self._output_size, self._data_format)
