"""``Conv2D`` — port of ``paddle_tpu/nn/layer/conv.py:20-83``.

The weight is ``[out, in / groups, kh, kw]`` (the reference's layout and
torch's), KaimingUniform over ``fan_in = in / groups * kh * kw``; the
bias, unless ``bias_attr=False``, is U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
Both are drawn from a numpy ``Generator`` and placed on ``device`` (CUDA
unless the caller asks for the CPU). The forward is
:func:`~paddle_tpu_torch.nn.functional.conv.conv2d` with the layer's
stride, padding, dilation, groups and ``data_format``. Parameter
attributes other than ``bias_attr=False``, and a ``padding_mode`` other
than ``"zeros"``, are not ported and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .functional.conv import _norm_tuple, conv2d
from .layers import _param, kaiming_uniform

__all__ = ["Conv2D"]


class Conv2D(torch.nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 rng=None, device=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None or \
                bias_attr not in (None, False):
            raise NotImplementedError(
                "Conv2D: padding_mode other than 'zeros' and parameter "
                "attributes are not ported to paddle_tpu_torch yet")
        dev = resolve_device(device)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _norm_tuple(kernel_size, 2, "kernel_size")
        self._stride = _norm_tuple(stride, 2, "stride")
        self._padding = padding
        self._dilation = _norm_tuple(dilation, 2, "dilation")
        self._groups = groups
        self._data_format = data_format
        rng = rng if rng is not None else np.random.default_rng()
        fan_in = (in_channels // groups) * int(np.prod(self._kernel_size))
        self.weight = _param(kaiming_uniform(
            rng, (out_channels, in_channels // groups) + self._kernel_size,
            fan_in), dev)
        if bias_attr is False:
            self.bias = None
        else:
            bound = 1.0 / np.sqrt(fan_in)
            self.bias = _param(rng.uniform(-bound, bound, out_channels), dev)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)
