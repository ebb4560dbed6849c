"""2-D pooling — port of ``paddle_tpu/nn/functional/pooling.py``
(``max_pool2d`` ``:155-173`` with the geometry of ``_pool_geometry``
``:109-143``, ``avg_pool2d``, ``adaptive_avg_pool2d`` ``:259`` with the
bins of ``:203-223``).

The reference lowers to ``lax.reduce_window`` and jnp means, XLA ops
with no Pallas body; the port runs ATen's pooling (``max_pool2d``,
``avg_pool2d``, ``adaptive_avg_pool2d``), in ``x``'s dtype (the ops are
on no autocast list).

- Padding as ``conv2d`` takes it; ``"SAME"`` pads ``max((ceil(in / s) -
  1) s + k - in, 0)`` with the extra element high, as the reference.
  Max pooling pads with ``-inf`` (explicitly where the two sides differ
  or a side exceeds half the window, which ATen's own padding refuses);
  average pooling divides by the cells inside the input when
  ``exclusive`` (the reference's default) and by the window otherwise,
  and takes symmetric padding of at most half the window only.
- ``adaptive_avg_pool2d``'s bins are ``[floor(i in / out), ceil((i + 1)
  in / out))``, torch's and the reference's alike.
- ``data_format="NHWC"`` permutes to an NCHW view and back, as ``conv2d``.
- ``ceil_mode=True`` and ``return_mask=True`` are not ported yet and
  raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch.nn.functional as F

from .conv import _norm_padding, _norm_tuple, from_nchw, same_pads, to_nchw

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _layout(data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"pooling: data_format {data_format!r}")
    return data_format == "NHWC"


def _geometry(xc, kernel_size, stride, padding, ceil_mode, what):
    if ceil_mode:
        raise NotImplementedError(f"{what}(ceil_mode=True) is not ported "
                                  "to paddle_tpu_torch yet")
    kernel = _norm_tuple(kernel_size, 2, "kernel_size")
    strides = _norm_tuple(stride if stride is not None else kernel_size, 2,
                          "stride")
    pads = _norm_padding(padding, 2)
    if pads == "VALID":
        pads = [(0, 0)] * 2
    elif pads == "SAME":
        pads = same_pads(xc.shape[2:], kernel, strides, (1, 1))
    return kernel, strides, pads


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW"):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported to paddle_tpu_torch yet")
    channel_last = _layout(data_format)
    xc = to_nchw(x, channel_last)
    kernel, strides, pads = _geometry(xc, kernel_size, stride, padding,
                                      ceil_mode, "max_pool2d")
    if any(lo != hi or 2 * lo > k for (lo, hi), k in zip(pads, kernel)):
        xc = F.pad(xc, [pads[1][0], pads[1][1], pads[0][0], pads[0][1]],
                   value=float("-inf"))
        pads = [(0, 0)] * 2
    return from_nchw(F.max_pool2d(xc, kernel, strides,
                                  tuple(lo for lo, _ in pads)), channel_last)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    if divisor_override is not None:
        raise NotImplementedError("avg_pool2d(divisor_override=...) is not "
                                  "ported to paddle_tpu_torch yet")
    channel_last = _layout(data_format)
    xc = to_nchw(x, channel_last)
    kernel, strides, pads = _geometry(xc, kernel_size, stride, padding,
                                      ceil_mode, "avg_pool2d")
    if any(lo != hi or 2 * lo > k for (lo, hi), k in zip(pads, kernel)):
        raise NotImplementedError(
            f"avg_pool2d: padding {pads} (asymmetric, or over half the "
            "window) is not ported to paddle_tpu_torch yet")
    return from_nchw(F.avg_pool2d(xc, kernel, strides,
                                  tuple(lo for lo, _ in pads),
                                  count_include_pad=not exclusive),
                     channel_last)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    channel_last = _layout(data_format)
    out = F.adaptive_avg_pool2d(to_nchw(x, channel_last),
                                _norm_tuple(output_size, 2, "output_size"))
    return from_nchw(out, channel_last)
