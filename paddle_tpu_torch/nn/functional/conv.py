"""2-D convolution — port of ``paddle_tpu/nn/functional/conv.py``
(``_norm_tuple``/``_norm_padding`` ``:21-51``, ``_conv_nd`` ``:54-67``,
``_conv`` ``:80-104``, ``conv2d``).

The reference lowers to ``lax.conv_general_dilated``, an XLA op with no
Pallas body; the port runs ``torch.nn.functional.conv2d`` (cuDNN on the
card, oneDNN on the CPU).

- ``padding`` takes an int, one int an axis, ``[lo, hi]`` an axis as 2n
  ints or as n pairs, and ``"SAME"``/``"VALID"`` in any case; anything
  else raises (n + 2 pairs too, which the reference's 2n-int branch
  catches first and fails on).
  ``"SAME"`` pads as XLA does: ``total = max((ceil(in / s) - 1) s +
  (k - 1) d + 1 - in, 0)``, ``lo = total // 2``, ``hi = total - lo``,
  so at stride 2 the extra element goes to the high side. Where the two
  sides differ the input is padded explicitly (``F.pad``) first.
- ``data_format="NHWC"`` permutes ``x`` to an NCHW view (a
  ``channels_last`` tensor when ``x`` is contiguous, which cuDNN runs
  without a copy) and the result back. The weight is ``[out, in/groups,
  kh, kw]`` in both formats, as the reference's ``"OIHW"``.
- Under O1 ``x`` and ``weight`` are cast by the white-listed name
  ``conv2d``; the bias is added after the op, outside it, so a float32
  bias promotes the bf16 product to float32 (``:96-103``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ... import amp

__all__ = ["conv2d"]


def _norm_tuple(v, n, name="value"):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    v = tuple(int(i) for i in v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        raise ValueError(f"{name} must have {n} elements, got {v}")
    return v


def _norm_padding(padding, n):
    """``[(lo, hi)] * n`` or the string ``"SAME"``/``"VALID"``."""
    if isinstance(padding, str):
        pad = padding.upper()
        if pad not in ("SAME", "VALID"):
            raise ValueError(f"bad padding {padding!r}")
        return pad
    if isinstance(padding, (int, np.integer)):
        return [(int(padding),) * 2] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, (int, np.integer))
                                     for p in padding):
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if len(padding) == n and all(isinstance(p, (list, tuple))
                                 and len(p) == 2 for p in padding):
        return [tuple(int(x) for x in p) for p in padding]
    raise ValueError(f"bad padding {padding!r}")


def same_pads(sizes, kernel, strides, dilations):
    """XLA's ``"SAME"`` pairs (``lax.padtype_to_pads`` over the dilated
    window)."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, strides, dilations):
        total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def to_nchw(x, channel_last):
    return x.permute(0, 3, 1, 2) if channel_last else x


def from_nchw(x, channel_last):
    return x.permute(0, 2, 3, 1) if channel_last else x


def pad_or_pass(x, pads):
    """``(x, symmetric pads)``: ``x`` (NCHW) zero-padded explicitly where
    a side pair differs, so that the op's own padding is symmetric."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    flat = []
    for lo, hi in reversed(pads):       # F.pad: last axis first
        flat += [lo, hi]
    return F.pad(x, flat), (0,) * len(pads)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format {data_format!r}")
    channel_last = data_format == "NHWC"
    strides = _norm_tuple(stride, 2, "stride")
    dilations = _norm_tuple(dilation, 2, "dilation")
    pads = _norm_padding(padding, 2)
    x, weight = amp.cast_inputs("conv2d", x, weight)
    xc = to_nchw(x, channel_last)
    if pads == "VALID":
        pads = [(0, 0)] * 2
    elif pads == "SAME":
        pads = same_pads(xc.shape[2:], weight.shape[2:], strides, dilations)
    xc, sym = pad_or_pass(xc, pads)
    out = from_nchw(F.conv2d(xc, weight, None, strides, sym, dilations,
                             int(groups)), channel_last)
    if bias is not None:
        out = out + (bias if channel_last else bias.reshape(1, -1, 1, 1))
    return out
