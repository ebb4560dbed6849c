"""Per-page quantization for paged KV pools — port of
``paddle_tpu/quantization/kv.py``.

A decode step streams every slot's K/V pages from device memory, so the
pool's bytes are the decode step's bandwidth bill. One-byte codes with a
small scale tensor halve it against bfloat16 and let the same pool hold
twice the resident context.

The quantization unit is one page ``[page_size, NH, HD]``: the unit the
pool allocates, shares through the prefix cache and streams into the
attention kernel, so a page's scales ride beside its codes and sharing,
copy-on-write and eviction never split a group. ``per_head=True`` (the
engine's choice) keeps one scale per (page, head), shape ``[..., NH]``;
``per_head=False`` one per page.

Two storage formats through one quantize/dequantize path:

- ``"int8"``: symmetric int8 codes on the integer grid ``[-127, 127]``;
- ``"fp8"``: ``torch.float8_e4m3fn`` codes scaled so the group's abs-max
  maps to the format's 448 — the same bytes, per-value dynamic range.

The order of operations is the reference's, so codes and scales are
bit-identical to it: abs-max over ``(PS, HD)`` per head, then
``max(amax, eps) / qmax``, then ``x / s``, then round-half-to-even and
clip for int8, or clip and cast for fp8. Both formats snap on
requantization: dequantized grid values requantize to the same codes,
which the engine's copy-on-write and prefix-cache parity rely on.

Arithmetic on fp8 tensors is not supported on the CPU: everything is
widened to float32 first, as :func:`dequantize_per_page` does.
"""
from __future__ import annotations

import torch

__all__ = ["QMAX", "FP8_MAX", "KV_QUANT_DTYPES", "STORAGE",
           "quantize_per_page", "dequantize_per_page", "page_scale_shape",
           "symmetric_int8"]

QMAX = 127.0     # symmetric int8: codes in [-127, 127] (-128 unused)
FP8_MAX = 448.0  # float8_e4m3fn abs-max (no inf; saturating format)
KV_QUANT_DTYPES = ("int8", "fp8")
STORAGE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_EPS = 1e-8      # floor so an all-zero page quantizes to zeros, not NaNs


def symmetric_int8(x, axis, keepdims=False):
    """The symmetric-int8 core shared by the paged-KV path and the weight
    quantization (``weights.py``): ``x`` reduced over ``axis`` (int or
    tuple) to an eps-floored abs-max scale, codes rounded half to even
    and clipped to ``[-127, 127]``. Returns ``(int8 codes, f32 scales)``,
    the scales keepdims or squeezed."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    x = x.float()
    amax = x.abs().amax(dim=axes, keepdim=True)
    s = amax.clamp(min=_EPS) / QMAX
    q = torch.round(x / s).clamp(-QMAX, QMAX).to(torch.int8)
    if not keepdims:
        s = s.squeeze(axes)
    return q, s.float()


def _format(dtype):
    """(storage torch dtype, code abs-max) for a quantized-pool format."""
    if dtype == "int8":
        return torch.int8, QMAX
    if dtype == "fp8":
        return torch.float8_e4m3fn, FP8_MAX
    raise ValueError(f"unknown KV quantization dtype {dtype!r} "
                     f"(one of {KV_QUANT_DTYPES})")


def page_scale_shape(num_pages, num_heads, per_head=True):
    """Shape of the scale tensor beside a ``[num_pages, page_size,
    num_heads, head_dim]`` pool."""
    return (num_pages, num_heads) if per_head else (num_pages,)


def _broadcast(scales, per_head):
    """Scales -> broadcastable against ``[..., PS, NH, HD]``."""
    if per_head:
        return scales[..., None, :, None]   # [..., NH] -> [..., 1, NH, 1]
    return scales[..., None, None, None]    # [...] -> [..., 1, 1, 1]


def quantize_per_page(pages, per_head=True, dtype="int8"):
    """Per-page symmetric quantization of KV pages ``[..., PS, NH, HD]``
    (one page, a gathered set, or a whole pool; leading axes kept).
    Returns ``(codes, f32 scales)``: codes int8 or float8_e4m3fn, scales
    ``[..., NH]`` (``per_head``) or ``[...]``."""
    store, qmax = _format(dtype)
    axes = (-3, -1) if per_head else (-3, -2, -1)  # over PS[, NH], HD
    if dtype == "int8":
        return symmetric_int8(pages, axes)
    x = pages.float()
    scales = x.abs().amax(dim=axes).clamp(min=_EPS) / qmax
    # the cast rounds to the nearest code; the clip guards the one-ulp
    # overshoot float32 division can give at the group's abs-max
    q = (x / _broadcast(scales, per_head)).clamp(-qmax, qmax)
    return q.to(store), scales.float()


def dequantize_per_page(q, scales, dtype=torch.float32, per_head=True):
    """Inverse of :func:`quantize_per_page`: codes of either format
    widened to float32 and multiplied by their group's scale, then cast
    to ``dtype``."""
    return (q.float() * _broadcast(scales, per_head)).to(dtype)
