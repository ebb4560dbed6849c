"""Losses — port of ``paddle_tpu/nn/functional/loss.py:28-102``
(``softmax_with_cross_entropy`` and ``cross_entropy``, hard labels),
``:117-172`` (``fused_linear_cross_entropy``) and ``:175-183``
(``mse_loss``).

``softmax_with_cross_entropy`` is on the autocast black list, so under
O1 and O2 the logits are cast to float32 first. The ops the reference
runs after it each follow the cast rule too (``squeeze2``, and for the
mean ``reduce_sum``, ``elementwise_max`` and ``elementwise_div``,
``:96-101``): under O2 the per-token losses are rounded to the low dtype,
summed in float32, and the mean is divided in the low dtype. Both means
divide by ``max(#labels != ignore_index, 1)``, as the reference does
(``:96-101``, ``:152-155``): an all-ignored batch gives 0, not torch's
NaN. ``mse_loss`` is the black-listed ``mse_loss_op`` and a
``reduce_mean`` / ``reduce_sum``.
"""
from __future__ import annotations

import torch

from ... import amp
from ...kernels.fused_ce import fused_softmax_ce

__all__ = ["cross_entropy", "fused_linear_cross_entropy", "mse_loss"]


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Hard-label softmax cross entropy over the last axis (class
    weights, soft labels and other axes are not ported yet)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    (input,) = amp.cast_inputs("softmax_with_cross_entropy", input)
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    logp = torch.log_softmax(input, dim=-1)
    picked = logp.gather(-1, label.clamp(min=0).unsqueeze(-1)).squeeze(-1)
    keep = label != ignore_index
    loss = torch.where(keep, -picked, torch.zeros((), dtype=logp.dtype,
                                                  device=logp.device))
    (loss,) = amp.cast_inputs("squeeze2", loss)
    if reduction == "mean":
        (num,) = amp.cast_inputs("reduce_sum", loss)
        (den,) = amp.cast_inputs("reduce_sum", keep.to(loss.dtype))
        one = torch.ones((), dtype=loss.dtype, device=loss.device)
        den, one = amp.cast_inputs("elementwise_max", den.sum(), one)
        num, den = amp.cast_inputs("elementwise_div", num.sum(),
                                   torch.maximum(den, one))
        return num / den
    if reduction == "sum":
        (loss,) = amp.cast_inputs("reduce_sum", loss)
        return loss.sum()
    return loss


def fused_linear_cross_entropy(hidden, weight, label, ignore_index=-100):
    """Mean token CE of ``softmax(hidden @ weightᵀ)`` without the
    ``[tokens, vocab]`` logits: hidden ``[..., d]``, weight ``[V, d]`` (the
    tied-embedding orientation), label int ``[...]``. Gradients reach
    hidden and weight through the fused kernels (``kernels/fused_ce.py``).

    The reference's rules (``loss.py:117-155``): under O1/O2 hidden is cast
    to the autocast dtype, and the weight to hidden's dtype, so with a bf16
    residual stream the operands are bf16 without autocast too; the op is
    on neither AMP list. Unlike the reference there is no fallback: on a
    CUDA tensor the kernels run or raise."""
    low = amp.autocast_dtype()
    if low is not None and hidden.dtype != low:
        hidden = hidden.to(low)
    weight = weight.to(hidden.dtype)
    nll = fused_softmax_ce(hidden, weight, label)
    keep = label != ignore_index
    nll = torch.where(keep, nll, torch.zeros((), dtype=nll.dtype,
                                             device=nll.device))
    return nll.sum() / keep.sum().to(nll.dtype).clamp(min=1.0)


def _reduce(loss, reduction):
    if reduction == "mean":
        (loss,) = amp.cast_inputs("reduce_mean", loss)
        return loss.mean()
    if reduction == "sum":
        (loss,) = amp.cast_inputs("reduce_sum", loss)
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    """``(input - label)**2``, reduced (``mse_loss_op``: float32 under
    O1 and O2)."""
    input, label = amp.cast_inputs("mse_loss_op", input, label)
    d = input - label
    return _reduce(d * d, reduction)
