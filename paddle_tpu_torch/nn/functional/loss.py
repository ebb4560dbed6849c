"""Cross entropy — port of ``paddle_tpu/nn/functional/loss.py:28-102``
(``softmax_with_cross_entropy`` and ``cross_entropy``, hard labels) and
``:117-172`` (``fused_linear_cross_entropy``).

``cross_entropy`` is on the autocast black list, so under O1 the logits
are cast to float32 first. Both means divide by ``max(#labels !=
ignore_index, 1)``, as the reference does (``loss.py:96-101``,
``:152-155``): an all-ignored batch gives 0, not torch's NaN.
"""
from __future__ import annotations

import torch

from ... import amp
from ...kernels.fused_ce import fused_softmax_ce

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


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
    if reduction == "mean":
        return loss.sum() / keep.sum().to(loss.dtype).clamp(min=1.0)
    if reduction == "sum":
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
