"""Cross entropy — port of ``paddle_tpu/nn/functional/loss.py:28-102``
(``softmax_with_cross_entropy`` and ``cross_entropy``, hard labels).

The op is on the autocast black list, so under O1 the logits are cast
to float32 first. The mean divides by ``max(#labels != ignore_index,
1)``, as the reference does (``loss.py:96-101``): an all-ignored batch
gives 0, not torch's NaN.
"""
from __future__ import annotations

import torch

from ... import amp

__all__ = ["cross_entropy"]


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
