"""Loss layers — port of ``paddle_tpu/nn/layer/loss.py``
(``CrossEntropyLoss``, ``MSELoss``) over the port's functional losses.
``CrossEntropyLoss`` takes hard labels over the last axis; class weights,
soft labels, another axis and ``use_softmax=False`` are not ported yet
and raise."""
from __future__ import annotations

import torch

from . import functional as F

__all__ = ["CrossEntropyLoss", "MSELoss"]


class CrossEntropyLoss(torch.nn.Module):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        for what, on in (("weight", weight is not None),
                         ("soft_label", soft_label), ("axis", axis != -1),
                         ("use_softmax=False", not use_softmax)):
            if on:
                raise NotImplementedError(
                    f"CrossEntropyLoss({what}) is not ported to "
                    "paddle_tpu_torch yet")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction)


class MSELoss(torch.nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)
