"""Gradient clipping by global norm — port of ``paddle_tpu/nn/clip.py``
(``ClipGradByGlobalNorm``) with the formula of the compiled train step
(``paddle_tpu/parallel/api.py:271-279``):

    gnorm = sqrt(sum over tensors of sum(g.float() ** 2))
    scale = clip_norm / max(gnorm, clip_norm)
    g     = (g.float() * scale).to(g.dtype)

``torch.nn.utils.clip_grad_norm_`` is not used: it divides by
``gnorm + 1e-6``. Nothing syncs with the host: the norm stays a device
scalar.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip(self, grads):
        """The list of gradients, scaled to a global norm of at most
        ``clip_norm``."""
        return self.clip_and_norm(grads)[0]

    def clip_and_norm(self, grads):
        """``(clipped, gnorm, sq_sums)``: the clipped gradients, the
        global norm and the per-tensor sums of squares it was taken from
        (0-d float32 tensors), which the numerics pass reuses as the
        reference's ``_clip_and_norm`` shares them
        (``paddle_tpu/parallel/api.py:254-299``)."""
        sqs = [g.float().square().sum() for g in grads]
        gnorm = torch.stack(sqs).sum().sqrt()
        scale = self.clip_norm / torch.clamp(gnorm, min=self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads], gnorm, sqs
