"""Token selection — port of ``paddle_tpu/inference/sampler.py``.

Per-sequence math over ``[..., V]`` float32 logits, shared by the
serving engine's first-token sample and its decode steps:

- :func:`greedy`, :func:`scale_by_temp` (same ``1e-6`` floor),
  :func:`apply_top_k` (exact only: the reference's ``approx=True`` is
  the TPU-native ``approx_max_k``, which the JAX engine never passes),
  and :func:`sample_token`.
- Randomness is explicit. :func:`gumbel_noise` draws from a caller's
  ``torch.Generator``; :func:`sample_token` takes that noise as an
  argument and returns ``argmax(logits / temp + g)`` — what
  ``jax.random.categorical`` computes from its own Gumbel draw. The two
  frameworks draw different numbers from the same seed, so sampled
  streams are not bit-identical to the reference; greedy streams are.
"""
from __future__ import annotations

import torch

__all__ = ["greedy", "scale_by_temp", "apply_top_k", "gumbel_noise",
           "sample_token"]

_TEMP_FLOOR = 1e-6   # the reference's floor: temp=0 divides by this but
#                      the greedy branch is selected


def greedy(logits):
    """argmax over the vocab axis (temperature-0 decoding)."""
    return torch.argmax(logits, dim=-1)


def scale_by_temp(logits, temp):
    """``logits / temp`` with the reference's floor (only consumed when
    ``temp > 0``). ``temp`` is a float or a tensor broadcast against the
    batch axes of ``logits``."""
    if isinstance(temp, torch.Tensor):
        return logits / temp.clamp(min=_TEMP_FLOOR).unsqueeze(-1)
    return logits / max(float(temp), _TEMP_FLOOR)


def apply_top_k(logits, top_k, approx=False):
    """Mask everything below the k-th logit to -1e30 (exact top-k)."""
    if approx:
        raise NotImplementedError(
            "approx top-k is the TPU-native approx_max_k; the port "
            "implements exact top-k only")
    if not top_k:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device), logits)


def gumbel_noise(shape, generator, device):
    """Standard Gumbel noise ``-log(-log(u))`` drawn from ``generator``
    (u uniform, floored at the smallest normal float32 so the logs stay
    finite)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits, temp, gumbel=None):
    """One token per row of ``[..., V]`` float32 logits: the Gumbel-max
    draw ``argmax(logits / temp + gumbel)`` where ``temp > 0``, argmax
    elsewhere (both computed, selected per row — the engine's per-slot
    semantics). ``gumbel=None`` means every row is greedy."""
    g = greedy(logits)
    if gumbel is None:
        return g
    drawn = torch.argmax(scale_by_temp(logits, temp) + gumbel, dim=-1)
    t = temp if isinstance(temp, torch.Tensor) else \
        torch.tensor(float(temp), device=logits.device)
    return torch.where(t > 0, drawn, g)
