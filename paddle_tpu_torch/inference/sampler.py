"""Token selection — port of ``paddle_tpu/inference/sampler.py``.

Per-sequence math over ``[..., V]`` float32 logits, shared by the
serving engine's first-token sample, its decode steps and the
speculative verify:

- :func:`greedy`, :func:`scale_by_temp` (same ``1e-6`` floor),
  :func:`apply_top_k` (exact only: the reference's ``approx=True`` is
  the TPU-native ``approx_max_k``, which the JAX engine never passes),
  and :func:`sample_token`.
- :func:`spec_accept`, the exact acceptance-rejection chain of one
  speculative round, batched over slots.
- Randomness is explicit. :func:`gumbel_noise` draws from a caller's
  ``torch.Generator``; :func:`sample_token` and :func:`spec_accept` take
  their noise as arguments and returns ``argmax(logits / temp + g)`` — what
  ``jax.random.categorical`` computes from its own Gumbel draw. The two
  frameworks draw different numbers from the same seed, so sampled
  streams are not bit-identical to the reference; greedy streams are.
"""
from __future__ import annotations

import torch

__all__ = ["greedy", "scale_by_temp", "apply_top_k", "gumbel_noise",
           "sample_token", "spec_accept"]

_TEMP_FLOOR = 1e-6   # the reference's floor: temp=0 divides by this but
#                      the greedy branch is selected
_LOG_FLOOR = 1e-30   # log() guard for zero-probability residual bins


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


def spec_accept(p_logits, q_logits, proposed, temp, uniforms=None,
                gumbel=None):
    """Exact acceptance-rejection over one speculative round (reference
    ``spec_accept``, ``paddle_tpu/inference/sampler.py:74``), batched
    over the leading axes.

    ``p_logits`` ``[..., k+1, V]``: the target's logits at the k+1
    verified positions (row j conditions on the proposals before j).
    ``q_logits`` ``[..., k, V]``: the draft's logits the proposals were
    drawn from. ``proposed`` ``[..., k]`` ints; ``temp`` ``[...]``.
    The randomness is the caller's: ``uniforms`` ``[..., k]`` in [0, 1)
    for the acceptance tests and ``gumbel`` ``[..., V]`` standard Gumbel
    noise for the correction draw; ``None`` for both means every row is
    greedy.

    Returns ``(chain [..., k+1], n_acc [...])`` int64: the first
    ``n_acc + 1`` entries of ``chain`` are the round's tokens, ``n_acc``
    accepted proposals then one correction (or bonus) token; the rest
    are the target's argmax continuation, never emitted.

    - ``temp == 0``: accept while ``argmax(p_i) == proposed[i]``; the
      correction is ``argmax(p_{n_acc})``.
    - ``temp > 0``, with ``p = softmax(p_i / t)`` and ``q = softmax(q_i /
      t)``: accept while ``u_i * q(d_i) < p(d_i)``; at the first
      rejection draw from the residual ``normalize(max(p - q, 0))``
      (``p`` itself where the residual is all zero); when all k are
      accepted, draw the bonus from ``p_k``. The draw is the Gumbel-max
      ``argmax(log(r + 1e-30) + gumbel)``, what the reference's
      ``jax.random.categorical`` computes from its own noise."""
    k = proposed.shape[-1]
    p_logits = p_logits.float()
    q_logits = q_logits.float()
    proposed = proposed.long()
    tgt = greedy(p_logits)                                   # [..., k+1]
    accept = tgt[..., :k] == proposed
    sampled = None
    if uniforms is not None:
        t = temp if isinstance(temp, torch.Tensor) else torch.full(
            proposed.shape[:-1], float(temp), device=p_logits.device)
        sampled = t > 0
        p = torch.softmax(scale_by_temp(p_logits, t[..., None]), -1)
        q = torch.softmax(scale_by_temp(q_logits, t[..., None]), -1)
        idx = proposed[..., None]
        s_accept = uniforms * q.gather(-1, idx)[..., 0] < \
            p[..., :k, :].gather(-1, idx)[..., 0]
        accept = torch.where(sampled[..., None], s_accept, accept)
    # leading-run length: accepts up to (not past) the first rejection
    n_acc = accept.long().cumprod(-1).sum(-1)
    corr = tgt.gather(-1, n_acc[..., None])[..., 0]
    if sampled is not None:
        # the correction at position n_acc: the residual after a
        # rejection, p_k for the all-accepted bonus (q padded with zeros
        # so both are one path)
        V = p.shape[-1]
        row = n_acc[..., None, None].expand(*n_acc.shape, 1, V)
        p_n = p.gather(-2, row)[..., 0, :]
        q_n = torch.cat([q, torch.zeros_like(p[..., :1, :])], -2).gather(
            -2, row)[..., 0, :]
        resid = (p_n - q_n).clamp(min=0.0)
        tot = resid.sum(-1, keepdim=True)
        resid = torch.where(tot > 0, resid / tot, p_n)
        drawn = torch.argmax(torch.log(resid + _LOG_FLOOR) + gumbel, -1)
        corr = torch.where(sampled, drawn, corr)
    j = torch.arange(k + 1, device=tgt.device)
    prop_pad = torch.cat([proposed, torch.zeros_like(proposed[..., :1])],
                         -1)
    n = n_acc[..., None]
    chain = torch.where(j < n, prop_pad,
                        torch.where(j == n, corr[..., None], tgt))
    return chain, n_acc
