"""Activation recompute — port of
``paddle_tpu/distributed/utils_recompute.py``.

``recompute(fn, *args)`` runs ``fn`` without keeping its intermediates
and runs it again in the backward (``torch.utils.checkpoint.checkpoint``
with ``use_reentrant=False``): the reference's block-level recompute,
which it traces as ``jax.checkpoint``.

A replay must see what the forward saw. ``checkpoint`` restores the
default CUDA/CPU generators and ``torch.autocast``; the port's own state
it does not know, so :func:`recompute` captures it here and the replay
runs under it: the autocast state of ``paddle_tpu_torch.amp`` (the
backward runs after ``auto_cast`` has exited) and, given ``rng=``, the
state of the ``torch.Generator`` that the segment's dropouts draw from.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from .. import amp

__all__ = ["recompute"]


def recompute(function, *args, rng=None):
    """``function(*args)`` with its activations recomputed in the
    backward. ``rng``: the ``torch.Generator`` the segment draws from,
    rewound for the replay so that it draws the same masks."""
    snap = amp.snapshot()
    rng_state = rng.get_state() if rng is not None else None
    calls = []

    def run(*a):
        replay = bool(calls)
        calls.append(1)
        if not replay or rng is None:
            with amp.restored(snap):
                return function(*a)
        now = rng.get_state()
        rng.set_state(rng_state)
        try:
            with amp.restored(snap):
                return function(*a)
        finally:
            rng.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)
