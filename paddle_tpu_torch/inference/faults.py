"""Deterministic fault injection for the serving engine — the port's own
copy of ``paddle_tpu/inference/faults.py`` (which has no JAX in it; the
port keeps a copy because it imports nothing of ``paddle_tpu``).

Every kind is a one-line, deterministic event, so a test can show the
engine's contract: an injected per-request fault fails exactly its
target and the engine goes on serving the rest.

>>> inj = FaultInjector()
>>> inj.inject("prefill_error", uid=3)          # 3's next chunk raises
>>> inj.inject("page_exhaustion", count=2)      # next 2 plans "fail"
>>> inj.inject("nonfinite_logits", uid=1)       # 1's decode goes NaN
>>> inj.inject("stall", seconds=0.2)            # one slow dispatch
>>> eng = ServingEngine(cfg, params, fault_injector=inj)

Injection points, all on the host (no serving program changes, so no
CUDA graph is captured for them):

- ``page_exhaustion`` — admission planning behaves as if the page pool
  could not cover the request (it queues, looks ahead or preempts as
  under real pressure).
- ``prefill_error`` / ``decode_error`` — :class:`InjectedFault` raised
  at the dispatch site before the replay; the engine fails the target
  with finish_reason ``"error"`` and keeps stepping.
- ``nonfinite_logits`` — the target of a decode dispatch fails with
  finish_reason ``"nonfinite"``.
- ``stall`` — sleeps ``seconds`` inside one dispatch region: the
  deterministic way to drive a deadline past mid-stream.
- ``replica_down`` — the death of the whole engine:
  :class:`ReplicaDown` raised at the next step boundary, before any
  per-request handling, so it escapes ``step()`` through the teardown
  path as a real crash would.

Arms are consumed as they fire (``count`` firings each); ``log`` records
every fired fault. The reference's ``bind_journal`` (the fleet journal)
is not ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["FAULT_KINDS", "InjectedFault", "ReplicaDown", "FaultInjector"]

FAULT_KINDS = ("page_exhaustion", "prefill_error", "decode_error",
               "nonfinite_logits", "stall", "replica_down")


class InjectedFault(RuntimeError):
    """Raised at an engine dispatch site by an armed injector. Carries
    the kind and the uid of the request the fault targets (None when the
    arm was untargeted and no request was in context)."""

    def __init__(self, kind, uid=None):
        super().__init__(f"injected fault {kind!r}"
                         + (f" (uid {uid})" if uid is not None else ""))
        self.kind = kind
        self.uid = uid


class ReplicaDown(RuntimeError):
    """An injected death of the whole engine. Not an
    :class:`InjectedFault`: the per-request handlers must not absorb it —
    it escapes ``step()`` as a real crash would."""


@dataclass
class _Arm:
    kind: str
    uid: object = None        # target request uid (None = first match)
    count: int = 1            # remaining firings
    seconds: float = 0.0      # stall duration
    fired: int = 0


@dataclass
class _Fired:
    kind: str
    uid: object
    t: float = field(default_factory=time.time)


class FaultInjector:
    """Deterministic fault scheduler (see the module docstring). An
    engine consults it at its admission and dispatch sites."""

    def __init__(self):
        self._arms = []
        self.log = []  # _Fired records, in firing order

    def inject(self, kind, uid=None, count=1, seconds=0.0):
        """Arm ``count`` firings of ``kind``, optionally targeting one
        request ``uid``. ``seconds`` is the sleep of a ``stall`` arm.
        Returns the injector (chainable)."""
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (one of {FAULT_KINDS})")
        if int(count) < 1:
            raise ValueError("count must be >= 1")
        self._arms.append(_Arm(kind, uid=uid, count=int(count),
                               seconds=float(seconds)))
        return self

    @property
    def armed(self):
        """Kinds with firings remaining."""
        return sorted({a.kind for a in self._arms if a.count > 0})

    def fired(self, kind=None):
        """Fired-fault records, optionally filtered by kind."""
        return [f for f in self.log if kind is None or f.kind == kind]

    # -- engine-facing hooks -------------------------------------------------
    def fire(self, kind, uid=None, uids=None):
        """Consume one matching arm. ``uid`` is the single request in
        context (admission, prefill); ``uids`` the requests in context
        (decode). A targeted arm fires only when its uid is in context;
        an untargeted arm adopts the context's (first) uid. Returns
        ``{"uid": ..., "seconds": ...}`` or None."""
        for arm in self._arms:
            if arm.kind != kind or arm.count <= 0:
                continue
            if arm.uid is not None:
                if uid is not None and arm.uid != uid:
                    continue
                if uids is not None and arm.uid not in uids:
                    continue
                target = arm.uid
            else:
                target = uid if uid is not None else (
                    uids[0] if uids else None)
            arm.count -= 1
            arm.fired += 1
            self.log.append(_Fired(kind, target))
            return {"uid": target, "seconds": arm.seconds}
        return None

    def maybe_raise(self, kind, uid=None, uids=None):
        """:meth:`fire`, and raise :class:`InjectedFault` on a hit — the
        dispatch-exception kinds, called before the replay."""
        hit = self.fire(kind, uid=uid, uids=uids)
        if hit is not None:
            raise InjectedFault(kind, uid=hit["uid"])

    def stall(self, uids=None):
        """Sleep through an armed ``stall``. Returns the seconds slept
        when an arm fired (0.0 is a valid armed duration) and None when
        none was armed, so the caller can count every firing."""
        hit = self.fire("stall", uids=uids)
        if hit is None:
            return None
        if hit["seconds"] > 0:
            time.sleep(hit["seconds"])
        return hit["seconds"]
