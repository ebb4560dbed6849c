"""Admission-control queue for the serving engine — the port's own copy
of ``paddle_tpu/inference/scheduler.py`` (which has no JAX in it; the
port keeps a copy because it imports nothing of ``paddle_tpu``).

- :class:`RequestQueue` — priority-ordered: requests sort by
  ``(-priority, seq)``, FIFO (arrival ``seq``) within a priority class.
- **shed policies** — when the queue is at ``max_queue`` the engine
  asks :meth:`RequestQueue.pick_shed_victim` who should go:

  - ``"reject"`` — nobody queued; the INCOMING request is refused
    (:class:`QueueFullError`).
  - ``"shed_oldest"`` — drop the oldest queued request to make room.
  - ``"shed_lowest_priority"`` — drop the newest request of the
    strictly lowest priority class, but only when the incoming request
    outranks it; otherwise the incoming request is rejected.
"""
from __future__ import annotations

import bisect

__all__ = ["QueueFullError", "SHED_POLICIES", "RequestQueue"]

SHED_POLICIES = ("reject", "shed_oldest", "shed_lowest_priority")


class QueueFullError(RuntimeError):
    """Admission refused: the queue is at ``max_queue`` and the shed
    policy found no queued victim to drop for the incoming request."""

    def __init__(self, msg, depth=None, policy=None):
        super().__init__(msg)
        self.depth = depth
        self.policy = policy


class RequestQueue:
    """Priority-ordered pending-request queue (see module docstring).

    Items are any objects with ``.priority`` (int, higher = more
    urgent), ``.seq`` (unique monotone arrival counter) and ``.uid``
    (at most one queued occurrence per uid). A uid -> sort-key map
    makes ``remove``/``find_uid`` a bisect on the stored key instead
    of a linear scan."""

    def __init__(self):
        self._items = []  # sorted [(key, req)]; keys unique via seq
        self._keys = {}   # uid -> the key the uid was inserted under

    @staticmethod
    def _key(req):
        return (-int(req.priority), int(req.seq))

    # -- mutation ------------------------------------------------------------
    def push(self, req):
        """Insert in priority order (FIFO within a class). Also the
        requeue path for preempted requests: ``req.seq`` is preserved
        across preemption, so a victim re-enters AHEAD of later
        arrivals of its own priority."""
        key = self._key(req)
        bisect.insort(self._items, (key, req))
        self._keys[req.uid] = key

    def pop(self, i=0):
        req = self._items.pop(i)[1]
        self._keys.pop(req.uid, None)
        return req

    def _locate(self, uid):
        """Index of ``uid``'s entry via its stored key, or -1. The
        probe tuple ``(key,)`` sorts immediately BEFORE ``(key, req)``
        (tuple-prefix ordering), so bisect lands on the entry without
        ever comparing two request objects."""
        key = self._keys.get(uid)
        if key is None:
            return -1
        i = bisect.bisect_left(self._items, (key,))
        return i if i < len(self._items) and self._items[i][0] == key \
            else -1

    def remove(self, req):
        """Remove this exact request (by uid); returns True if found."""
        i = self._locate(req.uid)
        if i < 0:
            return False
        del self._items[i]
        del self._keys[req.uid]
        return True

    # -- lookup --------------------------------------------------------------
    def find_uid(self, uid):
        i = self._locate(uid)
        return self._items[i][1] if i >= 0 else None

    def pick_shed_victim(self, incoming_priority, policy):
        """The queued request the ``policy`` would drop to admit an
        incoming request of ``incoming_priority`` — or None, meaning
        the incoming request itself must be rejected. Does not mutate;
        the engine owns the actual shed (spans, metrics, completion)."""
        if policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {policy!r}")
        if policy == "reject" or not self._items:
            return None
        if policy == "shed_oldest":
            return min((r for _, r in self._items), key=lambda r: r.seq)
        # shed_lowest_priority: the tail of the sorted order is the
        # lowest class's newest arrival; only sheddable when the
        # incoming request strictly outranks it
        victim = self._items[-1][1]
        return victim if victim.priority < incoming_priority else None

    # -- container protocol --------------------------------------------------
    def __len__(self):
        return len(self._items)

    def __bool__(self):
        return bool(self._items)

    def __iter__(self):
        return (r for _, r in self._items)

    def __getitem__(self, i):
        return self._items[i][1]

    def __repr__(self):
        return (f"RequestQueue({[(r.uid, r.priority) for _, r in self._items]})")
