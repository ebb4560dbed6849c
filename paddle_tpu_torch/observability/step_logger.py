"""Structured per-step JSONL event log — port of
``paddle_tpu/observability/step_logger.py``.

Counters answer "what is the rate right now"; the StepLogger keeps the
*sequence* — one JSON object per line, append-only, cheap enough to
leave on in production and grep/pandas-read afterwards. Schema: every
record carries ``ts`` (unix seconds) and ``event``; all other fields
are caller-chosen scalars::

    {"ts": 1754200000.1, "event": "serving_step", "step": 42,
     "tokens": 3, "queue_depth": 7, "active_slots": 4, "dt_s": 0.0017}

Thread-safe (one lock around the write+flush) and usable as a context
manager. Non-JSON-serializable values are stringified rather than
dropping the record — a telemetry line that loses precision beats a
crashed serving loop."""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["StepLogger"]


class StepLogger:
    @classmethod
    def coerce(cls, path_or_logger):
        """``(logger_or_None, owns)`` from a user-facing ``step_log``
        argument: a path opens an OWNED logger (caller must close it);
        an existing StepLogger (or None) passes through un-owned. The
        one implementation of the ownership convention shared by
        ServingEngine and TelemetryCallback."""
        if isinstance(path_or_logger, (str, bytes, os.PathLike)):
            return cls(path_or_logger), True
        return path_or_logger, False

    def __init__(self, path, flush_every=1):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.path = path
        self._fh = open(path, "a")
        self._lock = threading.Lock()
        self._flush_every = max(int(flush_every), 1)
        self._since_flush = 0

    @property
    def closed(self):
        return self._fh.closed

    def log(self, event, **fields):
        rec = {"ts": time.time(), "event": str(event)}
        rec.update(fields)
        try:
            # allow_nan=False: a diverged NaN loss must not write a
            # bare NaN token strict parsers (jq, JSON.parse) choke on.
            # default= coerces non-JSON types (0-d torch tensors, numpy
            # scalars) in place instead of raising mid-training.
            line = json.dumps(rec, allow_nan=False, default=_jsonable)
        except (TypeError, ValueError):
            # default= is never consulted for NATIVE non-finite floats
            # (json raises ValueError directly) — re-map the whole
            # record through the shared coercion
            line = json.dumps({k: _jsonable(v) for k, v in rec.items()},
                              allow_nan=False, default=str)
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._fh.flush()
                self._since_flush = 0

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _jsonable(v):
    # one strict-JSON convention for non-finite floats, shared with
    # registry.snapshot() so JSONL records and snapshots never diverge
    from .registry import _json_num
    if isinstance(v, float):
        return _json_num(v)
    try:
        json.dumps(v, allow_nan=False)
        return v
    except (TypeError, ValueError):
        pass
    # a 0-d torch tensor or numpy scalar: its Python value (float() of
    # a many-element tensor raises RuntimeError, not TypeError)
    if getattr(v, "shape", None) == () or getattr(v, "ndim", None) == 0:
        v = v.item()
        if isinstance(v, bool):
            return v
        if isinstance(v, int):
            return v
    try:
        return _jsonable(float(v))
    except (TypeError, ValueError, RuntimeError):
        return str(v)
