"""The serving programs compiled once: CUDA graphs, the port's
counterpart of the reference's ``jax.jit`` of each serving program
(``paddle_tpu/inference/serving.py:1250-1259``: ``prefill``,
``decode_step``, ``decode_block`` with K static, ``copy_page``,
``sample_first`` and ``mixed``, the pools donated).

A program is a function ``fn(*fixed, *inputs)`` of tensors only
(``serving._build_serving_fns``). ``fixed`` are the tensors that keep
their addresses for the engine's lifetime: the weights, the K/V pools
and their scales, which the programs write in place. ``inputs`` are the
per-dispatch state: host arrays (block tables, lengths, tokens, ...)
and device buffers the caller fills itself (the Gumbel noise).

- :class:`GraphProgram` warms ``fn`` up eagerly on a side stream (the
  first call of a kernel wrapper runs ``nvcc`` and loads the library;
  neither may run inside a capture), then captures one
  ``torch.cuda.CUDAGraph`` over static input tensors. ``replay(*host)``
  copies the host arrays into place — all of a program's host inputs
  are views of one device buffer, uploaded from one pinned host buffer
  with one copy — replays, and returns the static outputs, which the
  next replay of the same program overwrites.
- :class:`EagerProgram` has the same interface and calls the function
  on fresh tensors: the CPU, where CUDA graphs do not exist, and the
  engine's ``_capture=False``.
- :class:`GraphPool` is what an engine's graphs share: one memory pool
  (they never run at the same time) and one side stream for warm-up and
  capture.

Each program carries the graph-capture census of
``observability/compile_tracker.py``: ``captures`` (1 for a graph; 0
for an eager program until its first call, then 1 — where it first
loads its kernels, as a jit compiles at its first call) and
``replays`` (its dispatches).

A capture runs with Python's cyclic garbage collector off, and an
engine's first capture starts from a collected heap: the collector can
run at any allocation, and destroying a dead engine's graph while another
stream captures invalidates that capture (CUDA forbids the call), which
then fails at its next launch.

A replay runs no Python, so the kernel wrappers' launch counters
(``kernels/paged_attention.py``) would not move. Each graph records the
counters' deltas over its capture, takes them back (a capture launches
nothing), and adds them at every replay: a count still reads the
kernel launches that ran. A capture that fails raises; nothing falls
back to eager dispatch.
"""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from ..kernels import paged_attention as _pa

__all__ = ["GraphPool", "GraphProgram", "EagerProgram", "COUNTERS"]

# the launch counters of the kernels the serving programs launch
COUNTERS = ((_pa, ("launches", "split_launches", "quant_launches",
                   "quant_split_launches")),)
_ALIGN = 16     # byte offset of each host input in the staging buffer
_WARMUP = 2     # eager calls on the side stream before a capture


def _read_counters():
    return [getattr(mod, name) for mod, names in COUNTERS for name in names]


def _add_counters(deltas):
    it = iter(deltas)
    for mod, names in COUNTERS:
        for name in names:
            setattr(mod, name, getattr(mod, name) + next(it))


class GraphPool:
    """What the graphs of one engine share: one memory pool and one side
    stream."""

    def __init__(self, device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        # dead engines' graphs go now, not inside a capture
        gc.collect()


class _Staging:
    """Host inputs of one program as views of one device byte buffer,
    filled from one pinned host buffer by one asynchronous copy. An event
    after the copy guards the host buffer: the host writes it again only
    once the previous copy from it has run."""

    def __init__(self, examples, device):
        offs, n = [], 0
        for a in examples:
            n = -(-n // _ALIGN) * _ALIGN
            offs.append(n)
            n += a.nbytes
        n = max(n, 1)
        self.dev = torch.zeros(n, dtype=torch.uint8, device=device)
        self.host = torch.zeros(n, dtype=torch.uint8, pin_memory=True)
        self.dev_views, self.host_views = [], []
        for a, off in zip(examples, offs):
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
            self.dev_views.append(
                self.dev[off:off + a.nbytes].view(dt).view(a.shape))
            self.host_views.append(
                self.host[off:off + a.nbytes].view(dt).view(a.shape).numpy())
            self.host_views[-1][...] = a
        self.dev.copy_(self.host)
        self.copied = torch.cuda.Event()

    def upload(self, arrays):
        self.copied.synchronize()
        for view, a in zip(self.host_views, arrays):
            view[...] = a
        self.dev.copy_(self.host, non_blocking=True)
        self.copied.record()


class GraphProgram:
    """``fn(*fixed, *host inputs, *buffers)`` captured once as a CUDA
    graph. ``host`` are example numpy arrays that fix the host inputs'
    shapes and dtypes (the capture runs on these values: the engine
    passes an idle state whose writes land on the trash page);
    ``buffers`` the device tensors the caller fills between replays.
    ``_WARMUP`` eager calls on the pool's side stream come first.
    ``during_capture``: a context entered around the capture alone (a
    mesh engine's collective census counts one run there)."""

    captures = 1

    def __init__(self, gp, fn, fixed, host, buffers=(),
                 during_capture=None):
        self.replays = 0
        self._staging = _Staging([np.ascontiguousarray(a) for a in host],
                                 gp.device)
        self.buffers = tuple(buffers)
        args = (*fixed, *self._staging.dev_views, *self.buffers)
        gp.stream.wait_stream(torch.cuda.current_stream(gp.device))
        with torch.cuda.stream(gp.stream):
            for _ in range(_WARMUP):
                fn(*args)
        torch.cuda.current_stream(gp.device).wait_stream(gp.stream)
        warm = _read_counters()
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with during_capture or contextlib.nullcontext(), \
                    torch.cuda.graph(self.graph, pool=gp.pool,
                                     stream=gp.stream):
                self.outputs = fn(*args)
        finally:
            if collecting:
                gc.enable()
        # the capture launched nothing: its counts become each replay's
        self.deltas = [a - b for a, b in zip(_read_counters(), warm)]
        _add_counters([-d for d in self.deltas])

    def replay(self, *host):
        """Upload ``host`` (numpy arrays, in the example's order), replay,
        return the static outputs."""
        self._staging.upload(host)
        self.graph.replay()
        _add_counters(self.deltas)
        self.replays += 1
        return self.outputs


class EagerProgram:
    """The same interface without a graph: ``replay`` calls
    ``get_fn()`` (looked up at every call, so a caller may wrap the
    program) on the fixed tensors, fresh copies of the host arrays (numpy
    arrays and scalars; anything else passes as it is) on ``device`` and
    the buffers."""

    def __init__(self, get_fn, fixed, device, buffers=()):
        self._get_fn = get_fn
        self._fixed = tuple(fixed)
        self._dev = device
        self.buffers = tuple(buffers)
        self.replays = 0

    @property
    def captures(self):
        return 1 if self.replays else 0

    def replay(self, *host):
        args = [torch.tensor(np.asarray(a), device=self._dev)
                if isinstance(a, (np.ndarray, np.generic)) else a
                for a in host]
        self.replays += 1
        return self._get_fn()(*self._fixed, *args, *self.buffers)
