"""Paged KV-cache continuous-batching serving engine — port of
``paddle_tpu/inference/serving.py``.

- :class:`PagedKVCache` — per-layer page pools ``[num_pages, page_size,
  NH, HD]`` (K and V; float, or int8/fp8 codes with per-page-per-head
  scales) plus the host-side allocator: trash page 0, a LIFO free list,
  refcounts, and the content-addressed prefix cache (chained blake2b
  page digests, LRU of cache-only pages), checked by ``verify()``.
- :func:`_build_serving_fns` — the serving programs: one chunked
  prefill chunk, one decode step over every slot, a fused block of
  ``K`` decode steps whose EOS and budget masks stay on the device, the
  mixed-step program (prefill chunks and decode rows of every slot in
  one ragged dispatch), the copy-on-write page copy and the first-token
  sample. Over a quantized pool every write dequantizes the pages it
  touches, inserts the new rows in float32 and requantizes them (the
  reference's ``write_decode``/``write_prefill``/``mixed_write``).
- :class:`ServingEngine` — the continuous-batching loop: admission with
  prefix-cache planning and a bounded lookahead, decode-priority
  chunked prefill and the adaptive decode-block policy, or with
  ``mixed_step=True`` one mixed dispatch a step, ported verbatim so
  that the port dispatches the same sequence of programs as the
  reference engine on the same traffic.
- speculative decoding (``speculative=``, ``draft_k=``;
  ``inference/speculative.py``): under steady decode a draft proposes
  ``k`` tokens and the target verifies ``k + 1`` positions in one
  dispatch — the verify program, a ``q_len = k + 1`` row a slot on the
  ragged kernel — or, with ``mixed_step``, as verify rows (kind 3) of
  the mixed program.

Every attention — the decode step, each step of a fused block, and each
prefill chunk (one slot with ``q_len = C`` and ``kv_len = base + C``,
the row the reference's mixed-step dispatch hands its ragged kernel) —
goes through ``kernels.paged_attention``: on a CUDA device that is the
hand-written kernel, which dequantizes int8/fp8 pages as it reads them.
``attention="torch"`` selects the plain PyTorch version instead; it
exists to hold the kernel against it and nothing on the main path
selects it. The attention returns q's dtype, as the reference's Pallas
route does; the reference's gather route returns float32 over a
quantized pool (ROADMAP C10).

The reference jits each program once, the pools donated
(``serving.py:1250-1259``). On a CUDA device the engine captures each
program it dispatches as a CUDA graph in its constructor
(``inference/graphs.py``) and replays it at every dispatch; the pools,
their scales and the weights keep their addresses for the engine's
lifetime and are updated in place (``index_put_``/``copy_``). The
first-token sample ends in a host read and stays eager. On the CPU,
and with ``_capture=False``, every program runs eagerly.
Sampling uses one ``torch.Generator`` per sampled slot, seeded with the
request's seed, one Gumbel draw of ``[V]`` per emitted token: a
request's draws do not depend on when it was admitted or who shares its
batch. The draws are not the reference's threefry bits, so sampled
streams differ from the reference's; greedy streams are identical.

Quantized serving: ``kv_dtype="int8"|"fp8"`` stores the pools as
one-byte codes with per-page-per-head float32 scales
(``quantization/kv.py``); ``weight_dtype="int8"`` keeps the int8 weight
artifact (``quantization/weights.py``) on the device and widens it to
float32 at the entry of every dispatch — a prefill chunk, a decode step,
or a fused decode block, once per block.

Serving resilience (reference ``serving.py:118-152``), all of it host
scheduling around the same programs, so no graph is captured for it:

- priorities and page-pool preemption: ``add_request(priority=N)``
  orders the queue (``scheduler.RequestQueue``). When the queue's head
  cannot get pages or a slot, the lowest-priority, latest-admitted
  in-flight request is preempted: pages its prefill registered but never
  wrote are unregistered (a later admission mapping one is requeued as
  collateral), its fully written pages are registered under the resumed
  sequence's digests, and it requeues at the front of its class with its
  emitted tokens and its generator's state. Re-admission maps those
  pages back from the prefix cache, so the resume prefills only the
  uncached tail and continues the stream;
- deadlines (``deadline_s``, checked at admission, between prefill
  chunks and at every dispatch boundary; a live deadline clamps the
  fused block through a per-step EMA), ``cancel(uid)`` at the next step
  boundary, and ``close()``, which aborts everything in flight;
- ``fault_injector=`` (``inference/faults.py``): page exhaustion,
  prefill/decode dispatch errors, nonfinite logits and stalls each fail
  exactly their target; ``replica_down`` escapes ``step()``, which tears
  the engine down before re-raising any exception;
- ``inflight()``, ``eject(uid)`` and ``admit_migrated(req)``: a live
  request leaves as a resume-carrying :class:`Request` that another
  engine admits.

A teardown needs no device-side repair: every replay uploads the host
mirrors (block tables, lengths, active flags, budgets), and an inactive
row writes only the trash page.

Telemetry (reference ``serving.py:1761-2095``; ``observability/``), all
of it host code around the replays — nothing of it is captured, and it
adds no device sync to a step:

- the ``serving_*`` series of the reference's ``_init_telemetry`` in
  ``registry=`` (default the process registry; gauges carry an
  ``engine`` label): queue, slots and page gauges, admissions,
  completions by reason, tokens, prefix-cache hits, the prefill and
  decode dispatch wall-time histograms (taken around the replay and the
  token read the step already does), TTFT and per-token latency,
  preemptions, sheds, deadlines, cancellations, faults by kind, the
  speculative and ragged-row series, the graph-capture census under
  ``serving_jit_compiles{engine,fn}``; ``logit_health=True`` adds the
  logit abs-max gauge and non-finite counter, read from outputs of the
  captured programs;
- request tracing (``tracing=True``, ``tracer=``, ``trace_ctx=``): one
  trace a request with ``queued`` / ``prefill`` / ``prefill_chunk`` /
  ``decode`` / ``finish`` spans and the decision spans (``preempt``,
  ``shed``, ``cancel``, ``deadline``, ``fault``, ``shutdown``,
  ``migrate``), kept in the tracer's flight recorder, dumped to
  ``postmortem_path`` on an exception in ``step()``, an injected fault,
  ``close()`` and SIGUSR1;
- the ledger (``observability/ledger.py``): analytic FLOPs and HBM bytes
  per phase, MFU and MBU against one H100's peaks (``peak_flops=``,
  ``peak_hbm_bytes_per_s=``), goodput by tier and cost by request and
  ``tenant=``;
- the latency anatomy (``anatomy_report()``) on the step clock;
- ``step_log=``: one JSONL record a non-idle step.

The rest of the reference's observability (``serving.py:1608-1670``):

- ``watchdog=`` (``True``, a dict of ``ServingWatchdog`` settings, or a
  shared ``observability.slo.ServingWatchdog``): observed at the step
  boundary of every step that did work, under the reference's condition
  (``:3896-3903``): host arithmetic over the engine's counters and
  ``kv.cache_stats``, no dispatch and no capture;
- ``journal=`` (a path, owned and closed with the engine, or a shared
  ``observability.journal.JournalWriter``): the ``config`` record
  (:meth:`config_fingerprint`), one ``submit`` a request, one
  ``complete`` a finished request (on the step it finished at, with its
  anatomy segments), the ``summary`` at ``close()``, and the arms of a
  bound ``FaultInjector``, all on the engine's step clock, so
  ``observability.journal.replay`` drives a fresh engine (of either
  package) through the same schedule.

Tensor-parallel serving (reference ``serving.py:236-265``; the layout,
the collectives and the process model in ``inference/tp.py``):
``mesh=make_mesh(mp)`` with ``kv_shard="heads"|"replicated"`` and
``collective_dtype="f32"|"int8"``. One engine object a rank, built with
the same arguments on every rank: rank 0 leads (the scheduler, the
journal, telemetry, the ledger and every host read are its own, as on
one card), ranks 1 .. mp-1 call :meth:`ServingEngine.follow`, which runs
the leader's dispatches on their shards until the leader's ``close()``.
Every program dispatch (:meth:`_replay`) and every noise fill goes
through the dispatch channel first. Each rank's pools hold its heads
(``heads``) or all heads (``replicated``; the attention reads the rank's
heads at an offset); ``xla_costs[fn]`` holds the collective census of
each program's first run. ``mesh`` with ``mp = 1`` is the single-card
engine. Under a ``gloo`` group the programs cannot be captured (its
collectives run on the host): ``_capture=True`` raises there, and the
caller passes ``_capture=False``.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import tempfile
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import asdict, dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.paged_attention import (byte_view, paged_decode_attention,
                                       ragged_paged_attention,
                                       ragged_paged_attention_ref)
from ..models.gpt import init_params, make_layer_core, tree_map
from .. import profiler as _prof
from ..observability import tracing as _tracing
from ..observability.anatomy import (SEGMENT_STEP_BUCKETS, SEGMENTS,
                                     AnatomyLedger, summarize)
from ..observability.compile_tracker import CompileTracker
from ..observability.journal import JournalWriter
from ..observability.journal import _digest as _journal_digest
from ..observability.ledger import ServingLedger
from ..observability.registry import DEFAULT_BUCKETS, get_registry
from ..observability.slo import ServingWatchdog
from ..observability.step_logger import StepLogger
from ..quantization.kv import (KV_QUANT_DTYPES, STORAGE, dequantize_per_page,
                               page_scale_shape, quantize_per_page)
from ..quantization.weights import (cast_params, dequantize_params,
                                    params_nbytes, quantize_weights_int8)
from . import sampler as _sampler
from .faults import InjectedFault, ReplicaDown
from .graphs import EagerProgram, GraphProgram, GraphPool
from .scheduler import SHED_POLICIES, QueueFullError, RequestQueue
from .speculative import SpecState
from .tp import DispatchChannel, TPContext

__all__ = ["PagedKVCache", "ServingEngine", "Request", "Completion",
           "QueueFullError", "record_quant_logit_err"]



def record_quant_logit_err(registry, lever, err):
    """Publish a measured quantization logit error (reference
    ``serving.py:313``): ``serving_quant_logit_err{lever=}``, the
    relative decode-logit deviation a harness observed between a
    quantized engine and its full-precision reference on the same
    stream. The engine cannot compute it alone — it needs the reference
    run — so the measuring harness publishes it. Returns the value."""
    g = registry.gauge(
        "serving_quant_logit_err",
        "measured relative decode-logit error of a quantization lever "
        "vs its full-precision reference on the same stream (harness-"
        "published: error against a reference requires the reference "
        "run)",
        labels=("lever",))
    err = float(err)
    g.labels(lever=str(lever)).set(err)
    return err


def _page_digests(tokens, page_size):
    """Chained content digests for every FULL page of ``tokens``:
    digest[i] covers the whole prefix through page i (blake2b over the
    previous digest + the page's raw int32 bytes), so a table hit on
    digest[i] certifies the entire prefix, not just one page."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out, h = [], b"\x00" * 16
    for i in range(arr.size // page_size):
        h = hashlib.blake2b(
            h + arr[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=16).digest()
        out.append(h)
    return tuple(out)


def _span_pages(n, page_size):
    """Most distinct pages ``n`` contiguous positions can span (a run
    shorter than a page can still straddle one boundary): the gather
    width of the quantized prefill write."""
    return (n - 2) // page_size + 2 if n >= 2 else 1


def _requant_write(pool, scales, pages, index, new, quant):
    """The quantized write (reference ``write_decode``/``write_prefill``,
    ``serving.py:788-827``): dequantize ``pool[pages]`` to float32,
    insert ``new`` at ``index`` — a tuple of index tensors into the
    gathered block's page axes and the in-page offset — requantize every
    gathered page to its new abs-max, and write codes and scales back in
    place. A duplicated page in ``pages`` is the trash page only, where
    any copy may win."""
    x = dequantize_per_page(byte_view(pool)[pages].view(pool.dtype),
                            scales[pages])
    x[index] = new.float()
    q, s = quantize_per_page(x, dtype=quant)
    byte_view(pool)[pages] = byte_view(q)
    scales[pages] = s


def _propose(decode_block, k, proposed, q_logits, *args):
    """The propose scan (the draft's fused block of ``k + 1`` steps,
    logits collected): its first ``k`` proposals and their logits land in
    the round's fixed buffers ``proposed`` ``[k, S]`` and ``q_logits``
    ``[k, S, V]``, which the verify (or mixed) program reads."""
    toks, emits, lgs = decode_block(k + 1, *args, collect_logits=True)
    proposed.copy_(toks[:k])
    q_logits.copy_(lgs[:k])
    return toks, emits, lgs


def _emit_block(chain, n_emit, active, eos_ids, remaining):
    """The mixed program's emit/EOS/budget scan (reference ``mask_body``,
    ``serving.py:1226-1236``) in closed form: row ``j`` of slot ``s``
    emits while the slot is active, ``j < n_emit[s]``, no earlier row
    emitted its EOS id and the budget covers it. ``chain`` ``[S, QB]``
    tokens; returns the ``(QB, S)`` token block and emit mask. A scan
    of QB steps would launch QB times as many kernels for the same
    values."""
    j = torch.arange(chain.shape[1], device=chain.device)[None]
    can = j < n_emit[:, None]
    ok = can & (chain != eos_ids[:, None]) & (remaining[:, None] - j > 1)
    # still active at row j: every earlier row emitted and stayed live
    kept = torch.cat([torch.ones_like(ok[:, :1]), ok[:, :-1]], 1)
    emit = active[:, None] & kept.to(torch.int32).cumprod(1).bool() & can
    return chain.T, emit.T


@dataclass
class Request:
    """One generation request in the stream. A preempted request is
    requeued as a Request whose ``prompt`` is the original prompt plus
    every token already emitted (``resume_out``), whose budget is the
    remainder, and whose ``resume_key`` is its slot's generator state —
    re-admission then continues the same token stream."""
    uid: int
    prompt: np.ndarray          # [L] int32 token ids
    max_new_tokens: int
    temperature: float = 0.0    # 0 = greedy
    eos_id: int = -1            # -1 = never stop on a token
    seed: int = 0
    t_arrival: float = 0.0      # perf_counter at add_request (TTFT base)
    digests: tuple = ()         # chained per-full-page prompt digests
    priority: int = 0           # higher wins (queue order, preemption)
    deadline_s: object = None   # fail after t_arrival + deadline_s
    seq: int = 0                # arrival order (kept across preemption)
    resume_out: object = None   # tokens already emitted (resume)
    # the sampled slot's torch.Generator state (get_state()) at
    # preemption, None for a greedy slot: the reference's [2] u32 key
    resume_key: object = None
    # and its draft generator's under speculation (ROADMAP C16)
    resume_draft_key: object = None
    ttft_s: object = None       # observed TTFT (set before a resume)
    preemptions: int = 0        # times this request was preempted
    tenant: str = "default"     # cost-attribution rollup label
    trace_id: str = ""          # the request's trace ("" = tracing off)


@dataclass
class Completion:
    uid: int
    tokens: list                # generated ids (excludes the prompt)
    finish_reason: str          # "eos" | "length" | "deadline" |
    #                             "cancelled" | "shed" | "error" |
    #                             "nonfinite" | "aborted" | "collateral"
    ttft_s: object = None       # time to first token (None: never got one)
    priority: int = 0
    preemptions: int = 0        # preempt-and-resume cycles survived
    tenant: str = "default"


@dataclass
class _SlotState:
    uid: int
    prompt_len: int
    max_new: int
    eos_id: int
    pages: list                 # bt-order pages (shared + own), all ref-held
    out: list = field(default_factory=list)
    # deferred-prefill state: pf_base < pf_end => still prefilling; the
    # slot activates (samples its first token) after the last chunk
    temperature: float = 0.0
    seed: int = 0
    t_arrival: float = 0.0
    toks: object = None         # [pf_end] padded prompt (np.int32)
    pf_base: int = 0            # next chunk start
    pf_end: int = 0             # padded prefill extent (exclusive)
    logits: object = None       # last-chunk logits (first-token sample)
    cow_src: int = -1           # page to clone before the first chunk
    cow_dst: int = -1
    ttft_s: object = None
    # resilience
    priority: int = 0
    deadline_s: object = None
    seq: int = 0                # arrival order (survives preemption)
    admit_seq: int = 0          # admission order (preemption tiebreak)
    admit_round: int = 0        # _try_admit call that admitted this slot
    digests: tuple = ()         # the request's prompt-page digests
    reg_from: int = 0           # first digest index THIS slot registered
    preemptions: int = 0
    resume_out: object = None   # tokens emitted before preemption
    resume_key: object = None   # generator state saved at preemption
    resume_draft_key: object = None   # the draft generator's (C16)
    tenant: str = "default"
    # telemetry
    trace_id: str = ""
    sp_prefill: object = None   # open "prefill" span
    span_decode: object = None  # open "decode" span
    decode_steps: int = 0


class PagedKVCache:
    """Paged K/V pools + host-side page allocator with an optional
    content-addressed prefix cache (reference ``serving.py:453``).

    Pools are ``[num_pages, page_size, NH, HD]`` per layer (K and V).
    Page 0 is the trash page: decode writes for inactive slots land
    there, keeping the decode step branch-free. The free list is LIFO.
    With ``prefix_cache=True`` every live page carries a refcount and
    may be registered under a chained content digest; a registered page
    whose refcount hits zero becomes a cache-only resident (LRU) that
    ``alloc`` evicts when the free list alone cannot cover a request.
    A page is always exactly one of free, cache-only or in use, which
    ``verify()`` checks.

    ``kv_dtype``: ``None`` stores ``dtype``, ``"bf16"`` stores
    bfloat16, ``"int8"``/``"fp8"`` store one-byte codes (int8 grid codes
    or ``float8_e4m3fn``) with per-page-per-head float32 scales
    ``k_scale``/``v_scale``, one ``[num_pages, NH]`` tensor per layer
    (empty tuples for an unquantized pool). Allocation, refcounts, the
    prefix cache and ``verify()`` do not depend on the dtype."""

    def __init__(self, num_layers, num_pages, page_size, num_heads,
                 head_dim, dtype, prefix_cache=False, kv_dtype=None,
                 device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        if kv_dtype not in (None, "bf16") + KV_QUANT_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                             "(None, 'bf16', 'int8' or 'fp8')")
        dev = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        # the quantized-pool format ("int8"/"fp8") or None: what the write
        # paths hand quantize_per_page
        self.quant_dtype = kv_dtype if kv_dtype in KV_QUANT_DTYPES else None
        self.quantized = self.quant_dtype is not None
        store = {"bf16": torch.bfloat16, None: dtype,
                 **STORAGE}[kv_dtype]
        self.kv_dtype = kv_dtype or str(dtype).replace("torch.", "")
        shape = (num_pages, page_size, num_heads, head_dim)
        self.k = [torch.zeros(shape, dtype=store, device=dev)
                  for _ in range(num_layers)]
        self.v = [torch.zeros(shape, dtype=store, device=dev)
                  for _ in range(num_layers)]
        self.k_scale, self.v_scale = (), ()
        if self.quantized:
            sshape = page_scale_shape(num_pages, num_heads)
            self.k_scale = [torch.zeros(sshape, device=dev)
                            for _ in range(num_layers)]
            self.v_scale = [torch.zeros(sshape, device=dev)
                            for _ in range(num_layers)]
        self._free = list(range(num_pages - 1, 0, -1))
        self._ref = {}             # page -> refcount (in-use pages)
        self._hash_to_page = {}    # digest -> page
        self._page_hash = {}       # page -> digest (registered pages)
        self._lru = OrderedDict()  # cache-only pages, oldest first
        # the reference's counters (serving.py:537); the watchdog's
        # page_thrash reads the evictions
        self.cache_stats = {"hits": 0, "misses": 0, "evictions": 0}

    # -- accounting ----------------------------------------------------------
    def pool_bytes(self):
        """Resident bytes of the K/V pools, scale tensors included."""
        return int(sum(t.numel() * t.element_size() for t in
                       (*self.k, *self.v, *self.k_scale, *self.v_scale)))

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_cached(self):
        """Cache-only pages (content registered, no live reference)."""
        return len(self._lru)

    @property
    def num_available(self):
        """Pages an alloc() could hand out right now: the free list
        plus every cache-only page (evictable on demand)."""
        return len(self._free) + len(self._lru)

    @property
    def num_in_use(self):
        return len(self._ref)

    @property
    def num_shared(self):
        """In-use pages referenced by more than one sequence."""
        return sum(1 for r in self._ref.values() if r > 1)

    # -- allocation ----------------------------------------------------------
    def alloc(self, n):
        """Pop ``n`` pages off the free list (evicting cache-only pages
        LRU-first to refill it), or None if unavailable. Every handed-
        out page starts with refcount 1."""
        if n > self.num_available:
            return None
        if n <= 0:  # [-0:] would hand out the WHOLE free list
            return []
        while len(self._free) < n:
            self._evict_one()
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        for p in pages:
            self._ref[p] = 1
        return pages

    def _evict_one(self):
        page, _ = self._lru.popitem(last=False)
        del self._hash_to_page[self._page_hash.pop(page)]
        self._free.append(page)
        self.cache_stats["evictions"] += 1

    def release(self, pages):
        """Decref each page; refcount 0 sends a registered page to the
        cache-only LRU (content kept) and an unregistered one back to
        the free list (LIFO). Raises on a page that is not in use — the
        double-free guard."""
        freed = []
        for p in pages:
            r = self._ref.get(p)
            if r is None:
                raise RuntimeError(
                    f"double free: page {p} is not in use")
            if r > 1:
                self._ref[p] = r - 1
                continue
            del self._ref[p]
            if self.prefix_cache and p in self._page_hash:
                self._lru[p] = None          # newest at the MRU end
            else:
                freed.append(p)
        self._free.extend(reversed(freed))

    def share(self, page):
        """Take a reference on an in-use or cache-only page (a prefix-
        cache hit): cache-only pages leave the LRU with their K/V
        intact."""
        if page in self._ref:
            self._ref[page] += 1
            return
        if page not in self._lru:
            raise RuntimeError(
                f"share: page {page} is neither in use nor cached")
        del self._lru[page]
        self._ref[page] = 1

    # -- the content-addressed table -----------------------------------------
    def lookup(self, digest):
        """The page registered under ``digest``, or None."""
        return self._hash_to_page.get(digest)

    def refcount(self, page):
        """Live references on ``page`` (0 = free or cache-only)."""
        return self._ref.get(page, 0)

    def unregister(self, digest):
        """Drop a digest -> page mapping: a torn-down request whose
        prefill never finished writing a page it registered at admission
        must not leave that digest serving garbage. A cache-only page
        orphaned by it returns to the free list. Returns True if the
        digest was registered."""
        page = self._hash_to_page.pop(digest, None)
        if page is None:
            return False
        del self._page_hash[page]
        if page in self._lru:
            del self._lru[page]
            self._free.append(page)
        return True

    def register(self, digest, page):
        """Map ``digest`` to an in-use ``page`` (idempotent: an existing
        entry for the digest, or a page already registered under
        another digest, wins). Returns True if the mapping was
        recorded."""
        if (not self.prefix_cache or digest in self._hash_to_page
                or page in self._page_hash):
            return False
        self._hash_to_page[digest] = page
        self._page_hash[page] = digest
        return True

    def verify(self):
        """Page-accounting invariant: {free} ∪ {cache-only} ∪ {in-use}
        partitions the usable pool (page 0 excluded), refcounts are
        positive, and the digest table is a bijection onto registered
        pages with every cache-only page registered. Raises
        RuntimeError on any violation; returns True."""
        free, cached = set(self._free), set(self._lru)
        used = set(self._ref)
        problems = []
        if len(free) != len(self._free):
            problems.append("duplicate page in free list")
        for name, both in (("free and cached", free & cached),
                           ("free and in use", free & used),
                           ("cached and in use", cached & used)):
            if both:
                problems.append(f"pages both {name}: {sorted(both)}")
        if free | cached | used != set(range(1, self.num_pages)):
            problems.append("free+cached+in-use do not partition the pool")
        if not all(r > 0 for r in self._ref.values()):
            problems.append("non-positive refcount")
        if set(self._page_hash) != set(self._hash_to_page.values()) or \
                len(self._page_hash) != len(self._hash_to_page):
            problems.append("digest table is not a bijection")
        if not cached <= set(self._page_hash):
            problems.append("cache-only page without a registered digest")
        if problems:
            raise RuntimeError("page accounting broken: "
                               + "; ".join(problems))
        return True


def _health(lg32, mask):
    """The logit-health reduction (reference ``_health``,
    ``serving.py:923``): the non-finite count and the abs-max of the
    logits ``lg32`` ``[S, R, V]`` at the rows ``mask`` ``[S, R]`` marks
    (active or emitting), as one ``[2]`` float32 tensor, so the host
    reads both with one copy."""
    m = mask[..., None]
    nonfinite = (m & ~torch.isfinite(lg32)).sum()
    absmax = torch.where(m, lg32.abs(), 0.0).amax()
    return torch.stack([nonfinite.float(), absmax])


def _build_serving_fns(core, *, num_slots, page_size, pages_per_slot,
                       prefill_chunk, attention, device, quant=None,
                       weight_quant=False, spec_k=None,
                       logit_health=False, h0=0):
    """The serving programs over a model's layer ``core``
    (``models.gpt.make_layer_core``), as plain functions of (params,
    pools, scales, state tensors) — the port of the reference's
    ``_build_serving_fns`` (``serving.py:690``). Weights are call
    arguments. The pools and scales are written in place (the reference
    donated them); nothing else is mutated. Every program but
    ``sample_first`` is a function of tensors only — no host read, no
    shape that depends on the data — so a CUDA graph can capture it
    (``inference/graphs.py``). The mixed-step program's query block is
    the widest row any kind contributes, ``QB = max(C, spec_k + 1)``
    (the reference's ``mixed_qb``).

    ``quant`` is the quantized-pool format (``"int8"``/``"fp8"``, falsy
    = off): every program takes the per-layer scale lists next to the
    pools (empty tuples when off), the writes dequantize, insert and
    requantize the pages they touch, and the attention reads the codes
    with their scales. ``weight_quant``: the params arrive as the int8
    artifact (``quantization/weights.py``) and each program widens them
    to float32 at its entry. ``spec_k`` (speculative decoding's
    ``draft_k``, None = off) adds the target's verify program and verify
    rows (kind 3) to the mixed program.

    A tensor-parallel rank's ``core`` (``make_layer_core(cfg, tp=)``)
    computes its own heads and ends each layer's row-parallel products
    in a collective; ``h0`` is where its heads start in the pools (non-
    zero over a replicated pool, whose heads are all of the model's).
    Each attention output is this rank's heads, ``[..., NH * HD]``."""
    scale = core.scale
    S, PS, MP, C = num_slots, page_size, pages_per_slot, prefill_chunk
    T = MP * PS  # per-slot attention extent
    dev = device
    rows = torch.arange(S, device=dev)
    chunk_pos = torch.arange(C, device=dev)
    chunk_qlen = torch.full((1,), C, dtype=torch.int32, device=dev)
    R = _span_pages(C, PS)      # pages a prefill chunk can touch
    span = torch.arange(R, device=dev)

    if attention == "torch":
        def decode_attn(q, kp, vp, ks, vs, bt, n_valid):
            return ragged_paged_attention_ref(
                q[:, None], kp, vp, bt, n_valid, torch.ones_like(n_valid),
                scale, ks, vs, h0)[:, 0]
        ragged = functools.partial(ragged_paged_attention_ref, h0=h0)
    else:
        def decode_attn(q, kp, vp, ks, vs, bt, n_valid):
            return paged_decode_attention(q, kp, vp, bt, n_valid,
                                          scale=scale, k_scale=ks,
                                          v_scale=vs, h0=h0)
        ragged = functools.partial(ragged_paged_attention, h0=h0)

    def prep(params):
        """Widen an int8 weight artifact at program entry; a no-op
        otherwise (reference ``prep``, ``serving.py:763``)."""
        return dequantize_params(params) if weight_quant else params

    def layer_scales(kscales, vscales, li):
        return (kscales[li], vscales[li]) if quant else (None, None)

    def write_decode(kp, ks, page, off, knew):
        """One token per slot into its current page: page/off [S], knew
        [S, NH, HD]. Active slots own distinct pages; inactive slots all
        write the trash page, where duplicates are harmless."""
        if not quant:
            kp[page, off] = knew.to(kp.dtype)
            return
        _requant_write(kp, ks, page, (rows, off), knew, quant)

    def write_prefill(kp, ks, bt_row, pos, page, off, knew):
        """A contiguous C-position chunk into one slot's pages: pos [C]
        ascending, knew [C, NH, HD]. The quantized write gathers the
        ``_span_pages(C, PS)`` block-table rows from the chunk's first
        page; rows past its last page point at the trash page, so the
        gathered set holds no other duplicate."""
        if not quant:
            kp[page, off] = knew.to(kp.dtype)
            return
        row0 = pos[0] // PS
        rr = row0 + span
        pages_r = torch.where(rr <= pos[C - 1] // PS,
                              bt_row[rr.clamp(max=MP - 1)].long(), 0)
        rloc = (pos // PS - row0).clamp(0, R - 1)
        _requant_write(kp, ks, pages_r, (rloc, off), knew, quant)

    def step_core(params, kpools, vpools, kscales, vscales, bt, lengths,
                  tokens, active, temps, noise):
        """One token for every slot (reference ``step_core``,
        ``serving.py:875``) on already-widened ``params``. ``lengths[s]``
        counts the tokens of slot s INCLUDING ``tokens[s]`` (whose K/V is
        not yet written): the step writes K/V at ``t = lengths - 1``,
        attends positions ``< lengths``, and samples the next token.
        ``bt`` [S, MP] int32; ``lengths`` [S] int64; ``tokens`` [S]
        int64; ``active`` [S] bool; ``temps`` [S] f32; ``noise`` [S, V]
        Gumbel noise or None (all-greedy). Returns (next tokens [S]
        int64, f32 logits)."""
        wte, wpe = params["wte"], params["wpe"]
        # the clamps of serving.py:888/:892: torch raises on an
        # out-of-range index where JAX clamps
        t = (lengths - 1).clamp(0, T - 1)
        page = torch.where(active, bt[rows, t // PS].long(), 0)
        off = torch.where(active, t % PS, 0)
        x = wte[tokens] + wpe[t.clamp(max=wpe.shape[0] - 1)]
        n_valid = torch.where(active, lengths.clamp(max=T), 0).to(
            torch.int32)
        for li, lay in enumerate(params["layers"]):
            h = core.ln(x, *lay["ln1"])
            q, k, v = core.qkv_proj(lay, h)               # [S, NH, HD]
            kp, vp = kpools[li], vpools[li]
            ks, vs = layer_scales(kscales, vscales, li)
            # in place where the reference donated the pools
            write_decode(kp, ks, page, off, k)
            write_decode(vp, vs, page, off, v)
            o = decode_attn(q.contiguous(), kp, vp, ks, vs, bt, n_valid)
            x = core.attn_out(lay, x, o.reshape(S, -1))
            x = core.mlp_tail(lay, x)
        logits = core.ln(x, *params["lnf"]) @ wte.T       # [S, V]
        lg32 = logits.float()
        return _sampler.sample_token(lg32, temps, noise), lg32

    def decode_step(params, kpools, vpools, kscales, vscales, bt, lengths,
                    tokens, active, temps, noise):
        """One decode dispatch: :func:`step_core` on the widened
        params (and, with ``logit_health``, its health over the active
        slots)."""
        nxt, lg32 = step_core(prep(params), kpools, vpools, kscales,
                              vscales, bt, lengths, tokens, active, temps,
                              noise)
        if logit_health:
            return nxt, lg32, _health(lg32[:, None], active[:, None])
        return nxt, lg32

    def decode_block(K, params, kpools, vpools, kscales, vscales, bt,
                     lengths, tokens, active, temps, eos_ids, remaining,
                     noise=None, collect_logits=False):
        """``K`` decode steps with the per-slot scheduler state on the
        device (reference ``decode_block``, ``serving.py:943``, a
        ``lax.scan`` there, a loop here): a slot that samples its EOS id
        or exhausts ``remaining`` stops emitting and its later writes
        fall to the trash page. No host synchronisation inside the
        block; the weights are widened once for the block. ``noise`` is
        ``[K, S, V]`` or None. Returns the ``(K, S)`` token block, the
        ``(K, S)`` emit mask, and the ``[K, S, V]`` f32 logits when
        ``collect_logits`` (else None); with ``logit_health`` the block's
        health over each step's emitting slots (count summed, abs-max
        maxed over the K steps)."""
        params = prep(params)
        toks, emits, lgs, health = [], [], [], []
        for i in range(K):
            nxt, lg32 = step_core(params, kpools, vpools, kscales, vscales,
                                  bt, lengths, tokens, active, temps,
                                  None if noise is None else noise[i])
            emit = active
            hit_eos = emit & (nxt == eos_ids)
            remaining = remaining - emit.to(remaining.dtype)
            active = emit & ~hit_eos & (remaining > 0)
            lengths = torch.where(emit, lengths + 1, lengths)
            tokens = torch.where(emit, nxt, tokens)
            toks.append(nxt)
            emits.append(emit)
            if collect_logits:
                lgs.append(lg32)
            if logit_health:
                health.append(_health(lg32[:, None], emit[:, None]))
        out = (torch.stack(toks), torch.stack(emits),
               torch.stack(lgs) if collect_logits else None)
        if logit_health:
            hs = torch.stack(health)
            return out + (torch.stack([hs[:, 0].sum(), hs[:, 1].amax()]),)
        return out

    def prefill_chunk_fn(params, kpools, vpools, kscales, vscales, bt_row,
                         base, tok_chunk, last_idx):
        """One fixed-width prompt chunk for ONE slot (reference
        ``prefill_chunk_fn``, ``serving.py:996``): writes K/V for
        positions ``base .. base+C-1`` (padding rows land past the
        prompt and are overwritten by decode before they are attended;
        in a quantized page they enter its abs-max, as in the reference)
        and returns the logits at chunk-local position ``last_idx``.
        Attention is the ragged kernel's ``q_len = C`` row with
        ``kv_len = base + C``: row j attends positions ``<= base + j``,
        the causal limit of the reference's gather. ``base`` and
        ``last_idx`` are 0-d int64 tensors (or ints)."""
        params = prep(params)
        wte, wpe = params["wte"], params["wpe"]
        base = torch.as_tensor(base, device=dev)
        last_idx = torch.as_tensor(last_idx, device=dev)
        pos = base + chunk_pos
        x = wte[tok_chunk] + wpe[pos.clamp(max=wpe.shape[0] - 1)]
        page = bt_row[(pos // PS).clamp(max=MP - 1)].long()
        off = pos % PS
        kv_len = (base + C).to(torch.int32).reshape(1)
        bt1 = bt_row[None]
        for li, lay in enumerate(params["layers"]):
            h = core.ln(x, *lay["ln1"])
            q, k, v = core.qkv_proj(lay, h)               # [C, NH, HD]
            kp, vp = kpools[li], vpools[li]
            ks, vs = layer_scales(kscales, vscales, li)
            write_prefill(kp, ks, bt_row, pos, page, off, k)
            write_prefill(vp, vs, bt_row, pos, page, off, v)
            o = ragged(q.contiguous()[None], kp, vp, bt1, kv_len,
                       chunk_qlen, scale=scale, k_scale=ks,
                       v_scale=vs)[0]
            x = core.attn_out(lay, x, o.reshape(C, -1))
            x = core.mlp_tail(lay, x)
        last = x.index_select(0, last_idx.reshape(1))[0]
        return core.ln(last, *params["lnf"]) @ wte.T

    def copy_page_fn(kpools, vpools, kscales, vscales, src, dst):
        """Copy-on-write helper: clone page ``src`` into ``dst`` in
        every layer's K/V pool, and its scale rows under quantization.
        ``src``/``dst`` are 0-d int64 tensors (or ints)."""
        src = torch.as_tensor(src, device=dev).reshape(1)
        dst = torch.as_tensor(dst, device=dev).reshape(1)
        for t in (*kpools, *vpools, *kscales, *vscales):
            b = byte_view(t)
            b.index_copy_(0, dst, b.index_select(0, src))

    def sample_first(logits, temp, generator):
        """The first generated token from the prefill logits; a sampled
        slot's first draw from its generator."""
        lg = logits.float()
        noise = None
        if temp > 0:
            noise = _sampler.gumbel_noise(lg.shape, generator, lg.device)
        return int(_sampler.sample_token(lg, float(temp), noise))

    K1 = spec_k + 1 if spec_k else 1   # rows a verify (or decode) reads
    R2 = _span_pages(K1, PS)           # pages K1 contiguous rows can span
    span2 = torch.arange(R2, device=dev)
    k1_rows = torch.arange(K1, device=dev)

    def verify_fn(params, kpools, vpools, kscales, vscales, bt, lengths,
                  tokens, active, temps, eos_ids, remaining, gumbel,
                  uniforms, proposed, q_logits):
        """ONE target dispatch of a speculative round (reference
        ``verify``, ``speculative.py:197``): the K/V of the ``k + 1``
        positions ``[last token, k proposals]`` of every slot are
        span-written, one ragged launch a layer attends them as a
        ``q_len = k + 1`` row with ``kv_len = lengths + k`` (row j attends
        positions ``< lengths + j``, the reference's own limits), the head
        runs on all ``k + 1`` rows, :func:`sampler.spec_accept` picks the
        chain and the closed-form emit/EOS/budget mask (``_emit_block``)
        the rows each slot emits. ``gumbel`` ``[S, V]`` and ``uniforms``
        ``[S, k]`` are the target generators' draws (zero for greedy
        rows); ``proposed`` ``[k, S]`` and ``q_logits`` ``[k, S, V]`` the
        propose scan's. The accepted prefix's writes are final; the rejected
        tail's sit past the new length. Returns the ``(k + 1, S)`` token
        block and emit mask, the accepted counts ``[S]`` and the f32
        logits ``[S, k + 1, V]``."""
        params = prep(params)
        wte, wpe = params["wte"], params["wpe"]
        toks = torch.cat([tokens[:, None], proposed.T], 1)     # [S, K1]
        t0 = (lengths - 1).clamp(0, T - 1)
        pos = (t0[:, None] + k1_rows[None]).clamp(max=T - 1)
        sidx = rows[:, None]
        page = torch.where(active[:, None], bt[sidx, pos // PS].long(), 0)
        off = torch.where(active[:, None], pos % PS, 0)
        row0 = pos[:, 0] // PS
        rr = row0[:, None] + span2[None]
        valid = rr <= (pos[:, -1] // PS)[:, None]
        pages_r = torch.where(active[:, None] & valid,
                              bt[sidx, rr.clamp(max=MP - 1)].long(), 0)
        rloc = (pos // PS - row0[:, None]).clamp(0, R2 - 1)
        x = wte[toks] + wpe[pos.clamp(max=wpe.shape[0] - 1)]
        kv_lens = torch.where(active, (t0 + K1).clamp(max=T), 0).to(
            torch.int32)
        q_lens = torch.where(active, K1, 1).to(torch.int32)
        for li, lay in enumerate(params["layers"]):
            h = core.ln(x, *lay["ln1"])
            q, k, v = core.qkv_proj(lay, h)           # [S, K1, NH, HD]
            kp, vp = kpools[li], vpools[li]
            ks, vs = layer_scales(kscales, vscales, li)
            for pool, sc, new in ((kp, ks, k), (vp, vs, v)):
                if quant:
                    _requant_write(pool, sc, pages_r, (sidx, rloc, off),
                                   new, quant)
                else:
                    pool[page, off] = new.to(pool.dtype)
            o = ragged(q.contiguous(), kp, vp, bt, kv_lens, q_lens,
                       scale=scale, k_scale=ks, v_scale=vs)
            x = core.attn_out(lay, x, o.reshape(S, K1, -1))
            x = core.mlp_tail(lay, x)
        lg32 = (core.ln(x, *params["lnf"]) @ wte.T).float()  # [S, K1, V]
        chain, n_acc = _sampler.spec_accept(
            lg32, q_logits.transpose(0, 1), proposed.T, temps, uniforms,
            gumbel)
        tok_block, emit_block = _emit_block(chain, n_acc + 1, active,
                                            eos_ids, remaining)
        if logit_health:    # over the emitted positions
            return (tok_block, emit_block, n_acc, lg32,
                    _health(lg32, emit_block.T))
        return tok_block, emit_block, n_acc, lg32

    QB = max(C, K1)
    RM = _span_pages(QB, PS)   # pages QB contiguous rows can span
    qb_rows = torch.arange(QB, device=dev)
    span_m = torch.arange(RM, device=dev)
    trash = torch.zeros(S, 1, dtype=torch.int64, device=dev)

    def mixed_write(kp, ks, page, off, pages_r, rloc, rowlive, knew):
        """QB contiguous positions a slot (reference ``mixed_write``,
        ``serving.py:1108``): page/off ``[S, QB]``, dead rows on the
        trash page. The quantized write gathers each slot's spanned
        pages once (rows past the span on the trash page, so the set
        holds no other duplicate) and one more, the trash page: the
        reference drops padding rows from the insert (their clipped
        span row may alias a live page's), here they land in that
        scratch row, so the write keeps one shape."""
        if not quant:
            kp[page, off] = knew.to(kp.dtype)
            return
        pages_x = torch.cat([pages_r, trash], 1)
        rloc_x = torch.where(rowlive, rloc, RM)
        _requant_write(kp, ks, pages_x, (rows[:, None], rloc_x, off),
                       knew, quant)

    def mixed_step_fn(params, kpools, vpools, kscales, vscales, bt,
                      kind, q_lens, start, tokens_q, last_idx, active,
                      temps, eos_ids, remaining, noise, uniforms=None,
                      proposed=None, q_logits=None):
        """ONE dispatch for whatever work exists (reference
        ``mixed_step_fn``, ``serving.py:1130``): per-slot rows of kind
        0 = idle, 1 = decode (``q_len`` 1), 2 = prefill chunk (``q_len``
        C), 3 = speculative verify (``q_len`` k + 1: the last token and
        the k ``proposed``, an engine with ``spec_k`` only); ``start[s]``
        is the pool position of the slot's first query row. K/V of
        every live row is span-written, one ragged launch a layer
        attends all rows, decode rows sample one token (``noise`` ``[S,
        V]`` Gumbel noise, zero for greedy rows), verify rows run
        :func:`sampler.spec_accept` (``noise`` their correction draw,
        ``uniforms`` ``[S, k]``, ``q_logits`` ``[k, S, V]`` the draft's),
        prefill rows surface the logits at ``last_idx``. ``bt`` [S, MP]
        int32, ``kind`` and ``q_lens`` [S] int32, ``start``,
        ``last_idx``, ``eos_ids``, ``remaining`` [S] int64, ``tokens_q``
        [S, QB] int64, ``active`` [S] bool, ``temps`` [S] f32. Returns
        the ``(QB, S)`` token block and emit mask, the prefill rows' f32
        logits ``[S, V]``, the decode and verify rows' ``[S, k + 1, V]``
        (``[S, 1, V]`` without ``spec_k``) and the accepted counts
        ``[S]`` (0 off verify rows). Only rows ``0 .. k`` and
        ``last_idx`` of a slot are read, so the head runs on those rows
        alone (the reference forms ``[S, QB, V]``)."""
        params = prep(params)
        wte, wpe = params["wte"], params["wpe"]
        live = kind > 0
        jj = qb_rows[None]
        pos = (start[:, None] + jj).clamp(max=T - 1)        # [S, QB]
        rowlive = live[:, None] & (jj < q_lens[:, None])
        sidx = rows[:, None]
        page = torch.where(rowlive, bt[sidx, pos // PS].long(), 0)
        off = torch.where(rowlive, pos % PS, 0)
        row0 = start // PS
        rr = row0[:, None] + span_m[None]
        last_row = (start + q_lens.clamp(min=1) - 1) // PS
        pvalid = live[:, None] & (rr <= last_row[:, None])
        pages_r = torch.where(pvalid, bt[sidx, rr.clamp(max=MP - 1)]
                              .long(), 0)
        rloc = (pos // PS - row0[:, None]).clamp(0, RM - 1)
        if spec_k:      # verify rows: [last sampled token, k proposals]
            spliced = torch.cat([tokens_q[:, :1], proposed.T,
                                 tokens_q[:, K1:]], 1)
            tokens_q = torch.where((kind == 3)[:, None], spliced, tokens_q)
        x = wte[tokens_q] + wpe[pos.clamp(max=wpe.shape[0] - 1)]
        kv_lens = torch.where(live, (start + q_lens).clamp(max=T),
                              0).to(torch.int32)
        for li, lay in enumerate(params["layers"]):
            h = core.ln(x, *lay["ln1"])
            q, k, v = core.qkv_proj(lay, h)           # [S, QB, NH, HD]
            kp, vp = kpools[li], vpools[li]
            ks, vs = layer_scales(kscales, vscales, li)
            mixed_write(kp, ks, page, off, pages_r, rloc, rowlive, k)
            mixed_write(vp, vs, page, off, pages_r, rloc, rowlive, v)
            o = ragged(q.contiguous(), kp, vp, bt, kv_lens, q_lens,
                       scale=scale, k_scale=ks, v_scale=vs)
            x = core.attn_out(lay, x, o.reshape(S, QB, -1))
            x = core.mlp_tail(lay, x)
        # one head product over rows 0 .. K1-1 and last_idx of each slot
        sel = torch.cat([k1_rows[None].expand(S, K1),
                         last_idx.clamp(max=QB - 1)[:, None]], 1)
        ends = x[rows[:, None], sel]                       # [S, K1+1, H]
        lg = (core.ln(ends, *params["lnf"]) @ wte.T).float()
        pf_logits = lg[:, K1]
        nxt = _sampler.sample_token(lg[:, 0], temps, noise)
        chain = torch.cat([nxt[:, None], nxt.new_zeros(S, QB - 1)], 1)
        n_emit = (kind == 1).to(torch.int64)
        n_acc = torch.zeros_like(n_emit)
        if spec_k:
            chain_v, n_acc_v = _sampler.spec_accept(
                lg[:, :K1], q_logits.transpose(0, 1), proposed.T, temps,
                uniforms, noise)
            is_v = kind == 3
            chain = torch.where(is_v[:, None], torch.cat(
                [chain_v, chain_v.new_zeros(S, QB - K1)], 1), chain)
            n_acc = torch.where(is_v, n_acc_v, 0)
            n_emit = torch.where(is_v, n_acc_v + 1, n_emit)
        tok_block, emit_block = _emit_block(chain, n_emit, active, eos_ids,
                                            remaining)
        out = (tok_block, emit_block, pf_logits, lg[:, :K1], n_acc)
        if logit_health:    # over the emitted rows, all among 0 .. k
            return out + (_health(lg[:, :K1], emit_block[:K1].T),)
        return out

    return SimpleNamespace(prefill=prefill_chunk_fn, decode_step=decode_step,
                           decode_block=decode_block, copy_page=copy_page_fn,
                           sample_first=sample_first, mixed=mixed_step_fn,
                           verify=verify_fn if spec_k else None, QB=QB)


class ServingEngine:
    """Continuous-batching paged-KV serving engine for GPT-2 (port of
    the reference ``ServingEngine``, ``serving.py:1263``).

    >>> eng = ServingEngine(gpt2_small(), device="cuda")
    >>> eng.add_request([1, 2, 3], max_new_tokens=16)
    >>> done = eng.run()          # {uid: Completion}

    ``cfg`` is a :class:`~paddle_tpu_torch.models.gpt.GPTConfig`;
    ``params`` the port's parameter dict (``init_params`` /
    ``params_from_numpy``), ``init_params(cfg, seed=0)`` when omitted.
    Runs on CUDA unless ``device="cpu"``.

    Levers ported: ``num_slots``, ``page_size``, ``num_pages``,
    ``max_seq_len``, ``prefill_chunk``, ``prefix_cache``,
    ``prefill_chunks_per_step``, ``admit_lookahead``,
    ``decode_block``/``decode_block_buckets``, ``max_queue``/
    ``shed_policy``, ``kv_dtype`` (None, "bf16", "int8" or "fp8"),
    ``weight_dtype`` (None, "bf16" or "int8"), ``mixed_step`` (every
    step ONE dispatch: each queued prefill slot's next chunk and every
    decode slot's token as rows of one ragged program; the reference's
    ``mixed_step=True``), ``preemption`` (False: a queued request of
    higher priority waits for pages instead of evicting),
    ``fault_injector`` (``inference/faults.py``), ``speculative`` (True:
    a draft of the target's first ``max(1, L // 4)`` layers; an int: that
    many; a ``(cfg, params)`` pair; False or None: off) with ``draft_k``
    proposals a round.
    ``attention="auto"`` runs the ragged kernel (the plain version for
    CPU tensors); ``"torch"`` the plain version. ``mesh`` (an
    ``inference.tp.make_mesh`` handle), ``kv_shard`` (``"heads"`` or
    ``"replicated"``) and ``collective_dtype`` (``"f32"`` or ``"int8"``,
    which needs a mesh): tensor-parallel serving, one engine a rank
    (the module docstring; rank > 0 calls :meth:`follow`).
    ``record_logits=True`` keeps every emitted token's f32 logits in
    ``logit_log[uid]`` (on the host), for parity checks.

    Telemetry (the module docstring): ``registry``, ``step_log``,
    ``tracer``, ``tracing``, ``postmortem_path``, ``logit_health``,
    ``peak_flops`` and ``peak_hbm_bytes_per_s``, as the reference takes
    them.

    On a CUDA device the constructor captures every program the engine
    dispatches as a CUDA graph (``inference/graphs.py``; the reference
    jits them) before any request: the decode step, a fused block for
    each bucket above 1 and the prefill chunk — or, with
    ``mixed_step``, the mixed program — and the page copy; under
    speculation the verify program (per phase, in place of the fused
    blocks) and the draft's page copy, prefill chunk, mirror step and
    propose scan. The capture
    runs with every slot idle, so its writes land on the trash page
    only. ``stats["graph_captures"]`` counts the graphs and
    ``["graph_replays"]`` their replays; ``capture_seconds`` the
    constructor's time in capture. ``_capture=False`` keeps eager
    dispatch, for checks that must run Python at every kernel launch;
    on the CPU the programs always run eagerly."""

    def __init__(self, cfg, params=None, *, device=None, num_slots=4,
                 page_size=16, num_pages=None, max_seq_len=None,
                 prefill_chunk=32, attention="auto", prefix_cache=True,
                 prefill_chunks_per_step=None, admit_lookahead=4,
                 decode_block="adaptive",
                 decode_block_buckets=(1, 4, 8, 16), max_queue=None,
                 shed_policy="reject", preemption=True,
                 fault_injector=None, kv_dtype=None, weight_dtype=None,
                 record_logits=False, mesh=None, kv_shard="heads",
                 collective_dtype="f32", speculative=None,
                 draft_k=4, mixed_step=False, journal=None, tracer=None,
                 watchdog=None, registry=None, step_log=None,
                 tracing=True, postmortem_path=None, logit_health=False,
                 peak_flops=None, peak_hbm_bytes_per_s=None,
                 _capture=True):
        if weight_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"unknown weight_dtype {weight_dtype!r} "
                             "(None, 'bf16' or 'int8')")
        if attention not in ("auto", "torch"):
            raise ValueError(f"unknown attention impl {attention!r} "
                             "('auto' or 'torch')")
        # the int8 collective is wire format between ranks: one card has
        # none (reference serving.py:1359-1363)
        if collective_dtype != "f32" and mesh is None:
            raise ValueError(
                f"collective_dtype={collective_dtype!r} needs a mesh "
                "(the quantized collective is inter-chip wire format)")
        spec_on = speculative is not None and speculative is not False
        # tensor parallelism (inference/tp.py): validated at any mp; a
        # mesh of one rank is the single-card engine
        self.mesh, self.tp, self._chan, self._role = mesh, None, None, None
        self.chips = 1
        self.kv_shard = kv_shard if mesh is not None else None
        self.collective_dtype = collective_dtype
        if mesh is not None:
            tp = TPContext(mesh, cfg, kv_shard=kv_shard,
                           collective_dtype=collective_dtype)
            if mesh.device is not None and device is None:
                device = mesh.device
            if tp.mp > 1:
                self.tp, self.chips = tp, tp.mp
                self._role = "lead" if tp.rank == 0 else "follow"
        self.device = resolve_device(device)
        if self.tp is not None:
            self._chan = DispatchChannel(mesh)
            # the engine's number on its rank set: every rank builds its
            # engines in the same order, so the numbers agree
            self._mesh_seq = next(ServingEngine._mesh_seqs)
        if self.tp is not None and _capture and \
                self.device.type == "cuda" and mesh.backend == "gloo":
            raise ValueError(
                "a gloo mesh runs its collectives on the host, which a CUDA "
                "graph cannot capture: pass _capture=False (captured sharded "
                "programs need one GPU a rank and the nccl backend)")
        if self._role == "follow":
            # a follower runs programs only: the leader keeps the
            # journal, the traces, the watchdog and the step log
            journal = watchdog = step_log = None
            tracing = False
        self.cfg = cfg
        maxpos = cfg.max_position_embeddings
        max_seq_len = int(max_seq_len or maxpos)
        if max_seq_len > maxpos:
            raise ValueError(
                f"max_seq_len({max_seq_len}) exceeds the position table "
                f"({maxpos})")
        if max_seq_len % page_size or max_seq_len % prefill_chunk:
            raise ValueError(
                f"max_seq_len({max_seq_len}) must be a multiple of "
                f"page_size({page_size}) and prefill_chunk"
                f"({prefill_chunk}) so padded prefill chunks stay inside "
                "the slot's pages")
        # the mixed-step engine has no interleaving policy: every queued
        # prefill chunk rides each dispatch (reference serving.py:1397)
        self.mixed_step = bool(mixed_step)
        if self.mixed_step and prefill_chunks_per_step is not None:
            raise ValueError(
                "prefill_chunks_per_step does not exist on the mixed-step "
                "engine: all queued prefill chunks ride every dispatch")
        if prefill_chunks_per_step is None:
            prefill_chunks_per_step = 1
        if int(prefill_chunks_per_step) < 1:
            raise ValueError("prefill_chunks_per_step must be >= 1")
        if int(admit_lookahead) < 1:
            raise ValueError("admit_lookahead must be >= 1")
        if decode_block == "adaptive":
            buckets = tuple(sorted({1, *(int(b) for b in
                                         decode_block_buckets)}))
            if any(b < 1 for b in buckets):
                raise ValueError("decode_block_buckets must be >= 1")
        else:
            decode_block = int(decode_block)
            if decode_block < 1:
                raise ValueError("decode_block must be >= 1 or "
                                 "'adaptive'")
            buckets = tuple(sorted({1, decode_block}))
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed_policy!r} "
                             f"(one of {SHED_POLICIES})")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.decode_block = decode_block
        self.decode_block_buckets = buckets
        self._k_ramp = 0
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self.preemption = bool(preemption)
        self.faults = fault_injector
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.max_seq_len = max_seq_len
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunks_per_step = int(prefill_chunks_per_step)
        self.admit_lookahead = int(admit_lookahead)
        self.pages_per_slot = max_seq_len // page_size
        if num_pages is None:
            # full occupancy never blocks on pages, +1 for the trash page
            num_pages = self.num_slots * self.pages_per_slot + 1
        self.attention = attention
        self.weight_dtype = weight_dtype
        self.kv_dtype = kv_dtype
        if params is None:
            params = init_params(cfg, seed=0, device=self.device)
        # the pools store the raw params' dtype unless kv_dtype says
        # otherwise (the reference reads it before any weight cast)
        raw_dtype = params["wte"].dtype
        params = raw_params = tree_map(
            lambda t: t.to(device=self.device, dtype=raw_dtype), params)
        # what the programs dispatch (reference ``_prep_weights``,
        # ``serving.py:1673``): the raw dict, its bf16 cast, or the
        # resident int8 artifact of int8 codes and f32 scales
        if weight_dtype == "bf16":
            params = cast_params(params)
        elif weight_dtype == "int8":
            params = quantize_weights_int8(params)
        # the bytes of a whole weight pass, and of this rank's shard
        self._weight_bytes = self._weight_bytes_chip = params_nbytes(params)
        if self.tp is not None:
            params = self.tp.prepare_params(params)
            self._weight_bytes_chip = params_nbytes(params)
        self.params = params
        # the journal's weights identity (reference serving.py:1515-1522):
        # blake2b of a strided sample of the raw embedding table as
        # float32, so the same weights give the same digest in both
        # packages
        wte = raw_params["wte"]
        sample = wte[::max(1, wte.shape[0] // 16),
                     ::max(1, wte.shape[1] // 8)]
        self._weights_digest = hashlib.blake2b(
            np.ascontiguousarray(sample.detach().float().cpu().numpy(),
                                 np.float32).tobytes(),
            digest_size=8).hexdigest()
        self.logit_health = bool(logit_health)
        core = make_layer_core(cfg, tp=self.tp)
        # a rank's pools: its heads, or all of them (kv_shard)
        self.kv = PagedKVCache(
            cfg.num_layers, num_pages, page_size,
            cfg.num_heads if self.tp is None else self.tp.pool_heads,
            cfg.hidden_size // cfg.num_heads, raw_dtype,
            prefix_cache=prefix_cache, kv_dtype=kv_dtype,
            device=self.device)
        self._fns = _build_serving_fns(
            core, num_slots=self.num_slots, page_size=self.page_size,
            pages_per_slot=self.pages_per_slot,
            prefill_chunk=self.prefill_chunk, attention=attention,
            device=self.device, quant=self.kv.quant_dtype,
            weight_quant=weight_dtype == "int8",
            spec_k=int(draft_k) if spec_on else None,
            logit_health=self.logit_health,
            h0=0 if self.tp is None else self.tp.h0)
        # the collective census of each program's first run (the
        # reference's per-dispatch HLO census keeps these keys)
        self.xla_costs = {}
        self.record_logits = bool(record_logits)
        self.logit_log = {}

        S, MP = self.num_slots, self.pages_per_slot
        self._bt = np.zeros((S, MP), np.int32)
        self._lengths = np.zeros(S, np.int64)
        self._tokens = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._temps = np.zeros(S, np.float32)
        self._eos = np.full(S, -1, np.int64)
        self._remaining = np.zeros(S, np.int64)
        self._gens = [None] * S     # per-slot torch.Generator (sampled)
        self._slots = {}
        self._free_slots = list(range(S - 1, -1, -1))
        self._prefilling = deque()  # slots with pending chunks, FIFO
        self._pending = RequestQueue()
        self._next_uid = 0
        self._next_seq = 0          # arrival order (queue tiebreak)
        self._next_admit = 0        # admission order (preempt tiebreak)
        self._admit_round = 0       # _try_admit call counter (anti-thrash)
        self._finished_now = []
        self._early_done = []       # completions minted outside a step
        self._cancel_pending = set()
        self._step_ema = None       # EMA seconds per single decode step
        self._closed = False
        self.stats = {"steps": 0, "prefill_chunks": 0,
                      "tokens_emitted": 0, "admitted": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "cached_tokens": 0, "cow_copies": 0,
                      "admission_skips": 0, "decode_blocks": 0,
                      "decode_block_k": 0, "fused_blocks": 0,
                      "sheds": 0, "preemptions": 0,
                      "collateral_requeues": 0, "cancelled": 0,
                      "deadline_expired": 0, "faults": 0, "resumes": 0,
                      # model-forward dispatches: prefill chunks, decode
                      # steps and fused blocks (as in the reference)
                      "dispatches": 0,
                      # decode forward passes: a fused block of K
                      # counts K (port-only: the kernel-launch check)
                      "decode_steps": 0, "mixed_steps": 0,
                      # speculative rounds and their proposals by
                      # verification outcome
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_rejected": 0,
                      # port-only: CUDA graphs captured / replayed (the
                      # reference pins its jit cache sizes)
                      "graph_captures": 0, "graph_replays": 0}
        if self.tp is not None:
            # which process group carries the collectives: a gloo run on
            # one card is no multi-GPU number
            self.stats["backend"] = self.mesh.backend
        self._steps = 0            # step() calls: the anatomy's clock
        self._log_seq = 0          # records written to the step log
        self._step_tenant_tokens = {}   # tenant -> tokens this step
        self.spec = None
        self._init_telemetry(registry, step_log, raw_params,
                             peak_flops, peak_hbm_bytes_per_s)
        self._init_tracing(tracer, tracing, postmortem_path)
        # the serving watchdog (reference serving.py:1608-1625): True
        # builds the default, a dict parameterizes it, an instance is
        # shared
        self.watchdog = None
        if watchdog:
            if isinstance(watchdog, ServingWatchdog):
                self.watchdog = watchdog
            else:
                kw = dict(watchdog) if isinstance(watchdog, dict) else {}
                self.watchdog = ServingWatchdog(
                    registry=self.metrics, tracer=self._tracer, **kw)
        # speculative decoding (reference serving.py:1623): the draft's
        # pool, weights and programs, riding this engine's page numbers
        self.spec = SpecState(self, speculative, int(draft_k),
                              raw_params) if spec_on else None
        # the first-token sample ends in a host read, so it is never
        # captured: eager on every device, in the census as the
        # reference's jit
        fns = self._fns     # (a lambda over self would make a cycle)
        self._sample_prog = self._compiles.track(
            "sample_first", EagerProgram(lambda: fns.sample_first, (),
                                         self.device))
        t0 = time.perf_counter()
        self._progs = self._build_programs(_capture)
        self.capture_seconds = time.perf_counter() - t0
        # the journal (reference serving.py:1644-1670): a writer is
        # shared, a path is owned (closed with the engine); events ride
        # the step clock self._steps
        self._owns_journal = False
        if journal is not None and not hasattr(journal, "event"):
            journal = JournalWriter(
                str(journal), name=f"engine{self.engine_id}-journal",
                registry=self.metrics,
                meta={"recorder": "ServingEngine",
                      "engine": self.engine_id})
            self._owns_journal = True
        self.journal = journal
        if journal is not None:
            self._journal_event("config", replica=f"e{self.engine_id}",
                                step=0,
                                fingerprint=self.config_fingerprint())
            if self.faults is not None and \
                    hasattr(self.faults, "bind_journal"):
                # a weak reference: the injector must not keep a dead
                # engine (and its graphs) alive in a cycle (C17)
                me = weakref.ref(self)
                self.faults.bind_journal(journal, lambda: me()._steps,
                                         f"e{self.engine_id}")

    # -- the journal ---------------------------------------------------------
    def _journal_event(self, kind, **fields):
        """Recording never breaks serving, as with traces."""
        if self.journal is None:
            return
        try:
            self.journal.event(kind, **fields)
        except Exception:
            pass

    # the MoE levers of the reference's GPTConfig, which the port does not
    # have (GPTConfig(num_experts>0) raises): their defaults, so the
    # fingerprint's model record is the reference's key for key
    _MOE_DEFAULTS = {"moe_top_k": 2, "moe_every": 2, "moe_aux_weight": 0.01}

    def config_fingerprint(self):
        """The engine-identity record the journal stores (reference
        ``config_fingerprint``, ``serving.py:1721``): the model config,
        every scheduling and quantization lever, and a weights digest,
        plus a stable hash of the whole record. Key for key the
        reference's; ``attention`` names the port's implementation
        (``auto`` / ``torch``, the reference's ``jax`` / ``pallas``), so
        the hashes of the two packages' engines differ."""
        model = {**self._MOE_DEFAULTS, **asdict(self.cfg)}
        fp = {
            "model": model,
            "num_slots": self.num_slots,
            "page_size": self.page_size,
            "num_pages": int(self.kv.num_pages),
            "max_seq_len": self.max_seq_len,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks_per_step": self.prefill_chunks_per_step,
            "mixed_step": self.mixed_step,
            "admit_lookahead": self.admit_lookahead,
            "attention": self.attention,
            "decode_block": self.decode_block,
            "decode_block_buckets": list(self.decode_block_buckets),
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "collective_dtype": self.collective_dtype,
            "chips": self.chips,
            "max_queue": self.max_queue,
            "shed_policy": self.shed_policy,
            "preemption": self.preemption,
            "prefix_cache": bool(self.kv.prefix_cache),
            "speculative": self.spec is not None,
            "weights_digest": self._weights_digest,
        }
        fp["fingerprint"] = _journal_digest(fp)
        return fp

    def _trace_id_of(self, uid):
        """A queued request's trace id ("" with tracing off)."""
        req = self._pending.find_uid(uid)
        return req.trace_id if req is not None else ""

    def _journal_complete(self, c):
        """The ``complete`` event, on the step the request finished at
        (the anatomy record's), with its segments: the replay identity
        payload."""
        eid = f"e{self.engine_id}"
        fin = self.anatomy.record_of(c.uid)
        self._journal_event(
            "complete", uid=c.uid,
            step=fin["finish_step"] if fin else self._steps,
            tokens=[int(t) for t in c.tokens],
            finish_reason=c.finish_reason, replica=eid, migrations=0,
            ttft_s=c.ttft_s, trace_id=f"{eid}:req{c.uid}",
            segments=self.anatomy.sequence_of(c.uid))

    def _idle_host(self, key):
        """Host inputs of program ``key`` at the idle state — block tables
        of zeros, no active slot — on which it writes the trash page 0
        only: the state each graph is captured on."""
        S, MP, C = self.num_slots, self.pages_per_slot, self.prefill_chunk
        zero = np.zeros((), np.int64)
        bt = np.zeros((S, MP), np.int32)
        flags = (np.zeros(S, bool), np.zeros(S, np.float32))
        budget = (np.full(S, -1, np.int64), np.zeros(S, np.int64))
        step = (bt, np.zeros(S, np.int64), np.zeros(S, np.int64), *flags)
        if key in ("copy_page", "draft_copy"):
            return zero, zero
        if key in ("prefill", "draft_prefill"):
            return np.zeros(MP, np.int32), zero, np.zeros(C, np.int64), zero
        if key == "mixed":      # QB rows a slot
            return (bt, np.zeros(S, np.int32), np.ones(S, np.int32),
                    np.zeros(S, np.int64),
                    np.zeros((S, self._fns.QB), np.int64),
                    np.zeros(S, np.int64), *flags, *budget)
        if key in (1, "mirror"):
            return step
        return (*step, *budget)     # fused blocks, propose and verify

    @torch.no_grad()
    def _build_programs(self, capture):
        """The programs this engine dispatches, keyed ``"copy_page"``,
        ``"prefill"``, the decode bucket ``K`` (1 is the decode step) or
        ``"mixed"``, and under speculation ``"verify"`` (per phase) and
        the draft's ``"draft_copy"``, ``"draft_prefill"``, ``"mirror"``
        and ``"propose"``: CUDA graphs on a CUDA device unless
        ``capture`` is false, else eager. A speculative engine's decode
        is per-token or a round, so it has no fused block. Each graph is
        captured on :meth:`_idle_host`'s state, so its warm-up and
        capture write the trash page 0 only."""
        S, V, kv, dev = (self.num_slots, self.cfg.vocab_size, self.kv,
                         self.device)
        fns, spec = self._fns, self.spec
        pools = (kv.k, kv.v, kv.k_scale, kv.v_scale)
        fixed = (self.params, *pools)
        graphs = GraphPool(dev) if capture and dev.type == "cuda" else None
        progs = {}

        def make(key, get_fn, fix, buffers=()):
            name = self._CENSUS_NAME.get(key, "decode_block")
            if graphs is None:
                progs[key] = EagerProgram(get_fn, fix, dev, buffers)
                self._compiles.track(name, progs[key])
                return
            self.stats["graph_captures"] += 1
            t0 = time.perf_counter()
            # a replay runs no Python: the census counts the capture
            census = self.tp.census() if self.tp is not None else None
            progs[key] = GraphProgram(graphs, get_fn(), fix,
                                      self._idle_host(key), buffers,
                                      during_capture=census)
            if census is not None:
                self._note_census(key, census, 1)
            self._compiles.track(name, progs[key], t0=t0,
                                 t1=time.perf_counter())

        def noise(*shape):
            return torch.zeros(*shape, S, V, device=dev)

        # the spec programs' draws and round inputs: gumbel [S, V],
        # uniforms [S, k], proposed [k, S], q_logits [k, S, V]
        verify_in = () if spec is None else (
            torch.zeros(S, spec.k, device=dev), spec.proposed,
            spec.q_logits)
        make("copy_page", lambda: fns.copy_page, pools)
        if self.mixed_step:
            make("mixed", lambda: fns.mixed, fixed, (noise(), *verify_in))
        else:
            make("prefill", lambda: fns.prefill, fixed)
            make(1, lambda: fns.decode_step, fixed, (noise(),))
            for k in self.decode_block_buckets:
                if k > 1 and spec is None:
                    make(k, lambda k=k: functools.partial(
                        fns.decode_block, k,
                        collect_logits=self.record_logits),
                         fixed, (noise(k),))
            if spec is not None:
                make("verify", lambda: fns.verify, fixed,
                     (noise(), *verify_in))
        if spec is not None:
            dfns = spec.fns
            dfixed = (spec.params, spec.dk, spec.dv, (), ())
            make("draft_copy", lambda: dfns.copy_page, dfixed[1:])
            make("draft_prefill", lambda: dfns.prefill, dfixed)
            # the mirror's token is discarded: no noise, nothing drawn
            make("mirror", lambda: lambda *a: dfns.decode_step(*a, None),
                 dfixed)
            make("propose", lambda: functools.partial(
                _propose, dfns.decode_block, spec.k, spec.proposed,
                spec.q_logits), dfixed, (noise(spec.k + 1),))
        self._compiles.publish()
        return progs

    # -- telemetry -----------------------------------------------------------
    # the census names of the programs: the reference's jitted function
    # names, which its serving_jit_compiles{fn} series carry (a decode
    # bucket K > 1 is "decode_block")
    _CENSUS_NAME = {1: "decode_step", "prefill": "prefill_chunk",
                    "copy_page": "page_copy", "mixed": "mixed_step",
                    "draft_prefill": "draft_prefill",
                    "mirror": "draft_mirror", "propose": "spec_propose",
                    "verify": "spec_verify", "draft_copy": "draft_copy"}
    _engine_ids = iter(range(1 << 62))  # "engine" label for gauge series
    _mesh_seqs = iter(range(1 << 62))   # mesh engines built on this rank

    def _init_telemetry(self, registry, step_log, raw_params, peak_flops,
                        peak_hbm_bytes_per_s):
        """Bind the metric families of the reference's
        ``_init_telemetry`` (``serving.py:1761``): the same names, help,
        labels, buckets and zero-materialisation. ``registry`` defaults
        to the process registry: counters and histograms of several
        engines aggregate, point-in-time gauges carry an ``engine``
        label. Gauge families are held, and the engine's series resolved
        at every update, so a ``registry.reset()`` cannot orphan them."""
        reg = registry if registry is not None else get_registry()
        self.metrics = reg
        self.engine_id = eid = str(next(ServingEngine._engine_ids))
        self._g_queue = reg.gauge(
            "serving_queue_depth", "requests waiting for a slot",
            labels=("engine",))
        self._g_active = reg.gauge(
            "serving_active_slots", "slots currently decoding",
            labels=("engine",))
        self._g_pages_free = reg.gauge(
            "serving_pages_free", "KV pages on the free list",
            labels=("engine",))
        self._g_pages_used = reg.gauge(
            "serving_pages_used",
            "KV pages held by live sequences (excludes the trash page "
            "and cache-only residents)",
            labels=("engine",))
        self._g_pages_cached = reg.gauge(
            "serving_pages_cached",
            "cache-only prefix-cache pages (no live reference, "
            "evictable LRU)",
            labels=("engine",))
        self._g_pages_shared = reg.gauge(
            "serving_pages_shared",
            "KV pages referenced by more than one live sequence",
            labels=("engine",))
        self._m_admissions = reg.counter(
            "serving_admissions_total", "requests admitted into a slot")
        self._m_admission_skips = reg.counter(
            "serving_admission_skips_total",
            "queued requests skipped over by admission lookahead "
            "(a later request fit when the head did not)")
        self._m_completions = reg.counter(
            "serving_completions_total", "finished requests by reason",
            labels=("reason",))
        self._m_tokens = reg.counter(
            "serving_tokens_emitted_total", "generated tokens emitted")
        self._m_prefix_hits = reg.counter(
            "serving_prefix_cache_hits_total",
            "full prompt pages mapped from the prefix cache instead of "
            "prefilled")
        self._m_prefix_misses = reg.counter(
            "serving_prefix_cache_misses_total",
            "full prompt pages that had to be prefilled (no cache "
            "entry)")
        self._m_prefix_tokens = reg.counter(
            "serving_prefix_cached_tokens_total",
            "prompt tokens whose prefill was skipped via the prefix "
            "cache")
        # may stay at zero on a cache-cold stream: materialize them so
        # exporters always see the family
        for c in (self._m_admission_skips, self._m_prefix_hits,
                  self._m_prefix_misses, self._m_prefix_tokens):
            c.inc(0)
        self._m_prefill_s = reg.histogram(
            "serving_prefill_chunk_seconds",
            "wall time of one chunked-prefill dispatch")
        self._m_decode_s = reg.histogram(
            "serving_decode_step_seconds",
            "wall time of one ragged decode dispatch (a per-token step "
            "or a K-step fused block) including sync")
        self._g_block_size = reg.gauge(
            "serving_decode_block_size",
            "current decode block size K (adaptive: 1 under mixed "
            "traffic, the largest runway-covered bucket under steady "
            "decode)",
            labels=("engine",))
        self._m_blocks = reg.counter(
            "serving_decode_blocks_total",
            "decode dispatches (each a block of K >= 1 fused steps)")
        self._m_tok_per_dispatch = reg.histogram(
            "serving_tokens_per_dispatch",
            "tokens emitted per decode dispatch (the dispatch-"
            "amortization win of fused blocks)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._m_blocks.inc(0)
        self._g_block_size.labels(engine=eid).set(0)
        self._m_ttft = reg.histogram(
            "serving_ttft_seconds",
            "time from add_request to the request's first token",
            buckets=DEFAULT_BUCKETS + (30.0, 60.0, 120.0, 300.0))
        self._m_preempt = reg.counter(
            "serving_preemptions_total",
            "in-flight requests evicted and requeued by reason "
            "(pages = page/slot pressure from a higher-priority "
            "request; collateral = shared an unwritten page with a "
            "torn-down prefill)",
            labels=("reason",))
        self._m_preempt.labels(reason="pages").inc(0)
        self._m_shed = reg.counter(
            "serving_shed_total",
            "requests shed by admission control at the queue bound "
            "(rejected incoming or dropped queued victims), by policy",
            labels=("policy",))
        self._m_shed.labels(policy=self.shed_policy).inc(0)
        self._m_deadline = reg.counter(
            "serving_deadline_expired_total",
            "requests failed by deadline expiry (queued, prefilling, "
            "or decoding)")
        self._m_deadline.inc(0)
        self._m_cancel = reg.counter(
            "serving_cancellations_total",
            "requests torn down via cancel(uid)")
        self._m_cancel.inc(0)
        self._m_resume_frac = reg.histogram(
            "serving_preempted_resume_cached_frac",
            "fraction of a preempted request's resume prompt (original "
            "prompt + emitted tokens) served from the prefix cache at "
            "re-admission — 1.0 means preemption cost only the COW "
            "final-token recompute",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 1.0))
        self._m_faults = reg.counter(
            "serving_faults_injected_total",
            "injected faults fired by the fault harness, by kind",
            labels=("kind",))
        self._g_kv_bytes = reg.gauge(
            "serving_kv_pool_bytes",
            "resident bytes of the paged K/V pools (+ scale tensors "
            "under int8), by storage dtype",
            labels=("engine", "dtype"))
        self._m_spec_rounds = reg.counter(
            "serving_spec_rounds_total",
            "speculative rounds dispatched (one draft-propose + one "
            "target-verify dispatch pair each)")
        self._m_spec_rounds.inc(0)
        self._m_spec_tokens = reg.counter(
            "serving_spec_tokens_total",
            "draft-proposed tokens by VERIFICATION outcome — the "
            "draft-quality measure (accepted = the target reproduced "
            "the proposal; emission may still truncate an accepted "
            "tail at EOS/budget, see the spec_verify span's emitted "
            "attr; rejected = rolled back)",
            labels=("result",))
        self._m_spec_tokens.labels(result="accepted").inc(0)
        self._m_spec_tokens.labels(result="rejected").inc(0)
        self._m_spec_accept = reg.histogram(
            "serving_spec_accept_rate",
            "per-round draft acceptance rate (accepted proposals / "
            "proposals, over the round's active slots)",
            buckets=(0.1, 0.25, 0.4, 0.5, 0.6, 0.75, 0.9, 0.95, 1.0))
        self._m_ragged_rows = reg.counter(
            "serving_ragged_rows_total",
            "ragged rows dispatched by the mixed-step executable, by "
            "kind (each slot contributes one row per dispatch: a "
            "prefill chunk, a decode token, or a speculative verify "
            "round)",
            labels=("kind",))
        for kind in ("prefill", "decode", "verify"):
            self._m_ragged_rows.labels(kind=kind).inc(0)
        self._m_ragged_qlen = reg.histogram(
            "serving_ragged_q_len",
            "query rows (q_len) of each live ragged row the mixed "
            "dispatch ran (1 = decode, C = a prefill chunk, k+1 = a "
            "verify round)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0))
        self._g_logit_absmax = self._m_logit_nonfinite = None
        if self.logit_health:
            self._g_logit_absmax = reg.gauge(
                "serving_logit_absmax",
                "abs-max of the last decode dispatch's logits (active "
                "slots; a fused block reports the max over its K "
                "steps, so a mid-block spike is never missed)",
                labels=("engine",))
            self._m_logit_nonfinite = reg.counter(
                "serving_logit_nonfinite_total",
                "nonfinite decode-logit values seen (active slots)")
            self._m_logit_nonfinite.inc(0)
        self._m_tok_lat = reg.histogram(
            "serving_token_latency_seconds",
            "observed per-token latency: each engine step's wall time "
            "attributed to every token it emitted (first tokens carry "
            "their prefill, the tail a user sees)")
        # the graph-capture census (observability/compile_tracker.py):
        # the reference's family name, counting CUDA graphs captured
        self._compiles = CompileTracker(
            reg, gauge_name="serving_jit_compiles",
            help="CUDA graphs captured per serving program (an eager "
                 "program counts 1 from its first dispatch) — the "
                 "counterpart of the reference's compiled executables; "
                 "a rise after the constructor means a capture on the "
                 "serving path",
            extra_labels={"engine": eid},
            replay_counter_name="serving_graph_replays_total")
        names = ["decode_step", "decode_block", "prefill_chunk",
                 "page_copy", "sample_first"]
        if self.mixed_step:
            names.append("mixed_step")
        for name in names:
            self._compiles.track(name)
        # the ledger: analytic per-phase FLOPs/bytes on shapes the
        # scheduler knows — host arithmetic only
        self.ledger = ServingLedger(
            reg, eid, self.cfg, raw_params, self.kv,
            platform=self.device.type, peak_flops=peak_flops,
            peak_hbm_bytes_per_s=peak_hbm_bytes_per_s,
            slots=self.num_slots,
            weight_bytes=self._weight_bytes,
            weight_bytes_chip=self._weight_bytes_chip,
            weight_dtype=self.weight_dtype or str(
                raw_params["wte"].dtype).replace("torch.", ""),
            tp=self.tp, act_bytes=self._act_bytes(raw_params))
        # the latency anatomy on the step clock
        self.anatomy = AnatomyLedger()
        self._anat_blocked_step = False
        self._h_segment = reg.histogram(
            "serving_segment_steps",
            "per-request anatomy segment sizes in engine steps, by "
            "segment (all eight observed per finished request, zeros "
            "included, so counts stay comparable across segments)",
            labels=("segment",), buckets=SEGMENT_STEP_BUCKETS)
        for seg in SEGMENTS:
            self._h_segment.labels(segment=seg)
        self._g_blocked_frac = reg.gauge(
            "serving_decode_blocked_frac",
            "cumulative decode interference: decode steps whose "
            "dispatch also carried prefill rows / all decode steps",
            labels=("engine",))
        self._g_blocked_frac.labels(engine=eid).set(0.0)
        self._step_logger, self._owns_step_logger = \
            StepLogger.coerce(step_log)
        self._update_pool_gauges()

    def _init_tracing(self, tracer, tracing, postmortem_path):
        """Bind the request tracer (reference ``_init_tracing``): the
        process tracer unless ``tracer`` is given; every request becomes
        the trace ``e<engine>:req<uid>``. The flight recorder dumps to
        ``postmortem_path`` (default: a per-engine file in the temp
        dir) on an exception in ``step()``, an injected fault,
        ``close()`` and SIGUSR1 (installed from the main thread only)."""
        self._tracer = None
        self._pm_handle = None
        self._postmortem_path = None
        self._span_queued = {}   # uid -> open "queued" span
        if not tracing:
            return
        self._tracer = tracer if tracer is not None else \
            _tracing.get_tracer()
        self._postmortem_path = str(postmortem_path) if postmortem_path \
            else os.path.join(
                tempfile.gettempdir(),
                f"paddle_tpu_torch_flightrec_{os.getpid()}"
                f"_e{self.engine_id}.json")
        self._pm_handle = _tracing.register_postmortem(
            self._tracer, self._postmortem_path)
        _tracing.install_signal_handler()  # no-op off the main thread

    def _trace_span(self, name, trace_id, parent_id=None, **attrs):
        """An open span on a request trace, or a null context when
        tracing is off or the trace is gone: a tracing bug must never
        take down the serving loop (the reference's contract, kept). The
        span is created here, inside the try; a Span is its own
        end-on-exit context."""
        if self._tracer is None or not trace_id:
            return contextlib.nullcontext()
        try:
            return self._tracer.start_span(name, trace_id=trace_id,
                                           parent_id=parent_id, **attrs)
        except Exception:
            return contextlib.nullcontext()

    def _end_trace(self, trace_id, **attrs):
        """End a request trace; never raises (as ``_trace_span``)."""
        if self._tracer is None or not trace_id:
            return
        try:
            self._tracer.end_trace(trace_id, **attrs)
        except Exception:
            pass

    def __del__(self):
        # an engine dropped without close() must not leave its
        # postmortem registration behind
        try:
            if getattr(self, "_pm_handle", None) is not None:
                _tracing.unregister_postmortem(self._pm_handle)
        except Exception:
            pass

    def _dump_postmortem(self, reason):
        """Flight-recorder dump (never raises). Returns the path or
        None."""
        if self._tracer is None or not self._postmortem_path:
            return None
        try:
            return self._tracer.dump(self._postmortem_path, reason=reason)
        except Exception:
            return None

    def export_timeline(self, path):
        """The merged Chrome-trace JSON of this engine's run: host
        profiler spans, this engine's tracer and the graph-capture
        events, one pid lane each (open in Perfetto)."""
        tracers = [self._tracer] if self._tracer is not None else []
        return _tracing.export_merged_chrome_trace(path, tracers=tracers)

    def _update_pool_gauges(self):
        if self._closed:  # never resurrect series close() retired
            return
        eid = self.engine_id
        self._g_queue.labels(engine=eid).set(len(self._pending))
        self._g_active.labels(engine=eid).set(int(self._active.sum()))
        self._g_pages_free.labels(engine=eid).set(self.kv.num_free)
        self._g_pages_used.labels(engine=eid).set(self.kv.num_in_use)
        self._g_pages_cached.labels(engine=eid).set(self.kv.num_cached)
        self._g_pages_shared.labels(engine=eid).set(self.kv.num_shared)
        # static values, re-set per step so the series survive a
        # registry.reset(); the draft's pool is resident memory too
        self._g_kv_bytes.labels(engine=eid, dtype=self.kv.kv_dtype).set(
            self.kv.pool_bytes())
        if self.spec is not None:
            self._g_kv_bytes.labels(engine=eid, dtype="draft").set(
                self.spec.pool_bytes())

    def _set_queue_gauge(self):
        if not self._closed:
            self._g_queue.labels(engine=self.engine_id).set(
                len(self._pending))

    # -- request intake ------------------------------------------------------
    def _positions_needed(self, prompt_len, max_new):
        """KV positions a request occupies: the larger of its total
        sequence and its chunk-padded prefill extent."""
        C = self.prefill_chunk
        return max(prompt_len + max_new, -(-prompt_len // C) * C)

    def _check_fits(self, prompt, max_new, what="prompt"):
        """Validate a request against the engine's position space and
        page pool (reference ``add_request``/``admit_migrated``)."""
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = self._positions_needed(prompt.size, max_new)
        if need > self.max_seq_len:
            raise ValueError(
                f"{what}({prompt.size}) + max_new({max_new}) "
                f"(prefill-padded to {need} positions) exceeds the "
                f"engine's max_seq_len({self.max_seq_len})")
        pages = -(-need // self.page_size)
        if pages > self.kv.num_pages - 1:  # page 0 is the trash page
            raise ValueError(
                f"request needs {pages} pages but the pool only has "
                f"{self.kv.num_pages - 1} — it could never be admitted")

    def _enqueue(self, prompt, priority, trace_ctx=None, trace_attrs=None,
                 **fields):
        """Run the shed policy at the ``max_queue`` bound, then queue a
        fresh Request under a new uid and arrival seq; its trace (with
        an open ``queued`` span), ledger record and anatomy record open
        here. Returns the uid."""
        if self.max_queue is not None and \
                len(self._pending) >= self.max_queue:
            self._shed_for(priority)  # raises unless a victim was shed
        uid = self._next_uid
        self._next_uid += 1
        trace_id = ""
        if self._tracer is not None:
            trace_id = f"e{self.engine_id}:req{uid}"
            # a sharded engine's traces carry its mp (reference
            # serving.py:2265-2276)
            extra = dict(trace_attrs or {},
                         **({"mp": self.chips} if self.tp else {}))
            try:
                self._tracer.start_trace(
                    "request", trace_id=trace_id, uid=uid,
                    engine=self.engine_id, parent_ctx=trace_ctx,
                    prompt_tokens=int(prompt.size),
                    max_new_tokens=int(fields["max_new_tokens"]), **extra)
                self._span_queued[uid] = self._tracer.start_span(
                    "queued", trace_id=trace_id,
                    queue_depth=len(self._pending), **extra)
            except Exception:
                trace_id = ""
        digests = _page_digests(prompt, self.page_size) \
            if self.kv.prefix_cache else ()
        seq = self._next_seq
        self._next_seq += 1
        tenant = fields["tenant"]
        self.ledger.register_request(uid, tenant, priority=priority)
        # a request lands between steps: the first step that sweeps its
        # anatomy record is self._steps + 1
        self.anatomy.register(uid, tenant=tenant, priority=priority,
                              trace_id=trace_id, step=self._steps)
        self._pending.push(Request(uid=uid, prompt=prompt, digests=digests,
                                   priority=priority, seq=seq,
                                   trace_id=trace_id, **fields))
        self._set_queue_gauge()
        return uid

    def add_request(self, prompt, max_new_tokens, temperature=0.0,
                    eos_id=None, seed=0, priority=0, deadline_s=None,
                    trace_ctx=None, tenant=None):
        """Enqueue a request; returns its uid. ``priority`` (higher wins)
        orders the queue and arms page-pool preemption; ``deadline_s``
        fails the request once that many seconds have passed since this
        call. At the ``max_queue`` bound the shed policy runs
        (``reject``, and a ``shed_lowest_priority`` arrival that
        outranks nothing, raise :class:`QueueFullError`).

        ``trace_ctx``: a caller's trace context (``Tracer.inject()``,
        possibly from another process): the request's trace parents
        under the caller's span in a merged timeline; a malformed one is
        dropped, never raised. ``tenant``: the cost-attribution label of
        the ``serving_tenant_*`` families (``None`` = ``"default"``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if deadline_s is not None and float(deadline_s) < 0:
            raise ValueError("deadline_s must be >= 0 (or None)")
        self._check_fits(prompt, int(max_new_tokens))
        tenant = str(tenant) if tenant else "default"
        uid = self._enqueue(
            prompt, int(priority), trace_ctx=trace_ctx,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=-1 if eos_id is None else int(eos_id), seed=int(seed),
            t_arrival=time.perf_counter(),
            deadline_s=None if deadline_s is None else float(deadline_s),
            tenant=tenant)
        # the journal's arrival (reference serving.py:2307), on the step
        # clock: it lands before step self._steps + 1
        if self.journal is not None:
            self._journal_event(
                "submit", uid=uid, step=self._steps,
                prompt=[int(t) for t in prompt],
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature),
                eos_id=None if eos_id is None else int(eos_id),
                seed=int(seed), priority=int(priority),
                deadline_s=None if deadline_s is None
                else float(deadline_s),
                tenant=tenant, trace_id=self._trace_id_of(uid))
        return uid

    def _shed_for(self, incoming_priority):
        """The queue is at ``max_queue``: shed one queued victim for an
        arrival of ``incoming_priority`` (finish_reason "shed") or raise
        QueueFullError."""
        policy = self.shed_policy
        victim = self._pending.pick_shed_victim(incoming_priority, policy)
        self.stats["sheds"] += 1
        self._m_shed.labels(policy=policy).inc()
        if victim is None:
            raise QueueFullError(
                f"queue full (depth {len(self._pending)} >= max_queue "
                f"{self.max_queue}, policy {policy!r})",
                depth=len(self._pending), policy=policy)
        self._pending.remove(victim)
        self._fail_queued(victim, "shed", policy=policy,
                          queue_depth=len(self._pending))

    # -- resilience ----------------------------------------------------------
    # the decision span a terminal reason records on the request's trace
    _DECISION_SPAN = {"cancelled": "cancel", "shed": "shed",
                      "deadline": "deadline", "aborted": "shutdown",
                      "error": "fault", "nonfinite": "fault"}

    def _count_failure(self, reason):
        if reason == "cancelled":
            self.stats["cancelled"] += 1
            self._m_cancel.inc()
        elif reason == "deadline":
            self.stats["deadline_expired"] += 1
            self._m_deadline.inc()

    def _count_fault(self, kind):
        self.stats["faults"] += 1
        self._m_faults.labels(kind=kind).inc()

    def _record_failure(self, uid, trace_id, reason, tokens, **attrs):
        """A request's terminal failure on its telemetry: the anatomy
        record closes, the decision span and the trace end, and the
        completion is counted."""
        self._anat_finish(uid, reason)
        with self._trace_span(self._DECISION_SPAN.get(reason, "fault"),
                              trace_id, uid=uid, **attrs,
                              tokens_emitted=tokens):
            pass
        self._end_trace(trace_id, status=reason, finish_reason=reason,
                        tokens_emitted=tokens)
        self._m_completions.labels(reason=reason).inc()
        self._count_failure(reason)

    def cancel(self, uid):
        """Mark ``uid`` for teardown at the next step boundary — queued,
        prefilling or decoding alike (finish_reason ``"cancelled"``,
        partial tokens kept, pages reclaimed). Returns True when the uid
        is live in the engine. Unapplied cancels force K=1."""
        uid = int(uid)
        known = (uid in self._cancel_pending
                 or self._pending.find_uid(uid) is not None
                 or any(st.uid == uid for st in self._slots.values()))
        if known:
            self._cancel_pending.add(uid)
        return known

    def _apply_cancels(self):
        while self._cancel_pending:
            uid = self._cancel_pending.pop()
            req = self._pending.find_uid(uid)
            if req is not None:
                self._pending.remove(req)
                self._fail_queued(req, "cancelled")
                continue
            slot = self._slot_of(uid)
            if slot is not None:
                self._abort_slot(slot, "cancelled")

    def _slot_of(self, uid):
        return next((s for s, st in self._slots.items() if st.uid == uid),
                    None)

    def _fail_queued(self, req, reason, **span_attrs):
        """Terminal failure of a queued request: its queued span ends,
        the decision span records, its trace ends; its Completion keeps
        the tokens it emitted before a preemption."""
        qs = self._span_queued.pop(req.uid, None)
        if qs is not None:
            qs.end(aborted=reason)
        toks = list(req.resume_out or [])
        self._early_done.append(Completion(
            req.uid, toks, reason, ttft_s=req.ttft_s,
            priority=req.priority, preemptions=req.preemptions,
            tenant=req.tenant))
        self._record_failure(req.uid, req.trace_id, reason, len(toks),
                             **span_attrs)
        self._set_queue_gauge()

    def _abort_slot(self, slot, reason, requeue=False):
        """Tear an in-flight request out of its slot: the shared path of
        cancellation, deadline expiry, faults, preemption
        (``requeue=True``) and teardown. Unregisters digests of pages this
        admission registered but never finished writing (requeueing any
        later admission that mapped one), releases the pages through the
        refcount / double-free guard, clears the slot's host mirrors, and
        either requeues the request (with its emitted tokens and
        generator state) or mints its failure Completion. Every open span
        of the request ends here."""
        st = self._slots.pop(slot)
        was_active = bool(self._active[slot])
        if st.sp_prefill is not None:
            st.sp_prefill.end(aborted=reason)
            st.sp_prefill = None
        if st.span_decode is not None:
            st.span_decode.end(tokens=len(st.out), steps=st.decode_steps,
                               aborted=reason)
            st.span_decode = None
        resume = None
        if requeue:
            prior = len(st.resume_out or [])
            new = st.out[prior:] if was_active else []
            if new:
                gen = self._gens[slot]
                resume = {"prompt": np.concatenate(
                    [st.toks[:st.prompt_len].astype(np.int32),
                     np.asarray(new, np.int32)]),
                    "out": list(st.out),
                    "key": None if gen is None else gen.get_state(),
                    "draft_key": None if self.spec is None
                    else self.spec.gen_state(slot)}
            else:
                resume = {"prompt": st.toks[:st.prompt_len].astype(np.int32),
                          "out": list(st.resume_out)
                          if st.resume_out else None,
                          "key": st.resume_key,
                          "draft_key": st.resume_draft_key}
            resume["digests"] = _page_digests(
                resume["prompt"], self.page_size) \
                if self.kv.prefix_cache else ()
        pages_freed = len(st.pages) + (1 if st.cow_src >= 0 else 0)
        collateral = self._release_slot_pages(st, was_active, resume)
        if slot in self._prefilling:
            self._prefilling.remove(slot)
        self._clear_slot(slot)
        if requeue:
            self._requeue_slot(st, resume, pages_freed, reason)
        else:
            self._early_done.append(Completion(
                st.uid, list(st.out), reason, ttft_s=st.ttft_s,
                priority=st.priority, preemptions=st.preemptions,
                tenant=st.tenant))
            self._record_failure(st.uid, st.trace_id, reason, len(st.out),
                                 pages_freed=pages_freed)
        # a torn-down prefill may strand later admissions that mapped its
        # now-unregistered pages: requeue them (they restart clean;
        # strict-FIFO chunk order means none of them has activated)
        for cslot in collateral:
            if cslot in self._slots:
                self._abort_slot(cslot, "collateral", requeue=True)

    def _release_slot_pages(self, st, was_active, resume):
        """Release ``st``'s pages. Unregisters digests this admission
        registered over pages never fully written; a preemption
        (``resume``) first registers the fully written generated pages
        under the resumed sequence's digests, so re-admission maps all
        but the uncached tail. Returns the slots that share an
        unregistered page: the collateral the caller requeues."""
        kv, PS = self.kv, self.page_size
        prior = len(st.resume_out or [])
        written = (st.prompt_len + len(st.out) - prior - 1) \
            if was_active else st.pf_base
        if resume is not None and was_active and kv.prefix_cache:
            for i in range(len(st.digests), len(resume["digests"])):
                if (i + 1) * PS <= written and i < len(st.pages):
                    kv.register(resume["digests"][i], st.pages[i])
        collateral = []
        if kv.prefix_cache and st.digests:
            bad_pages = set()
            for i in range(st.reg_from, len(st.digests)):
                if (i + 1) * PS <= written:
                    continue
                page = st.pages[i]
                if kv.unregister(st.digests[i]) and kv.refcount(page) > 1:
                    bad_pages.add(page)
            if bad_pages:
                collateral = [s for s, other in self._slots.items()
                              if bad_pages & set(other.pages)]
        if st.cow_src >= 0:
            kv.release([st.cow_src])
            st.cow_src = -1
        kv.release(st.pages)
        return collateral

    def _requeue_slot(self, st, resume, pages_freed, reason):
        """Preemption's tail: the ``preempt`` decision span on the
        victim's trace, a fresh ``queued`` span, and the resume Request
        back into the queue at the front of its priority class (its
        original seq)."""
        kv = self.kv
        k = 0
        while k < len(resume["digests"]) and \
                kv.lookup(resume["digests"][k]) is not None:
            k += 1
        tail = max(len(resume["prompt"]) - k * self.page_size, 0)
        with self._trace_span("preempt", st.trace_id, uid=st.uid,
                              reason=reason, pages_freed=pages_freed,
                              out_tokens=len(resume["out"] or []),
                              tail_tokens=int(tail)):
            pass
        self.ledger.note_preemption(st.uid)
        # the victim's later steps are "preempted" until re-admission
        self.anatomy.note_state(st.uid, "preempted")
        if self._tracer is not None and st.trace_id:
            try:
                self._span_queued[st.uid] = self._tracer.start_span(
                    "queued", trace_id=st.trace_id,
                    queue_depth=len(self._pending), resumed=True)
            except Exception:
                pass
        self._pending.push(Request(
            uid=st.uid, prompt=resume["prompt"],
            max_new_tokens=st.max_new - len(resume["out"] or []),
            temperature=st.temperature, eos_id=st.eos_id, seed=st.seed,
            t_arrival=st.t_arrival, digests=resume["digests"],
            priority=st.priority, deadline_s=st.deadline_s, seq=st.seq,
            resume_out=resume["out"], resume_key=resume["key"],
            resume_draft_key=resume["draft_key"], ttft_s=st.ttft_s,
            preemptions=st.preemptions + 1, tenant=st.tenant,
            trace_id=st.trace_id))
        self.stats["preemptions"] += 1
        if reason == "collateral":
            self.stats["collateral_requeues"] += 1
        self._m_preempt.labels(reason=reason).inc()

    def _expired(self, x, now):
        return x.deadline_s is not None and now - x.t_arrival > x.deadline_s

    def _expire_queued(self):
        now = time.perf_counter()
        for r in [r for r in self._pending if self._expired(r, now)]:
            self._pending.remove(r)
            self._fail_queued(r, "deadline",
                              waited_s=round(now - r.t_arrival, 6))

    def _expire_slots(self):
        """Deadline check at a prefill/decode dispatch boundary."""
        now = time.perf_counter()
        for slot in [s for s, st in self._slots.items()
                     if self._expired(st, now)]:
            if slot in self._slots:  # not requeued as collateral of an
                self._abort_slot(slot, "deadline")  # earlier abort

    def _preempt_victims(self, req):
        """Slots a preemption for ``req`` may evict: strictly lower
        priority, and not admitted by this same ``_try_admit`` call (an
        admit/preempt cycle inside one call could otherwise never
        end)."""
        return [s for s, st in self._slots.items()
                if st.priority < req.priority
                and st.admit_round != self._admit_round]

    def _preempt_for_head(self):
        """Evict the lowest-priority (then latest-admitted) in-flight
        request so the highest-priority queued request can be admitted;
        skipped when even evicting every eligible victim could not cover
        the head's uncached pages. Returns True if a victim was
        preempted."""
        if not self.preemption or not self._pending:
            return False
        head = self._pending[0]
        victims = self._preempt_victims(head)
        if not victims:
            return False
        if self._free_slots:
            rows = -(-self._positions_needed(
                head.prompt.size, head.max_new_tokens) // self.page_size)
            # the head's real demand is its uncached remainder, under the
            # cap _plan_admission applies (a fully cached prompt still
            # allocates its copy-on-write page)
            k, cow, _ = self._cached_prefix(head.digests, head.prompt.size)
            shared = (k - 1) if cow else k
            freeable = sum(1 for s in victims
                           for p in self._slots[s].pages
                           if self.kv.refcount(p) == 1)
            if self.kv.num_available + freeable < rows - shared:
                return False
        victim = min(victims, key=lambda s: (
            self._slots[s].priority, -self._slots[s].admit_seq))
        self._abort_slot(victim, "pages", requeue=True)
        return True

    def _teardown_all(self, reason):
        """``close()`` and the exception path of ``step()``: fail every
        queued request and abort every in-flight one with ``reason``,
        every page released through the double-free guard. Best effort,
        as the reference's (``serving.py:2705``): an abort that raises
        leaves its slot to the next sweep and never replaces the
        exception ``step()`` is re-raising."""
        self._cancel_pending.clear()
        # aborting a prefilling slot can requeue a later admission that
        # shared its pages (collateral): drain the queue again after the
        # slot sweep
        while self._pending or self._slots:
            before = (len(self._pending), len(self._slots))
            while self._pending:
                req = self._pending.pop(0)
                try:
                    self._fail_queued(req, reason)
                except Exception:
                    pass
            for slot in list(self._slots):
                if slot not in self._slots:  # collateral of an earlier abort
                    continue
                try:
                    self._abort_slot(slot, reason)
                except Exception:
                    pass
            if (len(self._pending), len(self._slots)) == before:
                break  # no progress: do not spin

    def _on_injected_fault(self, e):
        """An injected dispatch exception: the postmortem first (the
        trace still shows the in-flight state), then fail exactly the
        targeted request and keep serving."""
        self._count_fault(e.kind)
        self._dump_postmortem(f"fault:{e.kind}")
        slot = self._slot_of(e.uid)
        if slot is not None:
            self._abort_slot(slot, "error")

    def _check_nonfinite_fault(self):
        """Injected nonfinite decode logits: the targeted request fails
        with finish_reason "nonfinite". Only decoding slots are targets;
        a prefilling neighbour produced no decode logits."""
        if self.faults is None:
            return
        uids = [self._slots[s].uid for s in np.nonzero(self._active)[0]]
        if not uids:
            return
        hit = self.faults.fire("nonfinite_logits", uids=uids)
        if hit is None:
            return
        self._count_fault("nonfinite_logits")
        if self._m_logit_nonfinite is not None:
            self._m_logit_nonfinite.inc()
        self._dump_postmortem("fault:nonfinite_logits")
        slot = self._slot_of(hit["uid"])
        if slot is not None:
            self._abort_slot(slot, "nonfinite")

    def _decode_faults(self):
        """``decode_error`` and ``stall`` over the decoding slots, before
        the replay."""
        uids = [self._slots[s].uid for s in np.nonzero(self._active)[0]]
        if self.faults is None or not uids:
            return
        self.faults.maybe_raise("decode_error", uids=uids)
        if self.faults.stall(uids=uids) is not None:
            self._count_fault("stall")

    def _prefill_faults(self, st):
        """``prefill_error`` and ``stall`` for one prefill chunk."""
        if self.faults is None:
            return
        self.faults.maybe_raise("prefill_error", uid=st.uid)
        if self.faults.stall(uids=[st.uid]) is not None:
            self._count_fault("stall")

    # -- admission -----------------------------------------------------------
    def _cached_prefix(self, digests, P):
        """The longest usable cached prefix for a ``P``-token prompt,
        capped so the chunk-padded uncached tail stays inside the
        position space. Returns (k pages, cow, base0 — the first token
        the tail prefill must compute)."""
        kv, PS, C = self.kv, self.page_size, self.prefill_chunk
        k = 0
        while k < len(digests) and kv.lookup(digests[k]) is not None:
            k += 1
        cow = False
        while k > 0:
            cow = k * PS == P
            base0 = P - 1 if cow else k * PS
            if base0 + -(-(P - base0) // C) * C <= self.max_seq_len:
                return k, cow, base0
            k -= 1
        return 0, False, 0

    def _plan_admission(self, req):
        """Reserve the pages for ``req``: pin the longest cached prefix
        and allocate the rest. Returns the plan dict, or None — with
        every pin undone — when the pool cannot cover the request (or an
        injected ``page_exhaustion`` says so)."""
        if self.faults is not None and self.faults.fire(
                "page_exhaustion", uid=req.uid):
            self._count_fault("page_exhaustion")
            return None
        kv = self.kv
        P = req.prompt.size
        PS = self.page_size
        digests = req.digests
        k, cow, base0 = self._cached_prefix(digests, P)
        rows_total = -(-self._positions_needed(P, req.max_new_tokens)
                       // PS)
        shared_n = (k - 1) if cow else k
        shared = [kv.lookup(digests[i]) for i in range(shared_n)]
        pins = list(shared)
        cow_src = -1
        if cow:
            cow_src = kv.lookup(digests[k - 1])
            pins.append(cow_src)
        # pin BEFORE alloc: eviction must never reap a page this very
        # admission is about to map
        for p in pins:
            kv.share(p)
        own = kv.alloc(rows_total - shared_n)
        if own is None:
            kv.release(pins)
            return None
        return {"pages": shared + own, "shared": shared_n,
                "base0": base0, "cow_src": cow_src,
                "cow_dst": own[0] if cow else -1,
                "hits": k, "misses": len(digests) - k}

    def _try_admit(self):
        """Admit queued requests into free slots in priority order (FIFO
        within a class) with the bounded lookahead: when the head cannot
        get pages, up to ``admit_lookahead`` requests are scanned and the
        first that fits is admitted out of order (skips counted). The
        lookahead does not cross into a lower class while the blocked
        head could preempt instead. When nothing in the window fits,
        preemption evicts lower-priority in-flight work for the head."""
        self._expire_queued()
        self._admit_round += 1
        while self._pending:
            admitted = False
            if self._free_slots:
                head = self._pending[0]
                hold_class = self.preemption and \
                    bool(self._preempt_victims(head))
                for i in range(min(len(self._pending),
                                   self.admit_lookahead)):
                    req = self._pending[i]
                    if hold_class and req.priority != head.priority:
                        break
                    plan = self._plan_admission(req)
                    if plan is None:
                        continue
                    self._pending.pop(i)
                    if i:
                        self.stats["admission_skips"] += i
                        self._m_admission_skips.inc(i)
                    self._admit(req, self._free_slots.pop(), plan)
                    admitted = True
                    break
            if admitted:
                continue
            if not self._preempt_for_head():
                break

    def _admit(self, req, slot, plan):
        """Map the plan's pages into the slot's block table, register
        the digests this request's prefill will populate, and queue the
        prompt's chunks as deferred work. A resumed request's budget
        counts the tokens it emitted before. A later admission that maps
        one of these pages before it is written waits for it: the
        per-phase engine runs chunks strictly FIFO, the mixed one holds
        such a row back (:meth:`_prefill_hazard`)."""
        P = req.prompt.size
        C = self.prefill_chunk
        pages, base0 = plan["pages"], plan["base0"]
        pf_end = base0 + -(-(P - base0) // C) * C
        qs = self._span_queued.pop(req.uid, None)
        if qs is not None:
            qs.end(queue_wait_s=round(time.perf_counter() - req.t_arrival,
                                      6))
        self.anatomy.note_state(req.uid, "prefill")
        sp_prefill = None
        if self._tracer is not None and req.trace_id:
            try:
                sp_prefill = self._tracer.start_span(
                    "prefill", trace_id=req.trace_id, slot=int(slot),
                    pages=len(pages), prompt_tokens=int(P),
                    chunks=(pf_end - base0) // C, cached_tokens=int(base0),
                    cow_pages=1 if plan["cow_src"] >= 0 else 0)
            except Exception:
                sp_prefill = None
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(pages)] = pages
        self._bt[slot] = bt_row
        # register at ADMISSION: no later admission that maps these pages
        # reads them before they are written (see the docstring)
        for i in range(plan["hits"], len(req.digests)):
            self.kv.register(req.digests[i], pages[i])
        toks = np.zeros(pf_end, np.int64)
        toks[:P] = req.prompt
        resume_out = list(req.resume_out or [])
        self._slots[slot] = _SlotState(
            uid=req.uid, prompt_len=P,
            max_new=req.max_new_tokens + len(resume_out),
            eos_id=req.eos_id, pages=pages, out=resume_out,
            temperature=req.temperature, seed=req.seed,
            t_arrival=req.t_arrival, toks=toks, pf_base=base0,
            pf_end=pf_end, cow_src=plan["cow_src"], cow_dst=plan["cow_dst"],
            ttft_s=req.ttft_s, priority=req.priority,
            deadline_s=req.deadline_s, seq=req.seq,
            admit_seq=self._next_admit, admit_round=self._admit_round,
            digests=req.digests, reg_from=plan["hits"],
            preemptions=req.preemptions, resume_out=req.resume_out,
            resume_key=req.resume_key,
            resume_draft_key=req.resume_draft_key, tenant=req.tenant,
            trace_id=req.trace_id, sp_prefill=sp_prefill)
        self._next_admit += 1
        if base0:
            # prompt tokens the prefix cache served: the prefill cost
            # the cache saved this request and tenant
            self.ledger.note_cached(req.uid, base0)
        self._prefilling.append(slot)
        if req.preemptions:
            # how much of the resume prompt the prefix cache served
            self.stats["resumes"] += 1
            self._m_resume_frac.observe(base0 / max(P, 1))
        self.stats["admitted"] += 1
        self.stats["prefix_hits"] += plan["hits"]
        self.stats["prefix_misses"] += plan["misses"]
        self.stats["cached_tokens"] += base0
        self._m_admissions.inc()
        if plan["hits"]:
            self._m_prefix_hits.inc(plan["hits"])
            self._m_prefix_tokens.inc(base0)
        if plan["misses"]:
            self._m_prefix_misses.inc(plan["misses"])

    # -- prefill -------------------------------------------------------------
    def _run_cow_copy(self, st):
        """Clone the shared last page into the slot's private page
        before its tail chunk recomputes the final token."""
        parent = st.sp_prefill.span_id if st.sp_prefill is not None \
            else None
        with self._trace_span("cow_copy", st.trace_id, parent_id=parent,
                              src=int(st.cow_src), dst=int(st.cow_dst)):
            self._replay("copy_page", np.int64(st.cow_src),
                         np.int64(st.cow_dst))
        if self.spec is not None:
            self.spec.copy_page(st.cow_src, st.cow_dst)
        self.kv.release([st.cow_src])
        st.cow_src = -1
        self.stats["cow_copies"] += 1

    def _run_one_chunk(self, slot, st):
        """Dispatch the slot's next prefill chunk. Its wall-time
        histogram times the dispatch, as the reference's times its
        asynchronous jit call: nothing here waits for the device."""
        base, C, P = st.pf_base, self.prefill_chunk, st.prompt_len
        last = P - 1 - base if base <= P - 1 < base + C else 0
        parent = st.sp_prefill.span_id if st.sp_prefill is not None \
            else None
        with self._trace_span("prefill_chunk", st.trace_id,
                              parent_id=parent, base=base):
            with _prof.RecordEvent("serving.prefill_chunk",
                                   histogram=self._m_prefill_s):
                logits = self._replay("prefill", self._bt[slot],
                                      np.int64(base), st.toks[base:base + C],
                                      np.int64(last))
        if self.spec is not None:
            # the draft mirrors every target prefill chunk, so its pool
            # holds draft K/V wherever the target's does
            self.spec.prefill_chunk(slot, base, st.toks[base:base + C])
        # the ledger: useful positions only (padding rows are waste); the
        # collectives carry the whole chunk
        useful = max(min(C, P - base), 0)
        self.ledger.on_prefill_chunk(useful, base, phys_positions=C,
                                     owner=st.uid)
        if self.spec is not None:
            self.ledger.on_draft_prefill(useful, base, phys_positions=C,
                                         owner=st.uid)
        st.pf_base = base + C
        if st.pf_base >= st.pf_end:    # a graph's output: the next replay
            st.logits = logits.clone()  # overwrites it
        self.stats["prefill_chunks"] += 1
        self.stats["dispatches"] += 1

    def _run_prefill_chunks(self):
        """Run at most ``prefill_chunks_per_step`` chunks, strictly FIFO
        by admission order; a slot past its deadline is failed between
        chunks, an injected ``prefill_error`` fails its target, and a
        slot whose last chunk lands is activated."""
        budget = self.prefill_chunks_per_step
        ran = 0
        while budget > 0 and self._prefilling:
            slot = self._prefilling[0]
            st = self._slots[slot]
            if self._expired(st, time.perf_counter()):
                self._abort_slot(slot, "deadline")
                continue
            try:
                self._prefill_faults(st)
                if st.cow_src >= 0:
                    self._run_cow_copy(st)
                self._run_one_chunk(slot, st)
            except InjectedFault as e:
                self._on_injected_fault(e)
                continue
            ran += 1
            budget -= 1
            if st.pf_base >= st.pf_end:
                self._prefilling.popleft()
                self._activate(slot, st)
        return ran

    def _activate(self, slot, st):
        """Prefill complete: sample the first token and make the slot
        live for the next decode step. A sampled slot's generator is
        seeded here with the request's seed; a resumed slot's is
        restored from the state saved at preemption, so its first sample
        draws what the interrupted decode step would have drawn. A
        resumed slot continues its token list and keeps its TTFT.

        Under speculation a resumed slot samples nothing here: its last
        emitted token (the resume prompt's last) becomes the pending
        token, as it was when the slot was preempted, so the next round
        draws what the interrupted one would have (ROADMAP C16)."""
        gen = None
        if st.resume_key is not None:
            gen = torch.Generator(device=self.device)
            gen.set_state(st.resume_key)
        elif st.temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(st.seed)
        self._gens[slot] = gen
        self._temps[slot] = st.temperature
        self._active[slot] = True
        self._eos[slot] = st.eos_id
        if self.spec is not None:
            self.spec.on_activate(slot, st)
            if st.resume_out:
                st.logits = None
                st.out = list(st.resume_out)
                self._lengths[slot] = st.prompt_len
                self._tokens[slot] = st.out[-1]
                self._remaining[slot] = st.max_new - len(st.out)
                self._open_decode(slot, st, None)
                return
        tok = self._sample_prog.replay(st.logits, st.temperature, gen)
        if self.record_logits:
            self.logit_log.setdefault(st.uid, []).append(
                st.logits.float().cpu())
        st.logits = None
        st.out = list(st.resume_out or []) + [tok]
        self._lengths[slot] = st.prompt_len + 1
        self._tokens[slot] = tok
        self._remaining[slot] = st.max_new - len(st.out)
        self._open_decode(slot, st, tok)
        self._count_tokens(st, 1)
        if tok == st.eos_id:
            self._finish(slot, "eos")
        elif len(st.out) >= st.max_new:
            self._finish(slot, "length")

    def _open_decode(self, slot, st, tok):
        """An activated slot's telemetry: its prefill span ends, a first
        TTFT is observed, its anatomy turns ``decode`` from the next step
        on (this step's sweep already counted its prefill) and its
        ``decode`` span opens."""
        if st.sp_prefill is not None:
            st.sp_prefill.end(first_token=tok)
            st.sp_prefill = None
        if st.ttft_s is None:
            st.ttft_s = time.perf_counter() - st.t_arrival
            self._m_ttft.observe(st.ttft_s)
            self.ledger.note_ttft(st.uid, st.ttft_s)
        self.anatomy.note_state(st.uid, "decode")
        if self._tracer is not None and st.trace_id:
            try:
                st.span_decode = self._tracer.start_span(
                    "decode", trace_id=st.trace_id, slot=int(slot))
            except Exception:
                st.span_decode = None

    def _count_tokens(self, st, n):
        """``stats``, the registry counter, the request's ledger record
        and the step's per-tenant count move together (reference
        ``_count_tokens``), batched per slot."""
        self.stats["tokens_emitted"] += n
        self._m_tokens.inc(n)
        self.ledger.note_tokens(st.uid, n)
        self._step_tenant_tokens[st.tenant] = \
            self._step_tenant_tokens.get(st.tenant, 0) + n

    # -- decode --------------------------------------------------------------
    def _choose_block_k(self):
        """The decode block size for this dispatch (reference
        ``serving.py:3160``). Any pending admission, prefill or cancel
        forces K=1. Under steady pure-decode load the adaptive policy
        runs one confirming per-token step, then jumps to the largest
        bucket, clamped to the smallest bucket covering the largest
        remaining budget; it fuses nothing when the runway is shorter
        than ``2 * buckets[1]``. A fixed ``decode_block=K`` goes
        straight to its bucket. A live deadline clamps K so one fused
        block cannot overshoot it."""
        if self._pending or self._prefilling or self._cancel_pending:
            self._k_ramp = 0
            return 1
        if self.spec is not None:
            # a speculative engine's multi-token path is the round; its
            # other decode is per-token (a fused block would leave holes
            # in the draft's pool, which the mirror step fills)
            return 1
        buckets = self.decode_block_buckets
        max_rem = int(self._remaining[self._active].max())
        if self.decode_block == "adaptive":
            if len(buckets) == 1 or max_rem < 2 * buckets[1]:
                self._k_ramp = 0
                return 1
            if self._k_ramp == 0:
                self._k_ramp = 1
                return 1
            k = buckets[-1]
        else:
            k = self.decode_block
        if k > max_rem:
            k = min(b for b in buckets if b >= max_rem)
        return self._clamp_k_deadline(k)

    def _choose_spec(self):
        """Run a speculative round this dispatch (reference
        ``_choose_spec``, ``serving.py:3207``)? As the adaptive block:
        pending admission, prefill or cancel work takes the plain
        per-token step, so interleaving and TTFT are the plain engine's;
        a runway of one token cannot pay for the draft's dispatch; a live
        deadline that cannot cover ``k + 1`` steps falls back too."""
        if self.spec is None or not self._active.any():
            return False
        if self._pending or self._prefilling or self._cancel_pending:
            return False
        if int(self._remaining[self._active].max()) < 2:
            return False
        k1 = self.spec.k + 1
        return self._clamp_k_deadline(k1) >= k1

    def _clamp_k_deadline(self, k):
        """A K-step block commits the engine for about K steps; the
        nearest live deadline bounds how many it may fuse (per-step EMA;
        no EMA yet, a cold engine, takes K=1)."""
        if k <= 1:
            return k
        now = time.perf_counter()
        rem = min((st.deadline_s - (now - st.t_arrival)
                   for st in self._slots.values()
                   if st.deadline_s is not None), default=None)
        if rem is None:
            return k
        if self._step_ema is None or self._step_ema <= 0:
            return 1
        cap = int(rem / self._step_ema)
        if cap >= k:
            return k
        fit = [b for b in self.decode_block_buckets if b <= max(cap, 1)]
        return max(fit) if fit else 1

    def _replay(self, key, *host):
        """Dispatch program ``key`` on the host arrays ``host``: replay
        its graph (or call it eagerly). Returns its outputs; a graph's
        are overwritten by its next replay. A mesh leader sends the
        dispatch to its followers first."""
        self._send("replay", key, host)
        try:
            return self._run_program(key, host)
        except Exception as e:
            if self._role != "lead":
                raise
            self._mesh_failed(e)

    def _run_program(self, key, host):
        """Run program ``key`` on this rank; on a mesh, its first run
        counts its collectives into ``xla_costs`` (per scan step for the
        fused block and the propose scan, as the reference's census
        counts a scan body once)."""
        prog = self._progs[key]
        if isinstance(prog, GraphProgram):
            self.stats["graph_replays"] += 1
        name = self._CENSUS_NAME.get(key, "decode_block")
        if self.tp is None or name in self.xla_costs:
            return prog.replay(*host)
        with self.tp.census() as census:
            out = prog.replay(*host)
        self._note_census(key, census, 1)
        return out

    def _note_census(self, key, census, runs):
        """``xla_costs`` of program ``key`` from ``runs`` counted runs of
        it, per scan step for a fused block and the propose scan."""
        steps = runs * (key if isinstance(key, int) else (
            self.spec.k + 1 if key == "propose" else 1))
        self.xla_costs[self._CENSUS_NAME.get(key, "decode_block")] = {
            "collective_bytes": census.total // steps,
            "collective_by_op": {op: n // steps
                                 for op, n in census.by_op.items()}}

    def _fill_noise(self, key, k, gens=None):
        """Gumbel noise for the active sampled slots into program
        ``key``'s noise buffer, viewed ``[k, S, V]``, zero rows elsewhere
        (a greedy row's token ignores it). Each token draws its own
        ``[V]`` from its slot's generator (of ``gens``, default the
        target's), so a request's draws do not depend on how steps group
        into blocks; greedy slots draw nothing. A mesh leader sends the
        generators' states first, so every rank draws the same noise."""
        gens = self._gens if gens is None else gens
        draws = [(int(s), gens[s]) for s in np.nonzero(self._active)[0]
                 if self._temps[s] > 0]
        if self._role == "lead":
            self._send("noise", key, k,
                       [(s, g.get_state()) for s, g in draws])
        self._draw_noise(key, k, draws)

    def _draw_noise(self, key, k, draws):
        buf = self._progs[key].buffers[0].view(k, self.num_slots, -1)
        buf.zero_()
        V = self.cfg.vocab_size
        for s, gen in draws:
            buf[:, s] = torch.stack([
                _sampler.gumbel_noise((V,), gen, self.device)
                for _ in range(k)])

    def _fill_verify_noise(self, key, verify_rows):
        """The target generators' draws for program ``key`` (``"verify"``
        or a speculative ``"mixed"``): each active sampled slot draws one
        ``[V]`` Gumbel draw (its decode token or its round's correction),
        and a slot of ``verify_rows`` then its round's ``k`` acceptance
        uniforms. A round draws the same whatever its outcome; greedy
        slots draw nothing. Sent to a mesh's followers as
        :meth:`_fill_noise` is."""
        draws = [(int(s), self._gens[s], bool(verify_rows[s]))
                 for s in np.nonzero(self._active)[0] if self._temps[s] > 0]
        if self._role == "lead":
            self._send("verify_noise", key,
                       [(s, g.get_state(), v) for s, g, v in draws])
        self._draw_verify_noise(key, draws)

    def _draw_verify_noise(self, key, draws):
        gumbel, uniforms = self._progs[key].buffers[:2]
        gumbel.zero_()
        uniforms.zero_()
        V, k = self.cfg.vocab_size, self.spec.k
        for s, gen, verify in draws:
            gumbel[s] = _sampler.gumbel_noise((V,), gen, self.device)
            if verify:
                uniforms[s] = torch.rand(k, generator=gen,
                                         device=self.device)

    # -- the mesh: the leader's dispatch channel and the follower loop ------
    def _act_bytes(self, raw_params):
        """The residual stream's itemsize, which every collective of the
        programs carries (an int8 weight artifact is widened to float32
        at each dispatch's entry)."""
        if self.weight_dtype == "int8":
            return 4
        if self.weight_dtype == "bf16":
            return 2
        return raw_params["wte"].element_size()

    def _send(self, op, *args):
        """A mesh leader's message to its followers (nothing elsewhere).
        A failure here or in the dispatch that follows raises the
        follower's own error where one noted it (:meth:`_mesh_failed`)."""
        if self._role != "lead":
            return
        if self._chan is None:
            raise RuntimeError("this mesh engine's followers were stopped "
                               "(close() or a fatal error)")
        try:
            self._chan.send((self._mesh_seq, op, args))
        except Exception as e:
            self._mesh_failed(e)

    def _mesh_failed(self, err):
        """Raise the followers' noted failures (naming their ranks) in
        place of ``err``, a broken collective; ``err`` if none noted one."""
        notes = self._chan.failures() if self._chan is not None else []
        if notes:
            raise RuntimeError("mesh follower(s) failed: " + "; ".join(
                f"rank {r}:\n{tb}" for r, tb in notes)) from err
        raise err

    def _stop_followers(self):
        """Tell the followers to leave :meth:`follow` (once); never
        raises: a follower that is gone already has stopped."""
        chan, self._chan = self._chan, None
        if self._role == "lead" and chan is not None:
            try:
                chan.send((self._mesh_seq, "stop", ()))
            except Exception:
                pass

    def _gen(self, state):
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        return gen

    def follow(self, *more):
        """A follower rank's loop: receive the leader's dispatches and
        noise fills and run them over this rank's shard, until the
        leader closes the engine (or fails). ``more``: further engines of
        this rank (a fleet's replicas, built in the leader's order),
        served by the same loop until each is closed. A failure here is
        noted in the rank set's store for the leader, then raised; a
        wait longer than the process group's timeout raises."""
        engines = {e._mesh_seq: e for e in (self, *more)
                   if e._role == "follow"}
        if len(engines) != 1 + len(more):
            raise RuntimeError("follow() runs on a mesh follower (rank > 0)")
        try:
            with torch.no_grad():
                while engines:
                    seq, op, args = self._chan.recv()
                    eng = engines[seq]
                    if op == "stop":
                        eng._closed = True
                        del engines[seq]
                    else:
                        eng._follow_one(op, args)
        except BaseException:
            import traceback
            self._chan.note_failure(traceback.format_exc())
            raise

    def _follow_one(self, op, args):
        """One leader message on this follower engine."""
        if op == "replay":
            self._run_program(*args)
        elif op == "noise":
            key, k, states = args
            self._draw_noise(key, k, [(s, self._gen(st))
                                      for s, st in states])
        elif op == "verify_noise":
            key, states = args
            self._draw_verify_noise(key, [(s, self._gen(st), v)
                                          for s, st, v in states])
        elif op == "zero_round":
            self.spec.zero_round()
        else:
            raise RuntimeError(f"unknown mesh message {op!r}")

    def _log_step_logits(self, lg32, emit):
        """record_logits: keep each emitted token's logits per uid."""
        for slot in np.nonzero(emit)[0]:
            self.logit_log.setdefault(self._slots[slot].uid, []).append(
                lg32[slot].cpu())

    def _publish_logit_health(self, health):
        """A dispatch's logit health (the program's ``[2]`` output, read
        after the token read has synced the step)."""
        nonfinite, absmax = health.tolist()
        self._g_logit_absmax.labels(engine=self.engine_id).set(absmax)
        if nonfinite > 0:
            self._m_logit_nonfinite.inc(nonfinite)

    def _run_decode_step(self):
        """One per-token decode dispatch (K=1); returns ``(tokens
        emitted, 1)``. Its wall-time histogram covers the replay and the
        token read that syncs it."""
        self._fill_noise(1, 1)
        with _prof.RecordEvent("serving.decode_step",
                               histogram=self._m_decode_s):
            res = self._replay(1, self._bt, self._lengths, self._tokens,
                               self._active, self._temps)
            nxt = res[0].cpu().numpy()
        self.stats["dispatches"] += 1
        self.stats["decode_steps"] += 1
        if self.logit_health:
            self._publish_logit_health(res[2])
        if self.record_logits:
            self._log_step_logits(res[1], self._active)
        if self.spec is not None:
            # before the host mirrors advance: the draft writes the
            # position the target just wrote
            self.spec.mirror_step()
        finish_plan = []
        owners = []         # (uid, tokens, attended context) a slot
        for slot in np.nonzero(self._active)[0]:
            st = self._slots[slot]
            st.decode_steps += 1
            tok = int(nxt[slot])
            st.out.append(tok)
            owners.append((st.uid, 1, int(self._lengths[slot])))
            self._lengths[slot] += 1
            self._tokens[slot] = tok
            self._remaining[slot] -= 1
            self._count_tokens(st, 1)
            if tok == st.eos_id:
                finish_plan.append((slot, "eos"))
            elif len(st.out) >= st.max_new:
                finish_plan.append((slot, "length"))
        # attributed before the finish sweep: a request finishing now
        # carries this step's share on its finish span
        emitted, ctx = len(owners), sum(c for _, _, c in owners)
        self.ledger.on_decode(emitted, ctx, weight_passes=1, owners=owners)
        if self.spec is not None:
            # the draft's mirror ran the same positions
            self.ledger.on_draft(emitted, ctx, weight_passes=1,
                                 owners=owners)
        for slot, reason in finish_plan:
            self._finish(slot, reason)
        return emitted, 1

    def _run_decode_block(self, k):
        """One fused K-step decode dispatch, then apply the ``(K,
        slots)`` token block on the host; returns ``(tokens emitted,
        k)``."""
        self._fill_noise(k, k)
        with _prof.RecordEvent("serving.decode_block",
                               histogram=self._m_decode_s):
            res = self._replay(
                k, self._bt, self._lengths, self._tokens, self._active,
                self._temps, self._eos, self._remaining)
            tokb = res[0].cpu().numpy()         # (K, S) sampled tokens
            emitb = res[1].cpu().numpy()        # (K, S) emit mask
        if self.logit_health:
            self._publish_logit_health(res[3])
        if self.record_logits:
            for i, lg32 in enumerate(res[2]):
                self._log_step_logits(lg32, emitb[i])

        def block_span(slot, st, emitted, eos_hits):
            # the fused block as one span on each participating request
            # (a fused block runs on a pure-decode engine only)
            return "decode_block", dict(
                k=int(k), tokens_emitted=int(emitted),
                eos_hits=int(eos_hits),
                segment="decode_blocked" if self._anat_blocked_step
                else "decode_compute")

        emitted = self._apply_token_block(tokb, emitb, k, block_span)
        self.stats["fused_blocks"] += 1
        self.stats["dispatches"] += 1
        self.stats["decode_steps"] += k
        return emitted, k

    def _prefill_hazard(self, st, earlier):
        """C14: does ``st``'s next chunk read a page (or copy a COW
        source) that one of the ``earlier`` prefilling slots has not
        written yet? Such a page was registered at that slot's admission
        and mapped from the prefix cache by this one; the per-phase
        engine writes it first, since it runs chunks strictly FIFO."""
        PS = self.page_size
        reads = set(st.pages[:-(-(st.pf_base + self.prefill_chunk) // PS)])
        if st.cow_src >= 0:
            reads.add(st.cow_src)
        for e in earlier:
            last = -(-e.pf_end // PS)
            if reads & set(e.pages[e.pf_base // PS:last]):
                return True
        return False

    def _run_mixed_dispatch(self):
        """ONE ragged dispatch for everything (reference
        ``_run_mixed_dispatch``, ``serving.py:3510``):
        every queued prefill slot contributes its next chunk as a
        ``q_len = C`` row — a slot past its deadline or hit by an
        injected ``prefill_error`` is failed while the rows are packed,
        and a slot whose chunk would read a page an earlier prefilling
        slot has not written waits (:meth:`_prefill_hazard`, ROADMAP
        C14) — and every active slot a decode row, after the
        ``decode_error``/``stall`` faults. Under speculation the round's
        propose scan runs first and every active slot whose budget
        covers two tokens takes a verify row (``q_len = k + 1``); a
        dispatch with decode rows and no round is mirrored into the
        draft's pool, and every packed chunk is prefilled into it after
        the dispatch. A prefill slot whose last chunk lands is activated
        from the program's logits; decode and verify rows apply as a
        token block. Every participating request gets a ``mixed_step``
        span (its row's kind, q_len and anatomy segment). Returns
        ``(tokens emitted, the block's k)`` (``k + 1`` with a round)."""
        S, QB, C = self.num_slots, self._fns.QB, self.prefill_chunk
        spec = self.spec
        pf_rows = []   # (slot, st, base, last_idx)
        packed = []    # prefilling slots before this one, held back too
        for slot in list(self._prefilling):
            st = self._slots.get(slot)
            if st is None:      # requeued as collateral of an abort above
                continue
            if self._expired(st, time.perf_counter()):
                self._abort_slot(slot, "deadline")
                continue
            hazard = self._prefill_hazard(st, packed)
            packed.append(st)
            if hazard:
                continue
            try:
                self._prefill_faults(st)
                if st.cow_src >= 0:
                    self._run_cow_copy(st)
            except InjectedFault as e:
                self._on_injected_fault(e)
                packed.pop()
                continue
            base, P = st.pf_base, st.prompt_len
            last = P - 1 - base if base <= P - 1 < base + C else 0
            pf_rows.append((slot, st, base, last))
        # the dispatch's composition is known: its decode rows are
        # blocked iff prefill rows share it
        self._anat_blocked_step = len(pf_rows) > 0
        self.anatomy.resolve_decode(self._anat_blocked_step)
        self._decode_faults()
        active_slots = np.nonzero(self._active)[0]
        # the reference's spec gate (serving.py:3556-3569) without the
        # pending-work test: a verify row rides the dispatch beside any
        # prefill chunk
        K = spec.k if spec is not None else 0
        use_spec = (spec is not None and len(active_slots) > 0
                    and not self._cancel_pending
                    and int(self._remaining[self._active].max()) >= 2
                    and self._clamp_k_deadline(K + 1) >= K + 1)
        if use_spec:
            spec.propose()
        elif spec is not None:
            spec.zero_round()
        kind = np.zeros(S, np.int32)
        q_lens = np.ones(S, np.int32)
        start = np.zeros(S, np.int64)
        tokens_q = np.zeros((S, QB), np.int64)
        last_idx = np.zeros(S, np.int64)
        for s in active_slots:
            if use_spec and self._remaining[s] >= 2:
                kind[s] = 3
                q_lens[s] = K + 1
            else:
                kind[s] = 1
            start[s] = self._lengths[s] - 1
            tokens_q[s, 0] = self._tokens[s]
        for slot, st, base, last in pf_rows:
            kind[slot] = 2
            q_lens[slot] = C
            start[slot] = base
            tokens_q[slot, :C] = st.toks[base:base + C]
            last_idx[slot] = last
        old_len = {int(s): int(self._lengths[s]) for s in active_slots}
        if spec is not None:
            self._fill_verify_noise("mixed", kind == 3)
        else:
            self._fill_noise("mixed", 1)
        with _prof.RecordEvent("serving.mixed_step",
                               histogram=self._m_decode_s):
            res = self._replay(
                "mixed", self._bt, kind, q_lens, start, tokens_q,
                last_idx, self._active, self._temps, self._eos,
                self._remaining)
            tokb = res[0].cpu().numpy()         # (QB, S)
            emitb = res[1].cpu().numpy()
        pf_logits, lg_rows, n_acc = res[2:5]
        self.stats["dispatches"] += 1
        self.stats["mixed_steps"] += 1
        if self.logit_health:
            self._publish_logit_health(res[5])
        if self.record_logits:
            for i in range(lg_rows.shape[1]):
                self._log_step_logits(lg_rows[:, i], emitb[i])
        # per-row telemetry and the mixed_step span on every
        # participating request
        n_pf = len(pf_rows)
        n_dec = int((kind == 1).sum())
        n_ver = int((kind == 3).sum())
        kind_names = {1: "decode", 2: "prefill", 3: "verify"}
        for slot in [int(s) for s in active_slots] + \
                [slot for slot, _, _, _ in pf_rows]:
            st = self._slots[slot]
            kn = kind_names[int(kind[slot])]
            self._m_ragged_rows.labels(kind=kn).inc()
            self._m_ragged_qlen.observe(float(q_lens[slot]))
            span = st.sp_prefill if st.sp_prefill is not None \
                else st.span_decode
            seg = "prefill" if kn == "prefill" else (
                "decode_blocked" if n_pf else "decode_compute")
            with self._trace_span(
                    "mixed_step", st.trace_id,
                    parent_id=None if span is None else span.span_id,
                    kind=kn, q_len=int(q_lens[slot]), rows_prefill=n_pf,
                    rows_decode=n_dec, rows_verify=n_ver, owner=st.uid,
                    segment=seg):
                pass
        nacc = None
        if spec is not None:
            if use_spec:
                # the propose scan ran k + 1 draft steps for every active
                # slot (a decode row's proposals are computed too)
                owners = [(self._slots[int(s)].uid, K + 1,
                           sum(old_len[int(s)] + j for j in range(K + 1)))
                          for s in active_slots]
                self.ledger.on_draft(
                    (K + 1) * len(active_slots),
                    sum(c for _, _, c in owners), weight_passes=K + 1,
                    owners=owners)
                nacc = n_acc.cpu().numpy()
                spec.count_round(nacc, np.nonzero(kind == 3)[0])
            elif n_dec:
                # before the host mirrors advance, as per phase
                spec.mirror_step()
                owners = [(self._slots[int(s)].uid, 1, old_len[int(s)])
                          for s in active_slots]
                self.ledger.on_draft(len(active_slots),
                                     sum(c for _, _, c in owners),
                                     weight_passes=1, owners=owners)

        def mixed_span(slot, st, emitted, eos_hits):
            # verify rows keep the per-phase spec_verify decision span
            if kind[slot] != 3:
                return None
            return spec.verify_span(slot, int(nacc[slot]),
                                    int(emitb[:, slot].sum()),
                                    old_len[int(slot)])

        # a dispatch without active slots bills no decode weight pass:
        # its weight stream belongs to the prefill rows; the collectives
        # carried QB rows of every slot, the prefill rows' share billed
        # with them
        emitted = self._apply_token_block(
            tokb, emitb, QB, mixed_span,
            ledger_phase="spec_verify" if use_spec else "decode",
            weight_passes=1 if len(active_slots) else 0,
            ledger_positions=QB * (S - len(pf_rows)))
        for slot, st, base, last in pf_rows:
            with self._trace_span(
                    "prefill_chunk", st.trace_id,
                    parent_id=None if st.sp_prefill is None
                    else st.sp_prefill.span_id, base=base):
                pass
            if spec is not None:
                spec.prefill_chunk(slot, base, st.toks[base:base + C])
            useful = max(min(C, st.prompt_len - base), 0)
            self.ledger.on_prefill_chunk(useful, base, phys_positions=QB,
                                         owner=st.uid)
            if spec is not None:
                self.ledger.on_draft_prefill(useful, base,
                                             phys_positions=C, owner=st.uid)
            st.pf_base = base + C
            self.stats["prefill_chunks"] += 1
            if st.pf_base >= st.pf_end:
                st.logits = pf_logits[slot].clone()
                self._prefilling.remove(slot)
                self._activate(slot, st)
        return emitted, K + 1 if use_spec else 1

    def _apply_token_block(self, tokb, emitb, k, span_for=None,
                           ledger_phase="decode", weight_passes=None,
                           ledger_positions=None):
        """Apply a ``(k, slots)`` device token block to the host
        scheduler: append each slot's emitted tokens, finish
        EOS/budget-exhausted slots, advance the host mirrors (reference
        ``_apply_token_block``). ``span_for(slot, st, emitted,
        eos_hits)`` may return a ``(name, attrs)`` span to record under
        each participating request's decode span; ``ledger_phase`` and
        ``weight_passes`` (default ``k``) and ``ledger_positions`` (the
        positions the dispatch's collectives carried, default every slot
        of every pass) feed the ledger. Returns the tokens emitted."""
        plan = []
        eos_hits = 0
        for slot in np.nonzero(self._active)[0]:
            st = self._slots[slot]
            toks, reason = [], None
            for i in range(k):
                if not emitb[i, slot]:
                    break
                tok = int(tokb[i, slot])
                toks.append(tok)
                if tok == st.eos_id:
                    reason = "eos"
                    eos_hits += 1
                    break
                if len(st.out) + len(toks) >= st.max_new:
                    reason = "length"
                    break
            plan.append((slot, st, toks, reason))
        emitted = sum(len(toks) for _, _, toks, _ in plan)
        owners = []   # (uid, tokens, attended context) a live slot
        for slot, st, toks, reason in plan:
            ctx = 0
            for tok in toks:
                st.out.append(tok)
                st.decode_steps += 1
                # attended context: the slot's length at this step
                ctx += int(self._lengths[slot])
                self._lengths[slot] += 1
                self._tokens[slot] = tok
                self._remaining[slot] -= 1
            if toks:
                self._count_tokens(st, len(toks))
            owners.append((st.uid, len(toks), ctx))
        # attributed before the finish sweep: a request finishing in
        # this dispatch carries its share on its finish span
        self.ledger.on_decode(
            emitted, sum(c for _, _, c in owners),
            weight_passes=k if weight_passes is None else weight_passes,
            phase=ledger_phase, phys_positions=ledger_positions,
            owners=owners)
        for slot, st, toks, reason in plan:
            span = span_for(slot, st, emitted, eos_hits) \
                if span_for is not None else None
            if span is not None and st.span_decode is not None:
                name, attrs = span
                with self._trace_span(name, st.trace_id,
                                      parent_id=st.span_decode.span_id,
                                      **attrs):
                    pass
            if reason is not None:
                self._finish(slot, reason)
        return emitted

    def _clear_slot(self, slot):
        """Zero a vacated slot's host mirrors and free it. Every replay
        uploads these mirrors, so the next dispatch sees the slot
        inactive: its rows write the trash page only."""
        self._bt[slot] = 0
        self._lengths[slot] = 0
        self._tokens[slot] = 0
        self._active[slot] = False
        self._temps[slot] = 0.0
        self._eos[slot] = -1
        self._remaining[slot] = 0
        self._gens[slot] = None
        if self.spec is not None:
            self.spec.gens[slot] = None
        self._free_slots.append(slot)

    def _finish(self, slot, reason):
        """A request finished (``eos``/``length``): its decode span ends
        and its ``finish`` span carries its attributed cost and its
        anatomy, as the reference's (``serving.py:2339``)."""
        st = self._slots.pop(slot)
        if st.span_decode is not None:
            st.span_decode.end(tokens=len(st.out), steps=st.decode_steps)
        rec = self.ledger.request_record(st.uid) or {}
        anat = self._anat_finish(st.uid, reason)
        with self._trace_span(
                "finish", st.trace_id, reason=reason,
                pages_released=len(st.pages),
                anat_segments=anat["segments"],
                anat_total_steps=anat["total_steps"],
                anat_conserved=anat["conserved"],
                anat_blocked_frac=round(anat["blocked_frac"], 6),
                anat_tenant=anat["tenant"], anat_tier=anat["priority"],
                tenant=st.tenant,
                cost_flops=float(sum(rec.get("flops", {}).values())),
                cost_hbm_bytes=float(sum(rec.get("hbm_bytes", {}).values())),
                cost_collective_bytes=float(
                    sum(rec.get("collective_bytes", {}).values())),
                cached_tokens_saved=int(rec.get("cached_tokens", 0))):
            self.kv.release(st.pages)
            self._clear_slot(slot)
            self._finished_now.append(Completion(
                st.uid, st.out, reason, ttft_s=st.ttft_s,
                priority=st.priority, preemptions=st.preemptions,
                tenant=st.tenant))
            self._m_completions.labels(reason=reason).inc()
        self._end_trace(st.trace_id, finish_reason=reason,
                        tokens_emitted=len(st.out))

    def _anat_finish(self, uid, reason):
        """Close the anatomy record at the current step and feed the
        per-segment histogram (all eight segments, zeros included)."""
        rec = self.anatomy.finish(uid, self._steps, reason)
        if not self._closed:
            for seg, n in rec["totals"].items():
                self._h_segment.labels(segment=seg).observe(n)
        return rec

    # -- the engine loop -----------------------------------------------------
    @torch.no_grad()
    def step(self):
        """Admit what fits, then either one mixed dispatch of every
        queued prefill chunk and decode row (``mixed_step``), or up to
        ``prefill_chunks_per_step`` deferred prefill chunks and one
        decode dispatch (a step or a fused block) over every active
        slot. Returns the Completions finished now. An exception that
        escapes the step (``ReplicaDown``, or a real failure) first
        writes the flight-recorder postmortem (every in-flight request's
        partial span tree), then tears the engine down — every in-flight
        page released, the pool verifiable — and then propagates."""
        self._steps += 1
        try:
            comps = self._step()
        except Exception:
            self._dump_postmortem("exception")
            self._teardown_all("error")
            self._stop_followers()      # a mesh leader's fatal error
            raise
        if self.journal is not None:
            for c in comps:
                self._journal_complete(c)
        return comps

    def _step(self):
        """The reference's ``_step`` order (``serving.py:3759``): the
        anatomy sweep, the injected replica death, cancels, admission,
        prefill chunks, cancels and deadlines again, the dispatch with
        its injected faults, then the nonfinite fault and the trailing
        deadline check; the step's telemetry closes it."""
        # attribute this step to every live request by its state at the
        # step's start, before fault injection: a death step counts
        self.anatomy.on_step()
        if self.faults is not None and \
                self.faults.fire("replica_down") is not None:
            self._count_fault("replica_down")
            raise ReplicaDown(
                f"injected replica death (engine {self.engine_id})")
        t_step0 = time.perf_counter()
        tokens_before = self.stats["tokens_emitted"]
        chunks_before = self.stats["prefill_chunks"]
        self._finished_now = []
        self._step_tenant_tokens = {}
        self._apply_cancels()
        self._try_admit()
        if not self.mixed_step:
            ran = self._run_prefill_chunks()
            # a decode-ready step is blocked iff prefill chunks ran in
            # this step (the decode dispatch below waited for them)
            self._anat_blocked_step = ran > 0
            self.anatomy.resolve_decode(self._anat_blocked_step)
        self._apply_cancels()   # a cancel that landed while chunks ran
        self._expire_slots()    # deadlines at the dispatch boundary
        k_block = 0
        if self.mixed_step:
            if self._active.any() or self._prefilling:
                k_block = self._dispatch(self._run_mixed_dispatch)
        elif self._active.any():
            # reference serving.py:3832-3848
            if self._choose_spec():
                run = self.spec.run_round
            else:
                k = self._choose_block_k()
                run = functools.partial(self._run_decode_block, k) \
                    if k > 1 else self._run_decode_step
            k_block = self._dispatch(run, decode_faults=True)
        self._step_telemetry(t_step0, k_block,
                             self.stats["tokens_emitted"] - tokens_before,
                             self.stats["prefill_chunks"] - chunks_before)
        return self._finished_now

    def _dispatch(self, run, decode_faults=False):
        """Run one decode (or mixed) dispatch, ``run()`` returning
        ``(tokens emitted, k)``: an injected fault fails its target, a
        clean dispatch feeds the per-step EMA, the step counters and the
        block series and then meets the nonfinite fault; the deadline
        check follows either way. Returns ``k``, 0 when a fault hit."""
        t0 = time.perf_counter()
        k = 0
        try:
            if decode_faults:
                self._decode_faults()
            emitted, k = run()
        except InjectedFault as e:
            self._on_injected_fault(e)
            k = 0
        else:
            per = (time.perf_counter() - t0) / k
            self._step_ema = per if self._step_ema is None else \
                0.8 * self._step_ema + 0.2 * per
            self.stats["steps"] += 1
            self.stats["decode_blocks"] += 1
            self.stats["decode_block_k"] = k
            if not self._closed:
                self._g_block_size.labels(engine=self.engine_id).set(k)
            self._m_blocks.inc()
            self._m_tok_per_dispatch.observe(emitted)
            self._check_nonfinite_fault()
        self._expire_slots()    # the trailing dispatch boundary
        return k

    def _step_telemetry(self, t_step0, k_block, emitted, chunks_ran):
        """The step's tail (reference ``_step``, ``serving.py:3870``):
        its wall time to every token it emitted, overall and by tenant;
        the anatomy's pending decode records resolved (a dispatch that
        never ran blocked nobody); the gauges and the census; the
        ledger's completions and wall time; the step log. An idle poll
        (nothing dispatched, emitted or finished) adds no wall time and
        writes no record."""
        dt = time.perf_counter() - t_step0
        if emitted:
            self._m_tok_lat.observe(dt, emitted)
        for tenant, n in self._step_tenant_tokens.items():
            self.ledger.note_token_latency(tenant, dt, n)
        self.anatomy.resolve_decode(False)
        if not self._closed:
            self._g_blocked_frac.labels(engine=self.engine_id).set(
                round(self.anatomy.blocked_frac(), 6))
        self._update_pool_gauges()
        if not self._closed:
            self._compiles.publish()
        finished = self._early_done + self._finished_now
        self._early_done = []
        self._finished_now = finished
        for c in finished:
            self.ledger.on_completion(c)
        decoded = k_block > 0
        if decoded or emitted or finished or chunks_ran:
            self.ledger.on_step(dt)
            # the watchdog rides the step boundary (idle polls skipped,
            # the ledger's rule): host arithmetic over counter deltas
            if self.watchdog is not None:
                self.watchdog.observe(self)
        if self._step_logger is not None and (
                decoded or emitted or finished):
            self._log_seq += 1
            self._step_logger.log(
                "serving_step", step=self._log_seq, tokens=emitted,
                dt_s=round(dt, 6), queue_depth=len(self._pending),
                active_slots=int(self._active.sum()),
                pages_free=self.kv.num_free, prefill_chunks=chunks_ran,
                decode_k=k_block, finished=len(finished))

    def close(self):
        """Abort everything still in flight or queued (finish_reason
        ``"aborted"``; every page released through the double-free
        guard and every open span ended, so the pool verifies clean) and
        return ``{uid: Completion}`` of it, with any completion not yet
        delivered by a step. Then retire the engine's telemetry: the
        aborted requests' ledger records close, a final flight-recorder
        dump (reason ``"close"``) is written and the postmortem hook
        removed, a step log opened from a path is closed, and this
        engine's labeled gauge and census series leave the registry
        (shared counters and histograms keep their totals). Idempotent:
        a second call returns ``{}``. Afterwards ``has_work`` is
        False."""
        if self._closed:
            return {}
        self._teardown_all("aborted")
        self._stop_followers()
        aborted = {c.uid: c for c in self._early_done}
        self._early_done = []
        # the teardown never runs the step's tail: retire the stranded
        # cost records here (the tier goodput counters stay as the step
        # loop left them)
        for c in aborted.values():
            self.ledger.finish_request(c.uid, c.finish_reason,
                                       ttft_s=c.ttft_s)
        if self.journal is not None:
            for c in aborted.values():
                self._journal_complete(c)
            try:
                cons = {f"e{self.engine_id}": bool(
                    self.ledger.attribution_check()["conserved"])}
            except Exception:
                cons = {}
            self._journal_event("summary", step=self._steps,
                                stats=dict(self.stats), conserved=cons)
        self._closed = True
        self._dump_postmortem("close")
        if self._pm_handle is not None:
            _tracing.unregister_postmortem(self._pm_handle)
            self._pm_handle = None
        if self._owns_step_logger and self._step_logger is not None:
            self._step_logger.close()
        eid = self.engine_id
        for fam in (self._g_queue, self._g_active, self._g_pages_free,
                    self._g_pages_used, self._g_pages_cached,
                    self._g_pages_shared, self._g_block_size):
            fam.remove(engine=eid)
        self._g_kv_bytes.remove(engine=eid, dtype=self.kv.kv_dtype)
        if self.spec is not None:
            self._g_kv_bytes.remove(engine=eid, dtype="draft")
        if self._g_logit_absmax is not None:
            self._g_logit_absmax.remove(engine=eid)
        self._g_blocked_frac.remove(engine=eid)
        self._compiles.remove_series()
        self.ledger.close()
        self.anatomy.close()
        if self.journal is not None:
            try:
                if self._owns_journal:
                    self.journal.close()
                else:
                    self.journal.flush()
            except Exception:
                pass
        return aborted

    @property
    def has_work(self):
        return (bool(self._pending) or bool(self._slots)
                or bool(self._early_done) or bool(self._cancel_pending))

    def run(self, max_steps=None):
        """Drive step() until the stream drains; returns
        {uid: Completion}."""
        done = {}
        steps = 0
        while self.has_work:
            for c in self.step():
                done[c.uid] = c
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"serving loop exceeded max_steps={max_steps}")
        return done

    def compile_counts(self):
        """{fn: captures} of the graph-capture census (what
        ``serving_jit_compiles{engine=,fn=}`` publishes)."""
        return self._compiles.counts()

    def request_costs(self):
        """The per-request cost-attribution view (what a
        ``MetricsServer`` provider route serves as ``/requests.json``):
        every live and completed request record, the per-tenant rollup
        and the conservation check (``conserved`` must read true)."""
        doc = self.ledger.request_records()
        doc["engine"] = self.engine_id
        doc["tenants"] = self.ledger.tenant_totals()
        doc["conservation"] = self.ledger.attribution_check()
        return doc

    def anatomy_report(self):
        """The latency-anatomy view (``/anatomy.json``): every completed
        request's segment ledger, the per-tenant/per-tier p50/p99
        decomposition, the conservation tally (``frac`` must read 1.0)
        and the cumulative ``decode_blocked_frac``."""
        recs = self.anatomy.request_records()
        return {"engine": self.engine_id, "records": recs,
                "summary": summarize(recs),
                "conservation": self.anatomy.conservation_check(),
                "decode_blocked_frac": self.anatomy.blocked_frac(),
                "live": self.anatomy.live}

    # -- migration between engines (the fleet router's hooks) ----------------
    @property
    def queue_depth(self):
        """Queued (not yet admitted) requests — a router load signal."""
        return len(self._pending)

    @property
    def free_pages(self):
        """Pages an admission could claim right now (free + evictable
        cache-only residents) — the other router load signal."""
        return self.kv.num_available

    def inflight(self):
        """Every request live in this engine, queued and in a slot, as
        plain dicts."""
        out = [{"uid": r.uid, "priority": r.priority, "tenant": r.tenant,
                "seq": r.seq, "queued": True,
                "tokens_out": len(r.resume_out or [])}
               for r in self._pending]
        out.extend({"uid": st.uid, "priority": st.priority,
                    "tenant": st.tenant, "seq": st.seq, "queued": False,
                    "tokens_out": len(st.out)}
                   for st in self._slots.values())
        return out

    def eject(self, uid):
        """Remove a live request — queued or in flight — and return it as
        a resume-carrying :class:`Request` for another engine's
        :meth:`admit_migrated`. An in-flight request goes through the
        preemption path (emitted tokens and generator state kept, fully
        written pages registered under the resumed digests), so the
        migrated continuation is the same stream. Call between steps.
        Raises KeyError for a uid not live here."""
        uid = int(uid)
        self._cancel_pending.discard(uid)
        req = self._pending.find_uid(uid)
        if req is None:
            slot = self._slot_of(uid)
            if slot is None:
                raise KeyError(f"uid {uid} is not live in this engine")
            self._abort_slot(slot, "migrated", requeue=True)
            req = self._pending.find_uid(uid)
        self._pending.remove(req)
        # the local trace ends under a migrate decision span; the ledger
        # and anatomy records close as "migrated" (the destination
        # engine opens its own)
        qs = self._span_queued.pop(uid, None)
        if qs is not None:
            qs.end(aborted="migrated")
        tokens = len(req.resume_out or [])
        with self._trace_span("migrate", req.trace_id, uid=uid,
                              tokens_emitted=tokens):
            pass
        self._end_trace(req.trace_id, status="migrated",
                        finish_reason="migrated", tokens_emitted=tokens)
        self.ledger.finish_request(uid, "migrated")
        self._anat_finish(uid, "migrated")
        self._set_queue_gauge()
        return req

    def admit_migrated(self, req, trace_ctx=None):
        """Admit a :class:`Request` ejected from another engine under a
        fresh local uid and arrival seq, keeping the resume prompt, the
        remaining budget, the generator states, ``t_arrival`` (the TTFT
        and deadline basis), the observed ``ttft_s``, priority, deadline,
        tenant and preemption count. Digests are recomputed for this
        engine's page size. The same admission control as
        :meth:`add_request` (may shed, or raise QueueFullError); a fresh
        trace (``migrated=True``, under ``trace_ctx``), ledger record and
        anatomy record open here. Returns the new uid."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        max_new = int(req.max_new_tokens)
        self._check_fits(prompt, max_new, "migrated prompt")
        return self._enqueue(
            prompt, int(req.priority), trace_ctx=trace_ctx,
            trace_attrs={"migrated": True}, max_new_tokens=max_new,
            temperature=float(req.temperature), eos_id=int(req.eos_id),
            seed=int(req.seed), t_arrival=float(req.t_arrival),
            deadline_s=req.deadline_s,
            resume_out=list(req.resume_out) if req.resume_out else None,
            resume_key=req.resume_key,
            resume_draft_key=req.resume_draft_key, ttft_s=req.ttft_s,
            preemptions=int(req.preemptions), tenant=req.tenant)
