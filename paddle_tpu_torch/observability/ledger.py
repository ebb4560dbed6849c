"""Serving goodput / MFU / MBU ledger — port of
``paddle_tpu/observability/ledger.py``: an analytic model of the
model FLOPs and HBM bytes each serving phase performs, evaluated on the
host from shapes the scheduler already knows — no dispatch, no graph,
no device sync.

Conventions (the "useful work" convention MFU itself uses):

- **FLOPs** count the model math of tokens actually processed:
  ``2 * matmul_weights`` per token plus ``4 * H`` per attended context
  token per layer (QK^T + AV). Padding positions, masked slots and
  rolled-back speculative tails are waste, not work.
- **HBM bytes** count weight streaming (once per weight pass — a K-step
  fused decode block streams the weights K times) plus KV-cache traffic
  at the pool's storage dtype (int8/fp8 pages and their scales).
  Activations are ignored.
- **Goodput** is delivered useful tokens: completions that finished
  ``eos``/``length``.

Published series: ``serving_model_flops_total{phase}`` /
``serving_hbm_bytes_total{phase}`` (phases ``prefill``, ``decode``,
``spec_draft``, ``spec_verify``), ``serving_mfu`` / ``serving_mbu``
(engine-labeled; cumulative analytic work over serving wall time
against the configured peaks), the goodput and tier families, and
``serving_weight_bytes_per_step{engine,dtype}``. The default peaks are
one NVIDIA H100's published dense rates: 989 TFLOP/s in bf16 and
3.35 TB/s of HBM (the reference assumes a TPU v5e's 197 TFLOP/s and
819 GB/s). A card set below its 700 W limit reaches less; the peaks
are the data sheet's.

Per-request cost attribution: every dispatch's FLOPs and bytes are
apportioned to the requests in flight — a prefill chunk to its owner,
decode dispatches and speculative rounds over the live slots (matmul
and attention FLOPs and KV traffic by each slot's own counts, the
weight stream evenly over slot occupancy) — and rolled into the
``serving_tenant_*`` families under the request's ``tenant``, so

    sum over tenants of serving_tenant_flops_total{phase=p}
        == serving_model_flops_total{phase=p}     (hbm bytes likewise)

holds exactly: every increment lies on the dyadic grid float64 adds
exactly (see :meth:`ServingLedger._split_dispatch`), and
:meth:`ServingLedger.attribution_check` verifies it.

The mesh terms (reference ``ledger.py:156-253``): on an ``mp``-rank
tensor-parallel engine (``inference/tp.py``) the per-chip constants
divide where the layout shards (:meth:`ServingLedger._chip_split`: the
layer matmuls and attention by heads, the KV stream under
``kv_shard="heads"``; the replicated lm head counts in full on every
rank), each rank streams its own weight shard, and every weight pass
pays the collective payload ``coll_bytes_per_position`` for each
PHYSICAL position it carries (padding and idle slots ride the
collectives too): ``serving_collective_bytes_total{phase}``, apportioned
to requests under ``serving_tenant_collective_bytes_total`` with the
same exact conservation, and ``serving_mfu_per_chip`` /
``serving_mbu_per_chip``. The payload constant is
``TPContext.collective_payload_per_position``, which the engine's
counted collective census (``engine.xla_costs``) must equal. On one
card the mesh terms reduce to the single-chip values: the per-chip
gauges equal ``serving_mfu`` / ``serving_mbu`` and the collective
families stay at zero.
"""
from __future__ import annotations

from collections import deque

from ..quantization.weights import params_nbytes
from .registry import DEFAULT_BUCKETS

__all__ = ["ServingLedger", "model_costs", "LEDGER_PHASES",
            "GOODPUT_REASONS", "REQUEST_COST_BUCKETS"]

LEDGER_PHASES = ("prefill", "decode", "spec_draft", "spec_verify")

# serving_request_cost_* histogram boundaries: per-request analytic
# FLOPs/bytes span tiny test configs (~1e6) through long-context
# requests (~1e13) — decade buckets cover the range
REQUEST_COST_BUCKETS = tuple(10.0 ** e for e in range(5, 15))

# finish reasons whose tokens count as DELIVERED useful work
GOODPUT_REASONS = ("eos", "length")

# one NVIDIA H100 (SXM data sheet, dense): the bf16 tensor-core peak and
# the HBM3 bandwidth
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_PEAK_HBM_BYTES_PER_S = 3.35e12


def model_costs(cfg, params):
    """Analytic per-token cost constants of a GPT-2 ``cfg`` with the
    port's parameter dict ``params`` (dense layers; the reference's MoE
    term has no counterpart, the port's GPT has no experts):

    - ``matmul_flops_per_token`` — 2 FLOPs per matmul weight touched by
      one token's forward (qkv + attn proj + mlp per layer, plus the
      ``wte.T`` lm head),
    - ``attn_flops_per_ctx_token`` — 4*H per layer per attended
      context token (QK^T scores + AV mix),
    - ``param_bytes`` — resident bytes of ``params`` (what one weight
      pass streams from HBM),
    - ``matmul_flops_qkv`` / ``matmul_flops_head``, ``num_layers`` /
      ``hidden_size`` / ``act_bytes`` (the parameter itemsize), as the
      reference returns them.
    """
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L = cfg.num_layers
    mm_qkv = L * 2.0 * H * 3 * H
    mm_head = 2.0 * H * V                        # lm head (wte.T)
    mm = L * (2.0 * (H * 3 * H + H * H)          # qkv + attn out
              + 2.0 * (H * I + I * H)) + mm_head  # mlp
    return {"matmul_flops_per_token": mm,
            "attn_flops_per_ctx_token": 4.0 * H * L,
            "param_bytes": params_nbytes(params),
            "matmul_flops_qkv": mm_qkv,
            "matmul_flops_head": mm_head,
            "num_layers": int(L),
            "hidden_size": int(H),
            "act_bytes": int(params["wte"].element_size())}


class ServingLedger:
    """Per-engine goodput/MFU/MBU accounting — pure host arithmetic,
    fed by the engine's scheduler at phase boundaries (see the hooks
    in ``inference/serving.py`` / ``inference/speculative.py``)."""

    @staticmethod
    def _chip_split(c, mp, kv_shard, kv_bpt):
        """Per-chip ``(matmul FLOPs a token, attention FLOPs a context
        token, KV bytes a token)`` under an ``mp``-rank mesh (reference
        ``_chip_split``): the layer matmuls and attention shard by heads
        in both pool modes, the lm head stays whole; the KV stream
        divides under ``kv_shard="heads"`` only."""
        mm = c["matmul_flops_per_token"]
        attn = c["attn_flops_per_ctx_token"]
        if mp <= 1:
            return mm, attn, kv_bpt
        head = c["matmul_flops_head"]
        mm_chip = (mm - head) / mp + head
        if kv_shard == "heads":
            return mm_chip, attn / mp, kv_bpt / mp
        return mm_chip, attn / mp, kv_bpt

    def _tp_constants(self, c, tp, act_bytes=None):
        """The collective payload a position pays per weight pass, for
        one model (the target or the draft; reference
        ``_tp_constants``): 0 off a mesh."""
        if tp is None or self.mp <= 1:
            return 0.0
        ab = c["act_bytes"] if act_bytes is None else int(act_bytes)
        return float(tp.collective_payload_per_position(
            c["num_layers"], c["hidden_size"], ab))

    def __init__(self, registry, engine_id, cfg, params, kv, platform="",
                 peak_flops=None, peak_hbm_bytes_per_s=None, slots=1,
                 weight_bytes=None, weight_dtype=None,
                 max_request_records=1024, tp=None, weight_bytes_chip=None,
                 act_bytes=None):
        """``params`` the raw parameter dict; ``weight_bytes`` the bytes
        of what the programs dispatch (the bf16 cast or the int8
        artifact, codes and scales), which one weight pass streams;
        ``kv`` this rank's pool. On a mesh, ``tp`` (the engine's
        ``TPContext``), ``weight_bytes_chip`` (this rank's shard) and
        ``act_bytes`` (the residual stream's itemsize, the collectives'
        unit)."""
        self.engine_id = str(engine_id)
        self.platform = str(platform)
        self.peak_flops = float(peak_flops or DEFAULT_PEAK_FLOPS)
        self.peak_hbm_bytes_per_s = float(
            peak_hbm_bytes_per_s or DEFAULT_PEAK_HBM_BYTES_PER_S)
        c = model_costs(cfg, params)
        self._mm = c["matmul_flops_per_token"]
        self._attn = c["attn_flops_per_ctx_token"]
        self._param_bytes = c["param_bytes"] if weight_bytes is None \
            else float(weight_bytes)
        # KV bytes per resident token from the pool's actual storage:
        # pool_bytes includes the scale tensors, so the per-token figure
        # is exact for any kv_dtype
        self.mp = int(tp.mp) if tp is not None else 1
        self.kv_shard = tp.kv_shard if tp is not None else None
        self.collective_dtype = tp.collective_dtype if tp is not None \
            else "f32"
        # the whole pool's bytes: a heads-sharded rank holds 1/mp of it
        pool = kv.pool_bytes() * (self.mp if self.kv_shard == "heads"
                                  else 1)
        self.kv_bytes_per_token = pool / float(kv.num_pages * kv.page_size)
        self.kv_dtype = kv.kv_dtype
        self.slots = int(slots)
        self._mm_chip, self._attn_chip, self.kv_bytes_per_token_chip = \
            self._chip_split(c, self.mp, self.kv_shard,
                             self.kv_bytes_per_token)
        self._param_bytes_chip = self._param_bytes if \
            weight_bytes_chip is None else float(weight_bytes_chip)
        self.coll_bytes_per_position = self._tp_constants(c, tp, act_bytes)
        self._tp = tp
        self.weight_dtype = str(
            weight_dtype if weight_dtype is not None
            else f"f{c['act_bytes'] * 8}")
        self._draft = None  # (mm, attn, param_bytes, kv_bpt, chip
        #                      constants, coll/position)
        self.flops = {p: 0.0 for p in LEDGER_PHASES}
        self.bytes = {p: 0.0 for p in LEDGER_PHASES}
        self.flops_chip = {p: 0.0 for p in LEDGER_PHASES}
        self.bytes_chip = {p: 0.0 for p in LEDGER_PHASES}
        self.coll_bytes = {p: 0.0 for p in LEDGER_PHASES}
        self.wall_s = 0.0
        self.good_tokens = {}        # tier -> delivered useful tokens
        self.raw_tokens = {}         # tier -> all emitted tokens
        self._closed = False

        reg = registry
        self._c_flops = reg.counter(
            "serving_model_flops_total",
            "analytic model FLOPs performed, by serving phase "
            "(useful-work convention: padding/masked/rolled-back "
            "positions excluded)",
            labels=("phase",))
        self._c_bytes = reg.counter(
            "serving_hbm_bytes_total",
            "analytic HBM bytes moved (weight streaming + KV traffic "
            "at the pool's storage dtype), by serving phase",
            labels=("phase",))
        self._c_coll = reg.counter(
            "serving_collective_bytes_total",
            "analytic inter-chip collective PAYLOAD bytes (the "
            "Megatron all-reduce pair per layer per weight pass; "
            "physical convention: padded/masked positions ride the "
            "collectives too), by serving phase; zero on a single-card "
            "engine",
            labels=("phase",))
        for p in ("prefill", "decode"):
            self._c_flops.labels(phase=p).inc(0)
            self._c_bytes.labels(phase=p).inc(0)
            self._c_coll.labels(phase=p).inc(0)
        self._g_mfu = reg.gauge(
            "serving_mfu",
            "model-FLOPs utilization: cumulative analytic FLOPs over "
            "serving wall time, against the configured peak (default "
            "one H100's dense bf16 989 TFLOP/s)",
            labels=("engine",))
        self._g_mbu = reg.gauge(
            "serving_mbu",
            "HBM bandwidth utilization: cumulative analytic bytes "
            "over serving wall time, against the configured peak "
            "(default one H100's 3.35 TB/s)",
            labels=("engine",))
        self._g_mfu_chip = reg.gauge(
            "serving_mfu_per_chip",
            "per-chip model-FLOPs utilization on a mesh engine (sharded "
            "terms / mp, the replicated lm head counted in full on every "
            "rank); equals serving_mfu on one card",
            labels=("engine",))
        self._g_mbu_chip = reg.gauge(
            "serving_mbu_per_chip",
            "per-chip HBM bandwidth utilization on a mesh engine (each "
            "rank streams its weight shard and 1/mp of a heads-sharded "
            "pool or all of a replicated one); equals serving_mbu on "
            "one card",
            labels=("engine",))
        for g in (self._g_mfu, self._g_mbu, self._g_mfu_chip,
                  self._g_mbu_chip):
            g.labels(engine=self.engine_id).set(0)
        # the weight term as its own series: what ONE weight pass (a
        # decode step, a prefill chunk, a verify dispatch) streams,
        # labeled by the weights' storage dtype
        self._g_wbytes = reg.gauge(
            "serving_weight_bytes_per_step",
            "generation-parameter bytes one decode weight pass streams "
            "from HBM (the ledger's weight term; int8 codes + scales "
            "or the bf16 cast counted as stored), by weight storage "
            "dtype",
            labels=("engine", "dtype"))
        self._g_wbytes.labels(engine=self.engine_id,
                              dtype=self.weight_dtype).set(
            self._param_bytes)
        self._c_good = reg.counter(
            "serving_goodput_tokens_total",
            "delivered useful tokens (completions finishing "
            "eos/length) by priority tier — the goodput numerator",
            labels=("tier",))
        self._c_tier = reg.counter(
            "serving_tier_tokens_total",
            "all emitted tokens by priority tier (raw throughput "
            "numerator; goodput excludes deadline/shed/cancel/fault "
            "casualties)",
            labels=("tier",))
        self._g_good_rate = reg.gauge(
            "serving_goodput_tokens_per_s",
            "deadline-met useful tokens per second of serving wall "
            "time, by priority tier",
            labels=("engine", "tier"))
        self._g_raw_rate = reg.gauge(
            "serving_raw_tokens_per_s",
            "all emitted tokens per second of serving wall time, by "
            "priority tier",
            labels=("engine", "tier"))
        # -- per-request cost attribution ---------------------------------
        # live records by uid + a bounded ring of completed records
        # (what /requests.json serves); every share routed to a record
        # is rolled into the tenant families at the same time, so tenant
        # sums equal the phase totals exactly at every instant
        self.requests = {}
        self.completed_requests = deque(maxlen=int(max_request_records))
        self.tenant_costs = {}   # tenant -> this ledger's attributed totals
        self._c_t_flops = reg.counter(
            "serving_tenant_flops_total",
            "attributed analytic model FLOPs by tenant and serving "
            "phase; sums over tenants equal serving_model_flops_total "
            "per phase EXACTLY (the attribution conservation pin)",
            labels=("tenant", "phase"))
        self._c_t_bytes = reg.counter(
            "serving_tenant_hbm_bytes_total",
            "attributed analytic HBM bytes by tenant and serving phase "
            "(weight stream amortized over slot occupancy, KV traffic "
            "by each request's own context); conserves against "
            "serving_hbm_bytes_total exactly",
            labels=("tenant", "phase"))
        self._c_t_coll = reg.counter(
            "serving_tenant_collective_bytes_total",
            "attributed inter-chip collective payload bytes by tenant "
            "and phase; zero on a single-card engine",
            labels=("tenant", "phase"))
        self._c_t_tokens = reg.counter(
            "serving_tenant_tokens_total",
            "emitted tokens by tenant (the per-tenant raw-throughput "
            "numerator)",
            labels=("tenant",))
        self._c_t_good = reg.counter(
            "serving_tenant_goodput_tokens_total",
            "delivered useful tokens (eos/length completions) by "
            "tenant — the per-tenant goodput numerator",
            labels=("tenant",))
        self._c_t_cached = reg.counter(
            "serving_tenant_cached_tokens_total",
            "prompt tokens whose prefill was served from the prefix "
            "cache, by tenant (the cost the cache saved this tenant)",
            labels=("tenant",))
        self._c_t_reqs = reg.counter(
            "serving_tenant_requests_total",
            "finished requests by tenant and outcome (eos/length/"
            "deadline/shed/cancelled/... — the per-tenant shed and "
            "deadline scorecard)",
            labels=("tenant", "outcome"))
        self._h_t_ttft = reg.histogram(
            "serving_tenant_ttft_seconds",
            "time to first token by tenant (same boundaries as "
            "serving_ttft_seconds)",
            labels=("tenant",),
            buckets=DEFAULT_BUCKETS + (30.0, 60.0, 120.0, 300.0))
        self._h_t_lat = reg.histogram(
            "serving_tenant_token_latency_seconds",
            "observed per-token latency by tenant (each engine step's "
            "wall time attributed to the tokens it emitted, split by "
            "the emitting request's tenant)",
            labels=("tenant",))
        self._h_req_flops = reg.histogram(
            "serving_request_cost_flops",
            "attributed analytic model FLOPs of one completed request "
            "(all phases)",
            buckets=REQUEST_COST_BUCKETS)
        self._h_req_bytes = reg.histogram(
            "serving_request_cost_hbm_bytes",
            "attributed analytic HBM bytes of one completed request "
            "(weight-stream amortization + its own KV traffic, all "
            "phases)",
            buckets=REQUEST_COST_BUCKETS)

    def set_draft(self, cfg, params, draft_pool_bytes, num_pages,
                  page_size, weight_bytes=None, weight_bytes_chip=None,
                  act_bytes=None):
        """Register the speculative draft's cost constants: its own
        matmul/attention terms, the bytes of its dispatched weights
        (the target's weight lever applies to it too) and its pool's
        KV bytes per token (``draft_pool_bytes`` this rank's; on a mesh
        the draft shards as the target does)."""
        c = model_costs(cfg, params)
        pool = draft_pool_bytes * (self.mp if self.kv_shard == "heads"
                                   else 1)
        kv_bpt = pool / float(num_pages * page_size)
        pbytes = c["param_bytes"] if weight_bytes is None \
            else float(weight_bytes)
        mm_chip, attn_chip, kv_chip = self._chip_split(
            c, self.mp, self.kv_shard, kv_bpt)
        self._draft = (c["matmul_flops_per_token"],
                       c["attn_flops_per_ctx_token"], pbytes, kv_bpt,
                       mm_chip, attn_chip,
                       pbytes if weight_bytes_chip is None
                       else float(weight_bytes_chip), kv_chip,
                       self._tp_constants(c, self._tp, act_bytes))

    # -- per-request cost attribution ----------------------------------------
    def register_request(self, uid, tenant="default", priority=0):
        """Open (or re-open — a preempted request keeps its record) the
        cost record for ``uid`` under ``tenant``. Every later dispatch
        share lands on this record AND the tenant families."""
        rec = self.requests.get(int(uid))
        if rec is not None:
            return rec
        return self._new_record(int(uid), tenant, priority)

    def _new_record(self, uid, tenant, priority):
        t = str(tenant or "default")
        rec = {"uid": int(uid), "tenant": t, "priority": int(priority),
               "flops": {}, "hbm_bytes": {}, "collective_bytes": {},
               "tokens": 0, "cached_tokens": 0,
               "spec_accepted": 0, "spec_rejected": 0,
               "preemptions": 0, "outcome": None, "ttft_s": None}
        self.requests[uid] = rec
        tc = self.tenant_costs.get(t)
        if tc is None:
            tc = self.tenant_costs[t] = {
                "flops": {}, "hbm_bytes": {}, "collective_bytes": {},
                "tokens": 0, "goodput_tokens": 0, "cached_tokens": 0,
                "requests": {}}
            # materialize the hot-phase series so exporters see the
            # families on a calm stream
            for p in ("prefill", "decode"):
                self._c_t_flops.labels(tenant=t, phase=p).inc(0)
                self._c_t_bytes.labels(tenant=t, phase=p).inc(0)
                self._c_t_coll.labels(tenant=t, phase=p).inc(0)
            self._c_t_tokens.labels(tenant=t).inc(0)
            self._c_t_good.labels(tenant=t).inc(0)
            self._c_t_cached.labels(tenant=t).inc(0)
        return rec

    def _rec(self, uid):
        rec = self.requests.get(int(uid))
        # an unregistered uid still gets its share (conservation must
        # never leak cost), under the default tenant
        return rec if rec is not None else self._new_record(
            int(uid), "default", 0)

    @staticmethod
    def _split_dispatch(owners, flops, nbytes, coll, mm, attn, kvb, wtot):
        """Per-request shares of one multi-slot dispatch, summing
        EXACTLY to the dispatch totals. ``owners`` is
        ``[(uid, tokens_i, ctx_i)]`` over the live slots: matmul and
        attention FLOPs and KV traffic follow each slot's own counts;
        the weight stream ``wtot`` and the collective payload ``coll``
        are amortized evenly over slot occupancy, integer-snapped, the
        remainder to the last slot — every share stays on the dyadic
        grid float64 adds exactly."""
        n = len(owners)
        if n == 0:
            return []
        wbase = float(int(wtot / n))
        cbase = float(int(coll / n))
        out = []
        f_acc = b_acc = c_acc = 0.0
        for uid, toks, ctx in owners[:-1]:
            f = toks * mm + attn * float(ctx)
            b = wbase + (float(ctx) + toks) * kvb
            out.append((uid, f, b, cbase))
            f_acc += f
            b_acc += b
            c_acc += cbase
        # the max() is a no-op on the exact grid; off it (a page size
        # that is not a power of two under quantized pools) an ulp of
        # rounding must not hand Counter.inc a negative
        out.append((owners[-1][0], max(flops - f_acc, 0.0),
                    max(nbytes - b_acc, 0.0), max(coll - c_acc, 0.0)))
        return out

    def _attr(self, phase, shares):
        """Route one dispatch's per-request shares onto the records and
        the tenant counters, aggregated per tenant before the
        increments (summing grid values first is still exact)."""
        per_tenant = {}   # tenant -> [flops, bytes, coll]
        for uid, f, b, c in shares:
            rec = self._rec(uid)
            t = rec["tenant"]
            tc = self.tenant_costs[t]
            rec["flops"][phase] = rec["flops"].get(phase, 0.0) + f
            rec["hbm_bytes"][phase] = \
                rec["hbm_bytes"].get(phase, 0.0) + b
            tc["flops"][phase] = tc["flops"].get(phase, 0.0) + f
            tc["hbm_bytes"][phase] = \
                tc["hbm_bytes"].get(phase, 0.0) + b
            agg = per_tenant.setdefault(t, [0.0, 0.0, 0.0])
            agg[0] += f
            agg[1] += b
            if c:
                rec["collective_bytes"][phase] = \
                    rec["collective_bytes"].get(phase, 0.0) + c
                tc["collective_bytes"][phase] = \
                    tc["collective_bytes"].get(phase, 0.0) + c
                agg[2] += c
        for t, (f, b, c) in per_tenant.items():
            self._c_t_flops.labels(tenant=t, phase=phase).inc(f)
            self._c_t_bytes.labels(tenant=t, phase=phase).inc(b)
            if c:
                self._c_t_coll.labels(tenant=t, phase=phase).inc(c)

    def note_cached(self, uid, tokens):
        """Prompt tokens served from the prefix cache at admission —
        the cost the cache SAVED this request/tenant."""
        tokens = int(tokens)
        if tokens <= 0:
            return
        rec = self._rec(uid)
        rec["cached_tokens"] += tokens
        self.tenant_costs[rec["tenant"]]["cached_tokens"] += tokens
        self._c_t_cached.labels(tenant=rec["tenant"]).inc(tokens)

    def note_tokens(self, uid, n=1):
        rec = self._rec(uid)
        rec["tokens"] += int(n)
        self.tenant_costs[rec["tenant"]]["tokens"] += int(n)
        self._c_t_tokens.labels(tenant=rec["tenant"]).inc(n)

    def note_ttft(self, uid, ttft_s):
        rec = self._rec(uid)
        rec["ttft_s"] = float(ttft_s)
        self._h_t_ttft.labels(tenant=rec["tenant"]).observe(ttft_s)

    def note_token_latency(self, tenant, dt_s, n=1):
        """One step's wall time attributed to each of the ``n`` tokens
        a tenant's requests emitted in it."""
        self._h_t_lat.labels(tenant=str(tenant or "default")).observe(
            dt_s, int(n))

    def note_preemption(self, uid):
        self._rec(uid)["preemptions"] += 1

    def note_spec(self, uid, accepted, rejected):
        rec = self._rec(uid)
        rec["spec_accepted"] += int(accepted)
        rec["spec_rejected"] += int(rejected)

    def finish_request(self, uid, outcome, ttft_s=None):
        """Close ``uid``'s record with its terminal outcome: tenant
        outcome/goodput counters move, the request-cost histograms
        observe the attributed totals, and the record retires into the
        bounded completed ring."""
        rec = self.requests.pop(int(uid), None)
        if rec is None:
            return None
        rec["outcome"] = str(outcome)
        if ttft_s is not None:
            rec["ttft_s"] = float(ttft_s)
        t = rec["tenant"]
        tc = self.tenant_costs[t]
        tc["requests"][rec["outcome"]] = \
            tc["requests"].get(rec["outcome"], 0) + 1
        self._c_t_reqs.labels(tenant=t, outcome=rec["outcome"]).inc()
        if rec["outcome"] in GOODPUT_REASONS:
            tc["goodput_tokens"] += rec["tokens"]
            self._c_t_good.labels(tenant=t).inc(rec["tokens"])
        self._h_req_flops.observe(sum(rec["flops"].values()))
        self._h_req_bytes.observe(sum(rec["hbm_bytes"].values()))
        self.completed_requests.append(rec)
        return rec

    def request_record(self, uid):
        """The live or completed cost record for ``uid`` (None when
        never seen or evicted from the completed ring)."""
        rec = self.requests.get(int(uid))
        if rec is not None:
            return rec
        for r in reversed(self.completed_requests):
            if r["uid"] == int(uid):
                return r
        return None

    @staticmethod
    def _copy_rec(r):
        out = dict(r)
        for k in ("flops", "hbm_bytes", "collective_bytes"):
            out[k] = dict(r[k])
            out[k + "_total"] = float(sum(r[k].values()))
        return out

    def request_records(self):
        """JSON-ready copies of every live + completed cost record (the
        /requests.json payload; container snapshots are single C-level
        calls, safe against a serving thread mutating them)."""
        return {
            "live": [self._copy_rec(r)
                     for r in list(self.requests.values())],
            "completed": [self._copy_rec(r)
                          for r in list(self.completed_requests)]}

    def tenant_totals(self):
        """Per-tenant attributed totals of THIS ledger: cost by phase,
        tokens/goodput/cached counts, and the outcome split."""
        out = {}
        for t, tc in list(self.tenant_costs.items()):
            out[t] = {
                "flops": dict(tc["flops"]),
                "hbm_bytes": dict(tc["hbm_bytes"]),
                "collective_bytes": dict(tc["collective_bytes"]),
                "tokens": tc["tokens"],
                "goodput_tokens": tc["goodput_tokens"],
                "cached_tokens": tc["cached_tokens"],
                "requests": dict(tc["requests"])}
        return out

    def attribution_check(self):
        """The conservation identity, point-in-time: for every phase the
        sum of attributed per-tenant cost equals the ledger's phase
        total EXACTLY (residual 0.0)."""
        conserved = True
        residuals = {}
        for key, totals in (("flops", self.flops),
                            ("hbm_bytes", self.bytes),
                            ("collective_bytes", self.coll_bytes)):
            res = {}
            for p in LEDGER_PHASES:
                attributed = sum(
                    tc[key].get(p, 0.0)
                    for tc in list(self.tenant_costs.values()))
                r = totals.get(p, 0.0) - attributed
                res[p] = r
                conserved = conserved and r == 0.0
            residuals[key] = res
        return {"conserved": conserved, "residuals": residuals}

    # -- phase hooks ---------------------------------------------------------
    def _add(self, phase, flops, nbytes, flops_chip, bytes_chip,
             coll_bytes=0.0):
        self.flops[phase] += flops
        self.bytes[phase] += nbytes
        self.flops_chip[phase] += flops_chip
        self.bytes_chip[phase] += bytes_chip
        self._c_flops.labels(phase=phase).inc(flops)
        self._c_bytes.labels(phase=phase).inc(nbytes)
        if coll_bytes:
            self.coll_bytes[phase] += coll_bytes
            self._c_coll.labels(phase=phase).inc(coll_bytes)

    @staticmethod
    def _chunk_ctx_sum(tokens, ctx0):
        """Total attended context of a causal chunk: position i (of
        ``tokens``) attends ctx0+i+1 earlier-or-self tokens."""
        return tokens * ctx0 + tokens * (tokens + 1) / 2.0

    def on_prefill_chunk(self, tokens, ctx0, phys_positions=None,
                         owner=None):
        """One prefill chunk: ``tokens`` useful prompt positions from
        context length ``ctx0`` (each position i attends ctx0+i+1
        tokens). Bytes: one weight stream + re-read of the written
        extent + the chunk's own KV writes. ``phys_positions``: the
        dispatch's physical width (the padded chunk), the collective
        term's unit. The whole cost is the ``owner``'s."""
        tokens = int(tokens)
        if tokens <= 0:
            return
        ctx0 = int(ctx0)
        ctx_sum = self._chunk_ctx_sum(tokens, ctx0)
        flops = tokens * self._mm + self._attn * ctx_sum
        kv_traffic = (ctx0 + tokens) + tokens
        nbytes = self._param_bytes + kv_traffic * self.kv_bytes_per_token
        coll = (phys_positions if phys_positions is not None
                else tokens) * self.coll_bytes_per_position
        self._add("prefill", flops, nbytes,
                  tokens * self._mm_chip + self._attn_chip * ctx_sum,
                  self._param_bytes_chip
                  + kv_traffic * self.kv_bytes_per_token_chip, coll)
        if owner is not None:
            self._attr("prefill", [(owner, flops, nbytes, coll)])

    def on_draft_prefill(self, tokens, ctx0, phys_positions=None,
                         owner=None):
        """The draft's mirror of one prefill chunk (same positions,
        same causal shape, the DRAFT's cost constants)."""
        if self._draft is None or int(tokens) <= 0:
            return
        ctx_sum = self._chunk_ctx_sum(int(tokens), int(ctx0))
        self.on_draft(tokens, ctx_sum, phys_positions=phys_positions,
                      owners=None if owner is None
                      else [(owner, int(tokens), ctx_sum)])

    def on_decode(self, tokens, ctx_sum, weight_passes=1,
                  phase="decode", phys_positions=None, owners=None):
        """``tokens`` emitted decode tokens attending ``ctx_sum`` total
        context positions, from a dispatch that streamed the weights
        ``weight_passes`` times (K for a K-step fused block, 1 for a
        per-token step or a verify). ``phys_positions``: the positions
        the dispatch's collectives carry (default ``weight_passes *
        slots``: every slot of every step). ``owners`` ``[(uid,
        tokens_i, ctx_i)]`` over the live slots: each request gets its
        own FLOPs and KV traffic and an even slice of the weight stream
        and the collective payload."""
        tokens = int(tokens)
        if tokens <= 0 and weight_passes <= 0:
            return
        if phys_positions is None:
            phys_positions = weight_passes * self.slots
        kvb = self.kv_bytes_per_token
        kv_traffic = float(ctx_sum) + tokens
        wtot = weight_passes * self._param_bytes
        flops = tokens * self._mm + self._attn * float(ctx_sum)
        nbytes = wtot + kv_traffic * kvb
        coll = phys_positions * self.coll_bytes_per_position
        self._add(phase, flops, nbytes,
                  tokens * self._mm_chip + self._attn_chip * float(ctx_sum),
                  weight_passes * self._param_bytes_chip
                  + kv_traffic * self.kv_bytes_per_token_chip, coll)
        if owners:
            self._attr(phase, self._split_dispatch(
                owners, flops, nbytes, coll, self._mm, self._attn, kvb,
                wtot))

    def on_draft(self, tokens, ctx_sum, weight_passes=1,
                 phys_positions=None, owners=None):
        """Draft-model work (the propose scan, the mirror step, the
        draft prefill) under ``spec_draft`` with the draft's cost
        constants, attributed as :meth:`on_decode` does."""
        if self._draft is None:
            return
        tokens = int(tokens)
        if tokens <= 0 and weight_passes <= 0:
            return
        (mm, attn, pbytes, kvb, mm_chip, attn_chip, pb_chip, kv_chip,
         coll_pp) = self._draft
        if phys_positions is None:
            phys_positions = weight_passes * self.slots
        kv_traffic = float(ctx_sum) + tokens
        wtot = weight_passes * pbytes
        flops = tokens * mm + attn * float(ctx_sum)
        nbytes = wtot + kv_traffic * kvb
        coll = phys_positions * coll_pp
        self._add("spec_draft", flops, nbytes,
                  tokens * mm_chip + attn_chip * float(ctx_sum),
                  weight_passes * pb_chip + kv_traffic * kv_chip, coll)
        if owners:
            self._attr("spec_draft", self._split_dispatch(
                owners, flops, nbytes, coll, mm, attn, kvb, wtot))

    # -- goodput -------------------------------------------------------------
    def on_completion(self, completion):
        tier = str(int(getattr(completion, "priority", 0)))
        n = len(completion.tokens or [])
        self.raw_tokens[tier] = self.raw_tokens.get(tier, 0) + n
        self._c_tier.labels(tier=tier).inc(n)
        if completion.finish_reason in GOODPUT_REASONS:
            self.good_tokens[tier] = self.good_tokens.get(tier, 0) + n
            self._c_good.labels(tier=tier).inc(n)
        else:
            self._c_good.labels(tier=tier).inc(0)
        # retire the request's cost record with its outcome
        self.finish_request(completion.uid, completion.finish_reason,
                            ttft_s=completion.ttft_s)

    # -- windowing -----------------------------------------------------------
    def on_step(self, dt_s):
        """Account one non-idle engine step's wall time and refresh the
        utilization/goodput gauges."""
        self.wall_s += float(dt_s)
        if self._closed or self.wall_s <= 0:
            return
        eid = self.engine_id
        self._g_mfu.labels(engine=eid).set(
            sum(self.flops.values()) / self.wall_s / self.peak_flops)
        self._g_mbu.labels(engine=eid).set(
            sum(self.bytes.values()) / self.wall_s
            / self.peak_hbm_bytes_per_s)
        self._g_mfu_chip.labels(engine=eid).set(
            sum(self.flops_chip.values()) / self.wall_s / self.peak_flops)
        self._g_mbu_chip.labels(engine=eid).set(
            sum(self.bytes_chip.values()) / self.wall_s
            / self.peak_hbm_bytes_per_s)
        for tier, n in self.raw_tokens.items():
            self._g_raw_rate.labels(engine=eid, tier=tier).set(
                n / self.wall_s)
            self._g_good_rate.labels(engine=eid, tier=tier).set(
                self.good_tokens.get(tier, 0) / self.wall_s)

    def totals(self):
        """Point-in-time copy of the ledger state (diff two of these to
        window a measurement — see :meth:`window`)."""
        return {"flops": dict(self.flops), "bytes": dict(self.bytes),
                "flops_chip": dict(self.flops_chip),
                "bytes_chip": dict(self.bytes_chip),
                "coll_bytes": dict(self.coll_bytes),
                "wall_s": self.wall_s,
                "good_tokens": dict(self.good_tokens),
                "raw_tokens": dict(self.raw_tokens),
                "peak_flops": self.peak_flops,
                "peak_hbm_bytes_per_s": self.peak_hbm_bytes_per_s,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "kv_bytes_per_token_chip": self.kv_bytes_per_token_chip,
                "kv_dtype": self.kv_dtype, "mp": self.mp,
                "kv_shard": self.kv_shard,
                "weight_bytes_per_step": self._param_bytes,
                "weight_bytes_per_step_chip": self._param_bytes_chip,
                "weight_dtype": self.weight_dtype,
                "collective_dtype": self.collective_dtype,
                "platform": self.platform}

    @staticmethod
    def window(t0, t1):
        """MFU/MBU/goodput over the window between two ``totals()``
        snapshots (``t0=None`` windows from engine start), with the mesh
        terms: per-chip utilization and the collective payload."""
        if t0 is None:
            t0 = {"flops": {}, "bytes": {}, "flops_chip": {},
                  "bytes_chip": {}, "coll_bytes": {}, "wall_s": 0.0,
                  "good_tokens": {}, "raw_tokens": {}}
        wall = t1["wall_s"] - t0["wall_s"]
        flops = {p: v - t0["flops"].get(p, 0.0)
                 for p, v in t1["flops"].items()}
        nbytes = {p: v - t0["bytes"].get(p, 0.0)
                  for p, v in t1["bytes"].items()}
        good = {t: n - t0["good_tokens"].get(t, 0)
                for t, n in t1["good_tokens"].items()}
        raw = {t: n - t0["raw_tokens"].get(t, 0)
               for t, n in t1["raw_tokens"].items()}
        flops_chip = {p: v - t0.get("flops_chip", {}).get(p, 0.0)
                      for p, v in t1.get("flops_chip", flops).items()}
        bytes_chip = {p: v - t0.get("bytes_chip", {}).get(p, 0.0)
                      for p, v in t1.get("bytes_chip", nbytes).items()}
        coll = {p: v - t0.get("coll_bytes", {}).get(p, 0.0)
                for p, v in t1.get("coll_bytes", {}).items()}
        safe_wall = max(wall, 1e-12)
        mfu = sum(flops.values()) / safe_wall / t1["peak_flops"]
        mbu = sum(nbytes.values()) / safe_wall \
            / t1["peak_hbm_bytes_per_s"]
        return {
            "wall_s": wall,
            "model_flops_total": sum(flops.values()),
            "hbm_bytes_total": sum(nbytes.values()),
            "flops_by_phase": flops,
            "bytes_by_phase": nbytes,
            "mfu": mfu,
            "mbu": mbu,
            "mp": t1.get("mp", 1),
            "kv_shard": t1.get("kv_shard"),
            "mfu_per_chip": sum(flops_chip.values()) / safe_wall
            / t1["peak_flops"],
            "mbu_per_chip": sum(bytes_chip.values()) / safe_wall
            / t1["peak_hbm_bytes_per_s"],
            "hbm_bytes_per_chip": sum(bytes_chip.values()),
            "collective_bytes_total": sum(coll.values()),
            "collective_bytes_by_phase": coll,
            "goodput_tokens_per_s": {
                t: n / safe_wall for t, n in good.items()},
            "raw_tokens_per_s": {
                t: n / safe_wall for t, n in raw.items()},
            "goodput_frac": {
                t: (good.get(t, 0) / raw[t]) if raw[t] else None
                for t in raw},
            "kv_bytes_per_token": t1["kv_bytes_per_token"],
            "kv_dtype": t1["kv_dtype"],
            "weight_bytes_per_step": t1.get("weight_bytes_per_step"),
            "weight_dtype": t1.get("weight_dtype"),
            "collective_dtype": t1.get("collective_dtype", "f32"),
            "peak_flops": t1["peak_flops"],
            "peak_hbm_bytes_per_s": t1["peak_hbm_bytes_per_s"],
            "platform": t1["platform"]}

    def summary(self):
        """The whole-run window (engine start to now)."""
        return self.window(None, self.totals())

    def close(self):
        """Retire this engine's labeled gauge series (counters keep
        their aggregable totals)."""
        if self._closed:
            return
        self._closed = True
        eid = self.engine_id
        for g in (self._g_mfu, self._g_mbu, self._g_mfu_chip,
                  self._g_mbu_chip):
            g.remove(engine=eid)
        self._g_wbytes.remove_matching(engine=eid)
        self._g_good_rate.remove_matching(engine=eid)
        self._g_raw_rate.remove_matching(engine=eid)
