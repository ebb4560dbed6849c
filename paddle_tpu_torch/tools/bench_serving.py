#!/usr/bin/env python3
"""Serving throughput of the port's paged continuous-batching engine under
a mixed-length synthetic request stream — port of
``tools/bench_serving.py``, its single-engine paths.

    python3 -m paddle_tpu_torch.tools.bench_serving [--model tiny|small]
        [--requests N] [--slots S] [--kv-dtype none,bf16,int8,fp8] ...

Run from the repository root. Runs on the card (CUDA) unless
``--device cpu`` is given; the engines capture their programs as CUDA
graphs there. Every line is one JSON object with the reference's keys:
the rate (tokens a second on this one card), per-token and TTFT
percentiles from the engine's own histograms (the series a /metrics
scrape reports), the ledger's MFU and MBU over the measured window
against one H100's peaks (989 TFLOP/s bf16 dense, 3.35 TB/s), goodput
by tier, the graph-capture census (``decode_compiles`` and its kin read
``serving_jit_compiles``: CUDA graphs captured) and the latency
anatomy's summary; ``device`` and ``power_limit`` name the card.

Modes, as the reference's: the default stream, swept over
``--decode-block``, ``--kv-dtype`` and ``--weight-dtype`` (one line per
combination) with ``--shared-prefix`` replaying it without the prefix
cache too; ``--steady-decode`` times pure decode; ``--mixed-steady
4:1,1:1`` scores the mixed-step engine's dispatches a token against the
per-phase engine on the same greedy trace; ``--overload`` replays an
oversubscribed two-tier stream (paced arrivals, a bounded queue, a tight
pool) through a resilient engine, the high tier alone and a FIFO
baseline; ``--speculative`` sweeps ``--draft-k`` against per-token and
adaptive-block baselines; ``--tenants A:0.6,B:0.4`` labels requests with
tenants and adds the per-tenant cost columns.

Observability, as the reference's: the default stream runs with the
serving watchdog armed and an ``SLOEngine`` (a TTFT objective a tenant)
evaluated every 8 steps (``watchdog_trips_total``, ``slo_alerts_total``);
the ``--overload`` replay paces its arrivals as a journal schedule
(``observability.journal.replay``), and its resilient leg runs with the
watchdog armed and the two-tier SLO engine (gold and bulk: TTFT p99 at
twice the uncontended high tier's, success 0.9) evaluated every 4 steps
(``slo``, ``slo_alerts``, ``watchdog_trips_total``); ``--journal PATH``
records that leg. ``--workload FILE`` replays a workload journal (seed-
recipe prompts, diurnal and burst arrivals) through one fresh engine
and prints the ``workload_replay`` line; ``--gen-workload`` writes the
file first, byte-reproducible from ``--seed``.

Not ported (the flag exits non-zero): the fleet router and its journal
legs (``--fleet``, ``--kill-replica``, ``--route``, ``--autoscale``),
meshes (``--mesh``, ``--kv-shard``, ``--collective-dtype``) and the
target's synthetic pre-training (``--spec-train-steps``): the
speculative legs run on the random-weight target, so their acceptance
rate measures the mechanism, not a trained draft. The mesh columns read
their one-card values.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

NOT_PORTED = ("--fleet", "--kill-replica", "--route", "--autoscale",
              "--mesh", "--kv-shard", "--collective-dtype",
              "--spec-train-steps")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("tiny", "small"), default="small")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=64,
                    help="max new tokens a request (each draws in "
                         "[max_new/2, max_new])")
    ap.add_argument("--attention", choices=("auto", "torch"),
                    default="auto",
                    help="auto: the ragged kernel; torch: its plain "
                         "version")
    ap.add_argument("--decode-block", default="adaptive",
                    help="comma-separated K values (or 'adaptive'); one "
                         "line per value")
    ap.add_argument("--steady-decode", action="store_true",
                    help="admit and prefill outside the clock: the "
                         "measured window is pure decode")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="a common N-token system prompt on every "
                         "request")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="replay the stream with the prefix cache on "
                         "and off (default --prefix-len 256)")
    ap.add_argument("--prefill-chunks-per-step", type=int, default=1)
    ap.add_argument("--mixed-steady", default=None, metavar="RATIOS",
                    help="comma-separated prefill:decode ratios; each "
                         "replays one greedy trace through the mixed-"
                         "step engine and the per-phase one")
    ap.add_argument("--admit-lookahead", type=int, default=4)
    ap.add_argument("--warmup-requests", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overload", action="store_true",
                    help="the oversubscribed two-tier replay")
    ap.add_argument("--high-frac", type=float, default=0.25)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--shed-policy", default="shed_lowest_priority",
                    choices=("reject", "shed_oldest",
                             "shed_lowest_priority"))
    ap.add_argument("--arrival-steps", type=int, default=1)
    ap.add_argument("--kv-dtype", default="none",
                    help="comma-separated pool dtypes (none, bf16, int8, "
                         "fp8)")
    ap.add_argument("--weight-dtype", default="none",
                    help="comma-separated weight dtypes (none, bf16, "
                         "int8)")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--draft-k", default="4")
    ap.add_argument("--draft-layers", type=int, default=None)
    ap.add_argument("--tenants", default=None,
                    help="name:weight,... tenant mix (own rng: the token "
                         "stream is unchanged)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="record the --overload resilient leg (or the "
                         "--workload replay) to this journal file")
    ap.add_argument("--workload", default=None, metavar="FILE",
                    help="replay a workload journal through one fresh "
                         "engine and print the workload_replay line")
    ap.add_argument("--gen-workload", action="store_true",
                    help="(re)generate the --workload FILE from --seed "
                         "and --requests first (byte-reproducible)")
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="shared-prefix groups of a generated workload")
    return ap


def _card():
    """``nvidia-smi``'s name and power limit, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _pcts(vals):
    if not vals:
        return {"p50_ms": None, "p99_ms": None, "n": 0}
    a = np.asarray(vals) * 1e3
    return {"p50_ms": round(float(np.percentile(a, 50)), 3),
            "p99_ms": round(float(np.percentile(a, 99)), 3),
            "n": len(vals)}


def _family_sum(snapshot, name):
    """The sum of a counter family's series in a snapshot."""
    return sum(s["value"] for s in
               (snapshot.get(name) or {"series": []})["series"])


def _q_ms(hist, q):
    return round(hist.quantile(q) * 1e3, 3) if hist.count else None


def anatomy_fields(summary):
    """The anatomy columns (reference ``anatomy_fields``): the
    conservation pin and ``decode_blocked_frac`` flat, the per-segment
    p50/p99 stack under ``anatomy``."""
    o = summary["overall"]
    return {
        "anatomy_conserved_frac": summary["conservation"]["frac"],
        "decode_blocked_frac": round(o["decode_blocked_frac"], 6),
        "anatomy": {
            "segments": {s: {"p50": v["p50"], "p99": v["p99"]}
                         for s, v in o["segments"].items()},
            "total_steps_p50": o["total_steps_p50"],
            "total_steps_p99": o["total_steps_p99"],
            "decode_blocked_frac_p99":
                round(o["decode_blocked_frac_p99"], 6),
            "by_tier": {str(t): round(g["decode_blocked_frac"], 6)
                        for t, g in sorted(summary["by_tier"].items())},
            "by_tenant": {t: round(g["decode_blocked_frac"], 6)
                          for t, g in sorted(summary["by_tenant"].items())},
            "conservation": summary["conservation"]}}


def ledger_fields(l0, l1):
    """The ledger's window between two ``totals()`` snapshots as flat
    fields (reference ``ledger_fields``)."""
    from ..observability import ServingLedger
    w = ServingLedger.window(l0, l1)
    return {
        "mfu": round(w["mfu"], 6),
        "mbu": round(w["mbu"], 6),
        "model_flops_total": int(w["model_flops_total"]),
        "hbm_bytes_total": int(w["hbm_bytes_total"]),
        "goodput_tokens_per_s": {
            t: round(v, 1)
            for t, v in sorted(w["goodput_tokens_per_s"].items())},
        "raw_tokens_per_s": {
            t: round(v, 1) for t, v in sorted(w["raw_tokens_per_s"].items())},
        "goodput_frac": {
            t: (round(v, 4) if v is not None else None)
            for t, v in sorted(w["goodput_frac"].items())},
        "kv_bytes_per_token": round(w["kv_bytes_per_token"], 2),
        "weight_bytes_per_step": int(w.get("weight_bytes_per_step") or 0),
        "weight_dtype_ledger": w.get("weight_dtype"),
        "collective_dtype": w.get("collective_dtype", "f32"),
        "hbm_bytes_decode": int(w["bytes_by_phase"].get("decode", 0)),
        "hbm_bytes_prefill": int(w["bytes_by_phase"].get("prefill", 0)),
        "mp": w["mp"],
        "mfu_per_chip": round(w["mfu_per_chip"], 6),
        "mbu_per_chip": round(w["mbu_per_chip"], 6),
        "collective_bytes_total": int(w["collective_bytes_total"]),
        "ledger_peak_flops": w["peak_flops"],
        "ledger_peak_hbm_bytes_per_s": w["peak_hbm_bytes_per_s"]}


def tenant_fields(ledger, wall_s):
    """The per-tenant cost/goodput columns (reference
    ``tenant_fields``)."""
    out = {}
    for t, tc in sorted(ledger.tenant_totals().items()):
        good = tc["goodput_tokens"]
        hbm = sum(tc["hbm_bytes"].values())
        out[t] = {
            "flops": int(sum(tc["flops"].values())),
            "hbm_bytes": int(hbm),
            "collective_bytes": int(sum(tc["collective_bytes"].values())),
            "tokens": tc["tokens"],
            "goodput_tokens": good,
            "cached_tokens_saved": tc["cached_tokens"],
            "goodput_tokens_per_s": round(good / max(wall_s, 1e-9), 1),
            "cost_per_goodput_token": round(hbm / good, 1)
            if good else None,
            "requests": dict(tc["requests"])}
    return out


class Bench:
    """One invocation's model, weights, request streams and engines."""

    def __init__(self, args):
        import torch

        from ..device import resolve_device
        from ..models.gpt import gpt2_small, gpt2_tiny, init_params

        self.args = args
        self.device = resolve_device(args.device)
        self.torch = torch
        unit = math.lcm(args.page_size, args.prefill_chunk)
        self.need = args.prefix_len + args.max_prompt + args.max_new
        max_seq_len = -(-self.need // unit) * unit
        if args.model == "small":
            self.cfg = gpt2_small(vocab_size=50304)
        else:
            # the tiny config's position table is sized on demand
            self.cfg = gpt2_tiny(
                max_position_embeddings=max(128, max_seq_len))
        self.vocab = self.cfg.vocab_size
        maxpos = self.cfg.max_position_embeddings
        self.max_seq_len = min(max_seq_len, maxpos // unit * unit)
        if self.max_seq_len < self.need:
            raise SystemExit(
                f"prefix+max-prompt+max-new({self.need}) exceeds the "
                f"position table ({maxpos})")
        self.params = init_params(self.cfg, seed=0, device=self.device)
        self.rng = np.random.RandomState(args.seed)
        self.prefix = self.rng.randint(0, self.vocab, args.prefix_len) \
            if args.prefix_len else None
        self.tenant_names, self.tenant_weights = [], []
        if args.tenants:
            for tok in str(args.tenants).split(","):
                name, _, w = tok.strip().partition(":")
                if not name:
                    raise SystemExit(f"--tenants: bad entry {tok!r}")
                self.tenant_names.append(name)
                self.tenant_weights.append(float(w) if w else 1.0)
            s = sum(self.tenant_weights)
            if s <= 0:
                raise SystemExit("--tenants: weights must sum > 0")
            self.tenant_weights = [w / s for w in self.tenant_weights]
        self.trng = np.random.RandomState(args.seed + 0x7e9a97)
        card = _card() if self.device.type == "cuda" else None
        self.stamp = {"platform": self.device.type, "chips": 1,
                      "device": torch.cuda.get_device_name(self.device)
                      if self.device.type == "cuda" else "cpu",
                      "power_limit": card.split(",")[-1].strip()
                      if card else None}

    def draw_tenant(self):
        if not self.tenant_names:
            return None
        return self.tenant_names[int(self.trng.choice(
            len(self.tenant_names), p=self.tenant_weights))]

    def make_stream(self, n, with_prefix=True):
        a, out = self.args, []
        for _ in range(n):
            plen = int(self.rng.randint(a.min_prompt, a.max_prompt + 1))
            nnew = int(self.rng.randint(max(a.max_new // 2, 1),
                                        a.max_new + 1))
            tail = self.rng.randint(0, self.vocab, plen)
            prompt = np.concatenate([self.prefix, tail]) \
                if (with_prefix and self.prefix is not None) else tail
            out.append((prompt, nnew))
        return out

    def engine(self, **kw):
        from ..inference.serving import ServingEngine
        from ..observability import MetricsRegistry
        a = self.args
        kw.setdefault("num_slots", a.slots)
        kw.setdefault("admit_lookahead", a.admit_lookahead)
        if not kw.get("mixed_step"):
            kw.setdefault("prefill_chunks_per_step",
                          a.prefill_chunks_per_step)
        return ServingEngine(
            self.cfg, self.params, device=self.device,
            page_size=a.page_size, prefill_chunk=a.prefill_chunk,
            max_seq_len=self.max_seq_len, attention=a.attention,
            registry=MetricsRegistry(), **kw)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    # -- the default stream ------------------------------------------------
    def drive(self, stream, prefix_cache, decode_block="adaptive",
              kv_dtype=None, weight_dtype=None):
        """One fresh engine over ``stream`` (reference ``drive``): a
        warm-up of prefix-free prompts (and a duplicate pair for the
        copy-on-write path), the registry reset, then the measured
        stream; with ``--steady-decode`` admission and prefill run
        outside the clock."""
        from ..observability import SLOEngine, SLOSpec
        a = self.args
        # the watchdog and the SLO evaluation ride the measured replay,
        # as the reference's drive
        engine = self.engine(prefix_cache=prefix_cache,
                             decode_block=decode_block, kv_dtype=kv_dtype,
                             weight_dtype=weight_dtype, logit_health=True,
                             watchdog=True)
        registry = engine.metrics
        slo = SLOEngine(
            [SLOSpec(name=f"bench-{t}", tenant=t, ttft_p99_s=60.0,
                     windows=(1.0, 10.0))
             for t in (self.tenant_names or ["default"])],
            source=registry)
        slo_tick = [0]

        def step():
            engine.step()
            slo_tick[0] += 1
            if slo_tick[0] % 8 == 0:
                slo.evaluate()
        warm = self.make_stream(a.warmup_requests, with_prefix=False)
        for prompt, nnew in warm:
            engine.add_request(prompt, nnew)
        if prefix_cache and warm:
            dup = self.rng.randint(0, self.vocab, a.page_size)
            engine.add_request(dup, 2)
            engine.add_request(dup, 2)
        engine.run(max_steps=1_000_000)
        registry.reset()
        chunks0 = engine.stats["prefill_chunks"]
        for prompt, nnew in stream:
            engine.add_request(prompt, nnew, tenant=self.draw_tenant())
        if a.steady_decode:
            while engine._pending or engine._prefilling:
                step()
            registry.reset()
        toks0 = engine.stats["tokens_emitted"]
        dispatches0 = engine.stats["decode_blocks"]
        l0 = engine.ledger.totals()
        self.sync()
        t_start = time.perf_counter()
        while engine.has_work:
            step()
        self.sync()
        wall = time.perf_counter() - t_start
        lat = registry.get("serving_token_latency_seconds")
        ttft = registry.get("serving_ttft_seconds")
        total = engine.stats["tokens_emitted"] - toks0
        dispatches = engine.stats["decode_blocks"] - dispatches0
        snapshot = registry.snapshot()
        l1 = engine.ledger.totals()
        counts = engine.compile_counts()
        kv = engine.kv
        out = {
            "attribution_conserved":
                1.0 if engine.ledger.attribution_check()["conserved"]
                else 0.0,
            "tenants": tenant_fields(engine.ledger, wall),
            "watchdog_trips_total": int(_family_sum(
                snapshot, "serving_watchdog_trips_total")),
            "slo_alerts_total": int(_family_sum(
                snapshot, "serving_slo_alerts_total")),
            "prefill_compiles": counts["prefill_chunk"],
            "weight_bytes_per_step": int(l1["weight_bytes_per_step"]),
            "decode_hbm_bytes_per_token": round(
                (l1["bytes"].get("decode", 0)
                 - l0["bytes"].get("decode", 0)) / max(total, 1), 2),
            "logit_absmax": next(
                (s["value"] for s in snapshot.get(
                    "serving_logit_absmax", {"series": []})["series"]),
                None),
            "tokens_per_sec": round(total / wall, 1),
            "p50_ms_per_token": _q_ms(lat, 0.5),
            "p99_ms_per_token": _q_ms(lat, 0.99),
            "ttft_p50_ms": _q_ms(ttft, 0.5),
            "ttft_p99_ms": _q_ms(ttft, 0.99),
            "decode_dispatches": dispatches,
            "dispatches_per_token": round(dispatches / max(total, 1), 4),
            "tokens_per_dispatch": round(total / max(dispatches, 1), 2),
            "attention_impl": engine.attention,
            "prefill_chunks": engine.stats["prefill_chunks"] - chunks0,
            "prefix_cache_hits": engine.stats["prefix_hits"],
            "prefix_cached_tokens": engine.stats["cached_tokens"],
            "cow_copies": engine.stats["cow_copies"],
            "decode_compiles": counts["decode_step"],
            "decode_block_compiles": counts.get("decode_block", 0),
            "kv_pool_bytes": kv.pool_bytes(),
            "bytes_per_resident_token": round(
                kv.pool_bytes() / ((kv.num_pages - 1) * kv.page_size), 2),
            "chips": 1,
            "kv_pool_bytes_per_chip": kv.pool_bytes(),
            "collective_bytes_per_token": 0.0,
            "decode_collective_bytes_counted": None,
            "decode_collective_bytes_predicted": 0,
            "ledger": ledger_fields(l0, l1),
            "snapshot": {
                name: snapshot[name] for name in (
                    "serving_ttft_seconds",
                    "serving_token_latency_seconds",
                    "serving_pages_free", "serving_pages_used",
                    "serving_pages_cached", "serving_pages_shared",
                    "serving_admissions_total",
                    "serving_completions_total",
                    "serving_prefix_cache_hits_total",
                    "serving_decode_step_seconds",
                    "serving_decode_block_size",
                    "serving_decode_blocks_total",
                    "serving_tokens_per_dispatch")
                if name in snapshot},
            "anatomy_summary": engine.anatomy_report()["summary"]}
        engine.kv.verify()
        engine.close()
        return out

    def run_default(self):
        a = self.args
        sweep = ["adaptive" if t.strip() == "adaptive" else int(t)
                 for t in str(a.decode_block).split(",")]
        kv_sweep = [None if t.strip() in ("none", "") else t.strip()
                    for t in str(a.kv_dtype).split(",")]
        wd_sweep = [None if t.strip() in ("none", "") else t.strip()
                    for t in str(a.weight_dtype).split(",")]
        stream = self.make_stream(a.requests)
        base_absmax = {}
        for kd in kv_sweep:
            for wd in wd_sweep:
                for k in sweep:
                    self._one_line(stream, kd, wd, k, base_absmax)

    def _one_line(self, stream, kd, wd, k, base_absmax):
        a = self.args
        run = self.drive(stream, True, decode_block=k, kv_dtype=kd,
                         weight_dtype=wd)
        off = self.drive(stream, False, decode_block=k, kv_dtype=kd,
                         weight_dtype=wd) if a.shared_prefix else None
        # the logit-error reference is the full-precision leg only
        quantized = kd is not None or wd is not None
        if not quantized and k not in base_absmax:
            base_absmax[k] = run["logit_absmax"]
        ref = base_absmax.get(k)
        quant_err = (round(abs(run["logit_absmax"] - ref) / ref, 6)
                     if quantized and ref and run["logit_absmax"]
                     is not None else None)
        rec = {
            "metric": f"gpt2_{a.model}_serving_tokens_per_sec_per_chip",
            "value": run["tokens_per_sec"], "unit": "tokens/sec/chip",
            "mp": 1, "kv_shard": None, "tokens_per_chip_vs_mp1": None,
            **{key: run[key] for key in (
                "kv_pool_bytes_per_chip", "collective_bytes_per_token",
                "decode_collective_bytes_counted",
                "decode_collective_bytes_predicted", "p50_ms_per_token",
                "p99_ms_per_token", "ttft_p50_ms", "ttft_p99_ms",
                "prefill_chunks")},
            "requests": a.requests, "slots": a.slots,
            "page_size": a.page_size, "prefill_chunk": a.prefill_chunk,
            "prompt_range": [a.min_prompt, a.max_prompt],
            "max_new": a.max_new, "attention": a.attention,
            "attention_impl": run["attention_impl"],
            "prefix_len": a.prefix_len, "decode_block": k,
            "kv_dtype": kd or "param", "weight_dtype": wd or "param",
            "collective_dtype": "f32",
            **{key: run[key] for key in (
                "weight_bytes_per_step", "decode_hbm_bytes_per_token")},
            "quant_logit_err_absmax": quant_err,
            **{key: run[key] for key in (
                "kv_pool_bytes", "bytes_per_resident_token")},
            "steady_decode": bool(a.steady_decode),
            **{key: run[key] for key in (
                "decode_dispatches", "dispatches_per_token",
                "tokens_per_dispatch", "decode_compiles",
                "decode_block_compiles", "attribution_conserved",
                "prefill_compiles", "watchdog_trips_total",
                "slo_alerts_total", "tenants")},
            **self.stamp, "snapshot": run["snapshot"]}
        rec.update(run["ledger"])
        rec.update(anatomy_fields(run["anatomy_summary"]))
        if off is not None:
            keys = ("tokens_per_sec", "ttft_p50_ms", "ttft_p99_ms",
                    "prefill_chunks", "prefix_cache_hits",
                    "prefix_cached_tokens", "cow_copies")
            rec["prefix_cache"] = {"on": {x: run[x] for x in keys},
                                   "off": {x: off[x] for x in keys}}
        print(json.dumps(rec), flush=True)

    # -- --mixed-steady --------------------------------------------------------
    def run_mixed_steady(self):
        """The one-ragged-dispatch scorecard (reference
        ``run_mixed_steady``): per ratio, one greedy trace through the
        mixed-step engine and the per-phase engine; the measured window
        is while the queue is live."""
        a = self.args
        warm = self.make_stream(max(a.warmup_requests, 1),
                                with_prefix=False)

        def leg(reqs, mixed):
            engine = self.engine(mixed_step=mixed)
            for p, n in warm:
                engine.add_request(p, n)
            engine.run(max_steps=1_000_000)
            engine.metrics.reset()
            uids = [engine.add_request(p, n) for p, n in reqs]
            d0 = engine.stats["dispatches"]
            t0 = engine.stats["tokens_emitted"]
            done = {}
            self.sync()
            t_start = time.perf_counter()
            while engine._pending:
                for c in engine.step():
                    done[c.uid] = tuple(c.tokens)
            self.sync()
            wall = time.perf_counter() - t_start
            toks = engine.stats["tokens_emitted"] - t0
            disp = engine.stats["dispatches"] - d0
            while engine.has_work:
                for c in engine.step():
                    done[c.uid] = tuple(c.tokens)
            ttft = engine.metrics.get("serving_ttft_seconds")
            out = {"streams": [done.get(u) for u in uids],
                   "tokens": toks, "dispatches": disp,
                   "dispatches_per_token": round(disp / max(toks, 1), 4),
                   "tokens_per_sec": round(toks / max(wall, 1e-9), 1),
                   "ttft_p99_ms": _q_ms(ttft, 0.99),
                   "total_dispatches": engine.stats["dispatches"] - d0,
                   "total_tokens": engine.stats["tokens_emitted"] - t0,
                   "compile_counts": engine.compile_counts(),
                   "anatomy_summary": engine.anatomy_report()["summary"]}
            engine.kv.verify()
            engine.close()
            return out

        for ratio in str(a.mixed_steady).split(","):
            pf, _, dc = ratio.strip().partition(":")
            pf, dc = max(int(pf), 1), max(int(dc or 1), 1)
            budget = a.max_prompt + a.max_new
            plen = min(max(budget * pf // (pf + dc), 1), a.max_prompt)
            nnew = min(max(budget * dc // (pf + dc), 1), a.max_new)
            reqs = [(self.rng.randint(0, self.vocab, plen), nnew)
                    for _ in range(a.requests)]
            mix, base = leg(reqs, True), leg(reqs, False)
            rec = {
                "metric": f"gpt2_{a.model}_serving_mixed_steady_"
                          "dispatches_per_token",
                "value": mix["dispatches_per_token"],
                "unit": "dispatches/token",
                "mix_ratio": f"{pf}:{dc}", "prompt_len": plen,
                "max_new": nnew, "requests": a.requests,
                "slots": a.slots, "page_size": a.page_size,
                "prefill_chunk": a.prefill_chunk,
                "baseline_dispatches_per_token":
                    base["dispatches_per_token"],
                "dispatch_drop_frac": round(
                    1.0 - mix["dispatches_per_token"]
                    / max(base["dispatches_per_token"], 1e-9), 4),
                "dispatches_strictly_below_baseline":
                    1.0 if mix["dispatches"] < base["dispatches"]
                    else 0.0,
                "tokens": mix["tokens"], "dispatches": mix["dispatches"],
                "baseline_dispatches": base["dispatches"],
                "total_dispatches": mix["total_dispatches"],
                "baseline_total_dispatches": base["total_dispatches"],
                "total_tokens": mix["total_tokens"],
                "tokens_per_sec": mix["tokens_per_sec"],
                "baseline_tokens_per_sec": base["tokens_per_sec"],
                "ttft_p99_ms": mix["ttft_p99_ms"],
                "baseline_ttft_p99_ms": base["ttft_p99_ms"],
                "token_divergence": sum(
                    1 for x, y in zip(mix["streams"], base["streams"])
                    if x != y),
                "mixed_compiles": mix["compile_counts"].get("mixed_step",
                                                            0),
                "baseline_decode_compiles":
                    base["compile_counts"].get("decode_step", 0),
                "baseline_decode_blocked_frac": round(
                    base["anatomy_summary"]["overall"]
                    ["decode_blocked_frac"], 6),
                **self.stamp}
            rec.update(anatomy_fields(mix["anatomy_summary"]))
            print(json.dumps(rec), flush=True)

    # -- --overload ------------------------------------------------------------
    def run_overload(self):
        """The oversubscribed two-tier replay (reference
        ``run_overload``): paced arrivals (one every
        ``--arrival-steps`` engine steps, a journal schedule driven by
        ``observability.journal.replay``) through (a) the high tier
        alone, (b) a resilient engine (priorities, a bounded queue with
        the shed policy, preemption, a pool too small for every slot;
        the watchdog armed, the two-tier SLO engine evaluated every 4
        steps, and ``--journal`` recording it) and (c) a FIFO baseline on
        the same pool."""
        from .. import observability as obs
        from ..observability import journal as jnl
        a = self.args
        pages_per_slot = self.max_seq_len // a.page_size
        tight_pages = a.slots * pages_per_slot * 3 // 4 + 1
        max_queue = a.max_queue or a.slots
        n_high = max(1, int(round(a.requests * a.high_frac)))
        tiers = [2] * n_high + [0] * (a.requests - n_high)
        self.rng.shuffle(tiers)
        stream = [(p, n, t) for (p, n), t in
                  zip(self.make_stream(a.requests), tiers)]

        def replay(resilient, bounded=True, admit_tier=None,
                   with_slo=None, record=None):
            engine = self.engine(
                num_pages=tight_pages,
                max_queue=max_queue if (resilient and bounded) else None,
                shed_policy=a.shed_policy, preemption=resilient,
                journal=record, watchdog=with_slo is not None)
            slo = None
            if with_slo is not None:
                # the objective: twice the uncontended high tier's p99
                slo = obs.SLOEngine(
                    [obs.SLOSpec(name=f"overload-{t}", tenant=t,
                                 ttft_p99_s=with_slo, success_frac=0.9,
                                 windows=(0.5, 5.0), min_count=2)
                     for t in ("gold", "bulk")], source=engine.metrics)
            for p, n in self.make_stream(a.warmup_requests):
                engine.add_request(p, n)
            engine.run(max_steps=1_000_000)
            # item i lands after i * arrival_steps steps; a filtered
            # tier's submit keeps its slot, so the admitted tier's
            # arrival times never shift
            sched = jnl.schedule_from_stream(
                [{"prompt": p, "max_new_tokens": n,
                  "priority": t if resilient else 0,
                  "tenant": "gold" if t >= 2 else "bulk"}
                 for p, n, t in stream], arrival_steps=a.arrival_steps)
            tier_of = {ev["uid"]: t for ev, (_, _, t) in zip(sched, stream)}
            if admit_tier is not None:
                sched = [ev for ev in sched
                         if tier_of[ev["uid"]] == admit_tier]

            def on_tick(k):
                if slo is not None and k % 4 == 0:
                    slo.evaluate()

            t_wall0 = time.perf_counter()
            res = jnl.replay(sched, engine, on_tick=on_tick)
            done = {c.uid: c for c in res.completions.values()}
            uid_tier = {euid: tier_of[juid]
                        for juid, euid in res.uid_map.items()}
            engine.kv.verify()
            stats = dict(engine.stats)
            frac = engine.metrics.get(
                "serving_preempted_resume_cached_frac")
            stats["resume_cached_frac_p50"] = \
                round(frac.quantile(0.5), 3) if frac.count else None
            stats["compile_counts"] = engine.compile_counts()
            stats["ledger"] = ledger_fields(None, engine.ledger.totals())
            stats["tenants"] = tenant_fields(
                engine.ledger, time.perf_counter() - t_wall0)
            stats["attribution_conserved"] = \
                1.0 if engine.ledger.attribution_check()["conserved"] \
                else 0.0
            if slo is not None:
                stats["slo"] = [{"slo": r["slo"], "alerting": r["alerting"],
                                 "burn": r["burn"]} for r in slo.evaluate()]
                snap = engine.metrics.snapshot()
                stats["slo_alerts"] = {
                    sr["labels"]["slo"]: sr["value"]
                    for sr in (snap.get("serving_slo_alerts_total")
                               or {"series": []})["series"]}
                stats["watchdog_trips_total"] = int(_family_sum(
                    snap, "serving_watchdog_trips_total"))
            stats["anatomy_summary"] = engine.anatomy_report()["summary"]
            engine.close()
            return done, len(res.rejected), stats, uid_tier

        def tier_ttfts(done, uid_tier):
            out = {"high": [], "low": []}
            for c in done.values():
                if c.ttft_s is not None:
                    out["high" if uid_tier.get(c.uid, 0) >= 2
                        else "low"].append(c.ttft_s)
            return out

        done_u, _, _, tiers_u = replay(True, bounded=False, admit_tier=2)
        ttft_u = tier_ttfts(done_u, tiers_u)["high"]
        ttft_target_s = max(2.0 * (np.percentile(np.asarray(ttft_u), 99)
                                   if ttft_u else 0.01), 0.005)
        done_r, rejected, stats_r, tiers_r = replay(
            True, with_slo=float(ttft_target_s), record=a.journal)
        ttft_r = tier_ttfts(done_r, tiers_r)
        reasons = {}
        for c in done_r.values():
            reasons[c.finish_reason] = reasons.get(c.finish_reason, 0) + 1
        shed = reasons.get("shed", 0) + rejected
        done_f, _, _, tiers_f = replay(False)
        ttft_f = tier_ttfts(done_f, tiers_f)
        high_r, high_u = _pcts(ttft_r["high"]), _pcts(ttft_u)
        ratio = (round(high_r["p99_ms"] / high_u["p99_ms"], 2)
                 if high_r["p99_ms"] and high_u["p99_ms"] else None)
        rec = {
            "metric": f"gpt2_{a.model}_serving_overload_high_"
                      "ttft_p99_ms",
            "value": high_r["p99_ms"], "unit": "ms",
            "requests": a.requests, "slots": a.slots,
            "high_frac": round(n_high / a.requests, 3),
            "max_queue": max_queue, "shed_policy": a.shed_policy,
            "arrival_steps": a.arrival_steps, "page_size": a.page_size,
            "num_pages": tight_pages,
            "prompt_range": [a.min_prompt, a.max_prompt],
            "max_new": a.max_new,
            "resilient": {
                "ttft": {"high": high_r, "low": _pcts(ttft_r["low"])},
                "shed_rate": round(shed / a.requests, 3),
                "sheds": reasons.get("shed", 0), "rejected": rejected,
                "preemptions": stats_r["preemptions"],
                "resumes": stats_r["resumes"],
                "resume_cached_frac_p50":
                    stats_r["resume_cached_frac_p50"],
                "completions": reasons},
            "decode_compiles": stats_r["compile_counts"]["decode_step"],
            "prefill_compiles":
                stats_r["compile_counts"]["prefill_chunk"],
            "uncontended_high": high_u,
            "high_p99_vs_uncontended": ratio,
            "fifo_baseline": {"ttft": {"high": _pcts(ttft_f["high"]),
                                       "low": _pcts(ttft_f["low"])}},
            "attribution_conserved": stats_r["attribution_conserved"],
            "tenants": stats_r["tenants"],
            "slo_ttft_target_s": round(float(ttft_target_s), 4),
            "slo": stats_r["slo"], "slo_alerts": stats_r["slo_alerts"],
            "watchdog_trips_total": stats_r["watchdog_trips_total"],
            "journal": a.journal, **self.stamp}
        rec.update(stats_r["ledger"])
        rec.update(anatomy_fields(stats_r["anatomy_summary"]))
        print(json.dumps(rec), flush=True)

    # -- --workload ------------------------------------------------------------
    def load_workload(self):
        """The ``--workload`` journal, (re)generated first under
        ``--gen-workload`` (byte-reproducible from ``--seed``). Returns
        (reader, the workload's parameters)."""
        from ..observability import journal as jnl
        a = self.args
        if a.gen_workload:
            if not a.workload:
                raise SystemExit("--gen-workload needs --workload FILE")
            plen = a.prefix_len or 2 * a.page_size
            jnl.write_workload(
                a.workload, seed=a.seed, requests=a.requests,
                vocab=self.vocab, min_prompt=a.min_prompt,
                max_prompt=max(a.min_prompt, min(
                    a.max_prompt, self.max_seq_len - a.max_new - plen)),
                min_new=1, max_new=a.max_new,
                prefix_groups=max(1, a.prefix_groups), prefix_len=plen,
                tenants=dict(zip(self.tenant_names, self.tenant_weights))
                if self.tenant_names else None)
        rd = jnl.JournalReader(a.workload)
        wl = (rd.meta or {}).get("workload", {})
        if int(wl.get("vocab", self.vocab)) > self.vocab:
            raise SystemExit(
                f"workload vocab {wl.get('vocab')} exceeds the model's "
                f"({self.vocab}): regenerate with --gen-workload")
        return rd, wl

    def run_workload(self):
        """One fresh engine through a workload journal (reference
        ``run_workload``): seed-recipe prompts expand on demand, the
        diurnal and burst arrival steps are the schedule; prints the
        ``workload_replay`` line."""
        from ..observability import journal as jnl
        a = self.args
        rd, wl = self.load_workload()
        engine = self.engine(journal=a.journal)
        for p, n in self.make_stream(max(a.warmup_requests, 1),
                                     with_prefix=False):
            engine.add_request(p, n)
        engine.run(max_steps=1_000_000)
        self.sync()
        res = jnl.replay(rd, engine)
        self.sync()
        toks = sum(len(c.tokens) for c in res.completions.values())
        reasons = {}
        for c in res.completions.values():
            reasons[c.finish_reason] = reasons.get(c.finish_reason, 0) + 1
        stats = dict(engine.stats)
        conserved = engine.ledger.attribution_check()["conserved"]
        engine.close()
        print(json.dumps({
            "metric": f"gpt2_{a.model}_workload_replay_tokens_per_sec",
            "value": round(toks / max(res.wall_s, 1e-9), 1),
            "unit": "tokens/sec", "workload": a.workload,
            "workload_meta": {k: wl.get(k) for k in (
                "seed", "requests", "prefix_groups", "prefix_len",
                "sample_frac", "base_arrivals_per_tick",
                "horizon_ticks") if k in wl},
            "requests": len(res.completions),
            "rejected": len(res.rejected), "ticks": res.ticks,
            "completions": reasons,
            "prefix_cache_hits": stats.get("prefix_hits", 0),
            "prefix_cached_tokens": stats.get("cached_tokens", 0),
            "attribution_conserved": 1.0 if conserved else 0.0,
            **self.stamp}), flush=True)

    # -- --speculative ---------------------------------------------------------
    def run_speculative(self):
        """The speculative steady-decode replay (reference
        ``run_speculative``) on the random-weight target: the same
        requests twice an engine (wave 0 warms, wave 1 is measured from
        when its prefill drains) through one engine per ``--draft-k``
        and the per-token and adaptive-block baselines."""
        from ..inference import truncate_draft
        a = self.args
        draft = truncate_draft(self.cfg, self.params, a.draft_layers)
        n = min(a.requests, a.slots)
        reqs = [(self.rng.randint(0, self.vocab, int(self.rng.randint(
            a.min_prompt, a.max_prompt + 1))), a.max_new)
            for _ in range(n)]

        def leg(**ekw):
            engine = self.engine(**ekw)
            keys = ("spec_rounds", "spec_proposed", "spec_accepted",
                    "tokens_emitted", "decode_blocks")
            for wave in range(2):
                for p, n_ in reqs:
                    engine.add_request(p, n_)
                while engine._pending or engine._prefilling:
                    engine.step()
                if wave == 1:
                    engine.metrics.reset()
                    s0 = {k2: engine.stats[k2] for k2 in keys}
                    l0 = engine.ledger.totals()
                    self.sync()
                    t_start = time.perf_counter()
                while engine.has_work:
                    engine.step()
            self.sync()
            wall = time.perf_counter() - t_start
            lat = engine.metrics.get("serving_token_latency_seconds")
            d = {k2: engine.stats[k2] - s0[k2] for k2 in keys}
            out = {
                "tokens_per_sec": round(d["tokens_emitted"] / wall, 1),
                "p50_ms_per_token": _q_ms(lat, 0.5),
                "p99_ms_per_token": _q_ms(lat, 0.99),
                "spec_rounds": d["spec_rounds"],
                "accept_rate": round(d["spec_accepted"]
                                     / d["spec_proposed"], 3)
                if d["spec_proposed"] else None,
                "rounds_per_token": round(
                    d["spec_rounds"] / max(d["tokens_emitted"], 1), 4),
                "kv_pool_bytes": engine.kv.pool_bytes(),
                "draft_pool_bytes":
                    engine.spec.pool_bytes() if engine.spec else 0,
                "compile_counts": engine.compile_counts(),
                "ledger": ledger_fields(l0, engine.ledger.totals()),
                "anatomy_summary": engine.anatomy_report()["summary"]}
            engine.kv.verify()
            engine.close()
            return out

        base_k1 = leg(decode_block=1)
        base_ad = leg(decode_block="adaptive")
        for k in [int(t) for t in str(a.draft_k).split(",")]:
            spec = leg(speculative=draft, draft_k=k)
            rec = {
                "metric": f"gpt2_{a.model}_serving_speculative_"
                          "tokens_per_sec",
                "value": spec["tokens_per_sec"],
                "unit": "tokens/sec/chip", "draft_k": k,
                "draft_layers": draft[0].num_layers,
                "target_layers": self.cfg.num_layers,
                "spec_train_steps": 0,
                **{key: spec[key] for key in (
                    "accept_rate", "spec_rounds", "rounds_per_token",
                    "p50_ms_per_token", "p99_ms_per_token",
                    "kv_pool_bytes", "draft_pool_bytes")},
                "speedup_vs_k1": round(spec["tokens_per_sec"] / max(
                    base_k1["tokens_per_sec"], 1e-9), 2),
                "speedup_vs_adaptive": round(spec["tokens_per_sec"] / max(
                    base_ad["tokens_per_sec"], 1e-9), 2),
                "baseline_k1_tokens_per_sec": base_k1["tokens_per_sec"],
                "baseline_adaptive_tokens_per_sec":
                    base_ad["tokens_per_sec"],
                "decode_compiles": spec["compile_counts"]["decode_step"],
                "spec_verify_compiles":
                    spec["compile_counts"].get("spec_verify", 0),
                "requests": n, "slots": a.slots,
                "page_size": a.page_size, "max_new": a.max_new,
                **self.stamp}
            rec.update(spec["ledger"])
            rec.update(anatomy_fields(spec["anatomy_summary"]))
            print(json.dumps(rec), flush=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    given = [a.split("=")[0] for a in argv if a.startswith("--")]
    refused = [f for f in given if f in NOT_PORTED]
    if refused:
        sys.stderr.write(
            f"{', '.join(refused)}: not ported to paddle_tpu_torch "
            "(the fleet router, meshes and the target's pre-training "
            "come in later slices)\n")
        raise SystemExit(2)
    args = _parser().parse_args(argv)
    if args.shared_prefix and args.prefix_len <= 0:
        args.prefix_len = 256
    import torch
    with torch.no_grad():
        bench = Bench(args)
        if args.mixed_steady:
            bench.run_mixed_steady()
        elif args.workload:
            bench.run_workload()
        elif args.overload:
            bench.run_overload()
        elif args.speculative:
            bench.run_speculative()
        else:
            bench.run_default()


if __name__ == "__main__":
    main()
