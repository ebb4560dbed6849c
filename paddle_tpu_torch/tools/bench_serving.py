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

The fleet, as the reference's: ``--fleet N`` replays one mixed-tenant,
shared-prefix (``--prefix-groups`` groups), two-tier trace through a
``FleetRouter`` over N captured engines — the gentle replay under both
routing policies (affinity hit rate against the random baseline), the
high tier alone, and the overload replay under ``--route`` with replica
f0 killed at router step ``--kill-replica``; with ``--journal`` the
overload leg is recorded and replayed through a fresh fleet right away
(the ``fleet_journal_replay`` line). ``--autoscale MAX_N`` with
``--workload`` drives an elastic 1..MAX_N fleet through the workload
journal under the ``AutoscaleController`` (an ``SLOEngine`` on the
router's step clock over a count objective); with ``--journal`` it is
recorded and replayed through a fresh fleet and controller (the
``autoscale_replay`` line). The reference puts one replica on each chip;
here every replica is an engine on the one card, so these lines carry
``"chips": 1`` and ``replicas``, and ``platform`` is ``gpu`` (or
``cpu``) as the reference's backend names it.

Before the speculative legs, ``--spec-train-steps`` (300) Adam steps
pre-train the target, as the reference's ``_train_synthetic``: a port
``GPTForCausalLM`` with the bench's configuration and weights, in train
mode, through ``TrainStep`` with ``Adam(learning_rate=3e-3)`` on batches
of 16 x (s + 1) tokens, s = min(24, maxpos - 1), next = (tok + 7) mod V
with 8% noise, drawn from ``np.random.RandomState(--seed)`` in the
reference's order; the trained weights (``gen_params``) then serve and
make the draft. The line reports the steps and the training loss's first
step and the mean of its last ten (``spec_train_loss_first`` /
``_last``).

The mesh sweep, as the reference's: ``--mesh 1,2`` (or ``mp=1,2``)
replays the default stream once per mp degree (ascending, so the mp = 1
leg comes first) through a tensor-parallel engine
(``ServingEngine(mesh=make_mesh(mp))``, ``inference/tp.py``;
``--kv-shard heads|replicated``, ``--collective-dtype f32,int8``, the
int8 legs at mp > 1 only). An mp > 1 leg spawns its ranks
(``distributed.spawn``): rank 0 drives the engine, the others follow.
Its line divides the rate by mp (``value``, tokens/s/chip) and adds
``tokens_per_chip_vs_mp1``, ``kv_pool_bytes_per_chip``, the ledger's
``collective_bytes_per_token`` and the decode step's collective bytes
counted (the census of its first run) beside the prediction. It names
the process group's ``backend`` and whether the programs were
``captured``: every rank on one card shares it over ``gloo``, whose
collectives run on the host and cannot be captured, so such a line is
no multi-GPU number.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np



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
    ap.add_argument("--mesh", default="1",
                    help="comma-separated mp degrees (e.g. 1,2): one leg "
                         "each through a tensor-parallel engine of mp "
                         "ranks")
    ap.add_argument("--kv-shard", default="heads",
                    choices=("heads", "replicated"),
                    help="page pools sharded along heads or replicated "
                         "on every rank")
    ap.add_argument("--collective-dtype", default="f32",
                    help="comma-separated collective wire formats (f32, "
                         "int8); int8 legs at mp > 1 only")
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--draft-k", default="4")
    ap.add_argument("--draft-layers", type=int, default=None)
    ap.add_argument("--spec-train-steps", type=int, default=300,
                    help="Adam steps of synthetic pre-training of the "
                         "target before the speculative legs (0: the "
                         "random target)")
    ap.add_argument("--tenants", default=None,
                    help="name:weight,... tenant mix (own rng: the token "
                         "stream is unchanged)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="record the --overload resilient leg (or the "
                         "--workload replay, the --fleet overload leg, the "
                         "--autoscale run) to this journal file")
    ap.add_argument("--workload", default=None, metavar="FILE",
                    help="replay a workload journal through one fresh "
                         "engine and print the workload_replay line")
    ap.add_argument("--gen-workload", action="store_true",
                    help="(re)generate the --workload FILE from --seed "
                         "and --requests first (byte-reproducible)")
    ap.add_argument("--workload-min-new", type=int, default=1,
                    help="--gen-workload: the fewest new tokens a "
                         "request (its outputs are this times 1 + a "
                         "Pareto draw, up to --max-new)")
    ap.add_argument("--prefix-groups", type=int, default=4,
                    help="shared-prefix groups of a generated workload "
                         "and of the fleet trace")
    ap.add_argument("--fleet", type=int, default=0,
                    help="front this many engines with a FleetRouter and "
                         "replay one mixed-tenant trace through it")
    ap.add_argument("--kill-replica", type=int, default=None,
                    metavar="AT_STEP",
                    help="fleet mode: kill replica f0 (replica_down) at "
                         "this router step of the overload replay")
    ap.add_argument("--route", default="affinity",
                    choices=("affinity", "random"),
                    help="fleet mode routing policy of the overload "
                         "replay (the hit-rate comparison runs both)")
    ap.add_argument("--autoscale", type=int, default=0, metavar="MAX_N",
                    help="replay the --workload journal through an "
                         "elastic 1..MAX_N fleet under the autoscaler")
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


# -- the fleet's trace, fleet and drive (run_fleet's; chip_smoke.py's too) ---

def fleet_stream(rng, vocab, requests, *, prefix_groups, prefix_len,
                 min_prompt, max_prompt, min_new, max_new, high_frac,
                 tenant=None):
    """``run_fleet``'s trace: ``requests`` prompts, request i behind
    prefix group i mod ``prefix_groups`` (a ``prefix_len``-token system
    prompt each), tails of ``min_prompt``..``max_prompt`` tokens,
    ``min_new``..``max_new`` new tokens, ``high_frac`` of them at
    priority 2 (shuffled), the rest at 0. ``rng`` is a numpy
    ``RandomState`` or ``Generator``, drawn in one fixed order;
    ``tenant()`` names a request's tenant (None, or no ``tenant``:
    ``gold`` at priority 2, else ``bulk``). Returns request dicts
    (``prompt``, ``max_new_tokens``, ``priority``, ``tenant``)."""
    draw = getattr(rng, "integers", None) or rng.randint
    prefixes = [draw(0, vocab, prefix_len) for _ in range(prefix_groups)]
    n_high = max(1, int(round(requests * high_frac)))
    tiers = [2] * n_high + [0] * (requests - n_high)
    rng.shuffle(tiers)
    out = []
    for i in range(requests):
        tail = draw(0, vocab, int(draw(min_prompt, max_prompt + 1)))
        nnew = int(draw(min_new, max_new + 1))
        name = tenant() if tenant else None
        out.append({"prompt": np.concatenate([prefixes[i % prefix_groups],
                                              tail]),
                    "max_new_tokens": nnew, "priority": int(tiers[i]),
                    "tenant": name or ("gold" if tiers[i] >= 2
                                       else "bulk")})
    return out


def fleet_schedule(stream, arrival_steps=1, only_tier=None, kill=None):
    """``stream`` as a journal schedule, request i after i *
    ``arrival_steps`` router steps; ``only_tier`` drops the other tiers'
    submits but keeps their steps, so arrival times never shift;
    ``kill=(step, replica)`` adds a ``replica_down`` fault event at that
    step (after its submit)."""
    from ..observability import journal as jnl
    sched = jnl.schedule_from_stream(stream, arrival_steps=arrival_steps)
    if only_tier is not None:
        sched = [ev for ev, r in zip(sched, stream)
                 if r["priority"] == only_tier]
    if kill is not None:
        sched.append({"kind": "fault", "step": int(kill[0]),
                      "seq": len(stream) + 1, "fault": "replica_down",
                      "replica": kill[1]})
    return sched


def build_fleet(make_engine, n, **rkw):
    """``n`` engines from ``make_engine(fault_injector=...)`` (f0 gets a
    ``FaultInjector``: the kill target) as replicas f0..f{n-1} behind a
    ``FleetRouter`` with its own registry (``rkw``: the router's
    arguments). Returns (engines, router)."""
    from ..inference import EngineReplica, FaultInjector, FleetRouter
    from ..observability import MetricsRegistry
    engines = [make_engine(fault_injector=FaultInjector() if i == 0
                           else None) for i in range(n)]
    router = FleetRouter([EngineReplica(e, f"f{i}")
                          for i, e in enumerate(engines)],
                         registry=MetricsRegistry(), **rkw)
    return engines, router


def step_clock_slo(router, specs):
    """An ``SLOEngine`` over ``router``'s aggregator on its step clock:
    with count objectives its burns, and every decision read from them,
    are the same under replay."""
    from ..observability import SLOEngine
    router.slo = SLOEngine(specs, source=router.aggregator,
                           registry=router.metrics,
                           clock=lambda: float(router.steps_taken))
    return router.slo


def drive_fleet(router, sched, sync=lambda: None, on_tick=None, **kw):
    """``journal.replay`` of ``sched`` through ``router`` between two
    ``sync()`` calls (``kw``: replay's, e.g. ``controller``). Returns
    (the replay's result, its wall seconds less the seconds spent in
    ``on_tick``, those seconds)."""
    from ..observability import journal as jnl
    hook_s = [0.0]

    def tick(k):
        t = time.perf_counter()
        on_tick(k)
        hook_s[0] += time.perf_counter() - t
    sync()
    t0 = time.perf_counter()
    res = jnl.replay(sched, router, on_tick=tick if on_tick else None,
                     **kw)
    sync()
    return res, time.perf_counter() - t0 - hook_s[0], hook_s[0]


def tier_ttfts(done):
    """TTFT seconds of completions by tier: ``high`` (priority >= 2) and
    ``low``."""
    out = {"high": [], "low": []}
    for c in done.values():
        if c.ttft_s is not None:
            out["high" if c.priority >= 2 else "low"].append(c.ttft_s)
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
        mesh = kw.get("mesh")
        if mesh is not None and mesh.mp > 1 and mesh.backend == "gloo":
            kw["_capture"] = False     # host collectives: no CUDA graph
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
    @staticmethod
    def drive_kw(prefix_cache, decode_block="adaptive", kv_dtype=None,
                 weight_dtype=None, mesh=None, kv_shard="heads",
                 collective_dtype="f32"):
        """The engine arguments of one :meth:`drive` (a mesh's followers
        build theirs from the same)."""
        kw = dict(prefix_cache=prefix_cache, decode_block=decode_block,
                  kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                  logit_health=True, watchdog=True)
        if mesh is not None:
            kw.update(mesh=mesh, kv_shard=kv_shard,
                      collective_dtype=collective_dtype)
        return kw

    def drive(self, stream, prefix_cache, decode_block="adaptive",
              kv_dtype=None, weight_dtype=None, **mesh_kw):
        """One fresh engine over ``stream`` (reference ``drive``): a
        warm-up of prefix-free prompts (and a duplicate pair for the
        copy-on-write path), the registry reset, then the measured
        stream; with ``--steady-decode`` admission and prefill run
        outside the clock. ``mesh_kw``: ``mesh``, ``kv_shard``,
        ``collective_dtype`` of a mesh leader."""
        from ..observability import SLOEngine, SLOSpec
        a = self.args
        # the watchdog and the SLO evaluation ride the measured replay,
        # as the reference's drive
        engine = self.engine(**self.drive_kw(
            prefix_cache, decode_block, kv_dtype, weight_dtype, **mesh_kw))
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
        # the whole pool: a heads-sharded rank holds 1/mp of it
        pool = kv.pool_bytes() * (engine.chips
                                  if engine.kv_shard == "heads" else 1)
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
            "kv_pool_bytes": pool,
            "bytes_per_resident_token": round(
                pool / ((kv.num_pages - 1) * kv.page_size), 2),
            "chips": engine.chips,
            "kv_pool_bytes_per_chip": kv.pool_bytes(),
            "collective_bytes_per_token": round(
                sum(l1["coll_bytes"][p] - l0["coll_bytes"][p]
                    for p in ("decode", "prefill")) / max(total, 1), 2),
            "decode_collective_bytes_counted":
                engine.xla_costs.get("decode_step", {}).get(
                    "collective_bytes"),
            "decode_collective_bytes_predicted": int(
                engine.ledger.coll_bytes_per_position * engine.num_slots),
            "backend": engine.stats.get("backend"),
            "captured": engine.stats["graph_captures"] > 0,
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
        cd_sweep = [t.strip() for t in str(a.collective_dtype).split(",")]
        # ascending: the mp = 1 leg (tokens_per_chip_vs_mp1's reference)
        # runs first
        mesh_sweep = sorted(int(t) for t in
                            str(a.mesh).replace("mp=", "").split(","))
        stream = self.make_stream(a.requests)
        base_absmax, mp1 = {}, {}
        for mp in mesh_sweep:
            for kd in kv_sweep:
                for wd in wd_sweep:
                    for cd in cd_sweep:
                        # the int8 collective is wire format between
                        # ranks: none at mp = 1
                        if cd != "f32" and mp <= 1:
                            continue
                        for k in sweep:
                            self._one_line(stream, kd, wd, k, base_absmax,
                                           mp=mp, cd=cd, mp1=mp1)

    def _leg(self, stream, prefix_cache, k, kd, wd, mp, cd):
        """One drive: in this process at mp = 1, else over ``mp`` spawned
        ranks (:func:`_mesh_leg`)."""
        if mp <= 1:
            return self.drive(stream, prefix_cache, decode_block=k,
                              kv_dtype=kd, weight_dtype=wd)
        from ..distributed.spawn import spawn
        return spawn(_mesh_leg, (self.args, self.rng.get_state(), stream,
                                 prefix_cache, k, kd, wd, cd),
                     nprocs=mp, device=self.device.type)[0]

    def _one_line(self, stream, kd, wd, k, base_absmax, mp=1, cd="f32",
                  mp1=None):
        a = self.args
        run = self._leg(stream, True, k, kd, wd, mp, cd)
        off = self._leg(stream, False, k, kd, wd, mp, cd) \
            if a.shared_prefix else None
        # the logit-error reference is the full-precision leg only
        quantized = kd is not None or wd is not None or cd != "f32"
        if not quantized and k not in base_absmax:
            base_absmax[k] = run["logit_absmax"]
        ref = base_absmax.get(k)
        quant_err = (round(abs(run["logit_absmax"] - ref) / ref, 6)
                     if quantized and ref and run["logit_absmax"]
                     is not None else None)
        per_chip = round(run["tokens_per_sec"] / run["chips"], 1)
        mp1 = {} if mp1 is None else mp1
        if mp == 1:
            mp1[(kd, wd, k)] = per_chip
        rec = {
            "metric": f"gpt2_{a.model}_serving_tokens_per_sec_per_chip",
            "value": per_chip, "unit": "tokens/sec/chip",
            "mp": mp, "kv_shard": a.kv_shard if mp > 1 else None,
            "tokens_per_chip_vs_mp1": round(per_chip / mp1[(kd, wd, k)], 4)
            if mp > 1 and mp1.get((kd, wd, k)) else None,
            "backend": run["backend"], "captured": run["captured"],
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
            "collective_dtype": cd,
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
            **self.stamp, "chips": run["chips"], "snapshot": run["snapshot"]}
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
                min_new=a.workload_min_new, max_new=a.max_new,
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

    # -- --fleet --------------------------------------------------------------
    def fleet_stamp(self, replicas):
        """The fleet lines' device keys: the reference's backend name
        (``gpu`` or ``cpu``), one card, and the replicas on it."""
        return {**self.stamp,
                "platform": "gpu" if self.device.type == "cuda" else "cpu",
                "chips": 1, "replicas": int(replicas)}

    def run_fleet(self):
        """The fleet-router replay (reference ``run_fleet``). One
        mixed-tenant, shared-prefix, two-tier trace through a
        ``FleetRouter`` over ``--fleet`` engines, three ways: (a) a
        gently paced replay under both routing policies with saturation
        off — the affinity hit rate against the random baseline on the
        same traffic; (b) the high tier alone at the same cadence — the
        uncontended TTFT reference; (c) the full replay under ``--route``
        with replica f0 killed at ``--kill-replica`` — p99 TTFT per tier,
        the high-against-uncontended ratio and survival through the kill.
        With ``--journal`` (c) is recorded and replayed through a fresh
        fleet, and a second line carries the divergence count."""
        from ..observability import journal as jnl
        a, rng = self.args, self.rng
        N = a.fleet
        G = max(1, a.prefix_groups)
        plen = a.prefix_len
        stream = fleet_stream(
            rng, self.vocab, a.requests, prefix_groups=G, prefix_len=plen,
            min_prompt=a.min_prompt, max_prompt=a.max_prompt,
            min_new=max(a.max_new // 2, 1), max_new=a.max_new,
            high_frac=a.high_frac, tenant=self.draw_tenant)
        n_high = sum(r["priority"] >= 2 for r in stream)

        def make_engine(**kw):
            e = self.engine(**kw)
            # warm-up per engine: the programs and the copy-on-write
            # page copy (a duplicate pair) outside measured TTFT
            for p, n in self.make_stream(max(a.warmup_requests, 1),
                                         with_prefix=False):
                e.add_request(p, n)
            dup = rng.randint(0, self.vocab, a.page_size)
            e.add_request(dup, 2)
            e.add_request(dup, 2)
            e.run(max_steps=1_000_000)
            return e

        def fleet(policy, **rkw):
            return build_fleet(make_engine, N, policy=policy, **rkw)

        def replay(router, kill_step=None, only_tier=None):
            """Request i lands after i * ``--arrival-steps`` router
            steps; the kill takes f0 at ``kill_step``."""
            res, wall, _ = drive_fleet(router, fleet_schedule(
                stream, a.arrival_steps, only_tier,
                None if kill_step is None else (kill_step, "f0")),
                self.sync)
            return {c.uid: c for c in res.completions.values()}, wall

        # (a) the hit-rate comparison: both policies, the same trace,
        # saturation fallback off so the number measures placement alone
        hit_rates, aff_cached = {}, []
        for pol in ("affinity", "random"):
            engines, router = fleet(pol, saturation_depth=10 ** 9)
            replay(router)
            hit_rates[pol] = router.affinity_hit_rate()
            if pol == "affinity":
                aff_cached = [e.stats["cached_tokens"] for e in engines]
            router.close()
        # (b) the uncontended reference: the high tier alone, no kill
        engines, router = fleet(a.route)
        done_u, _ = replay(router, only_tier=2)
        high_u = _pcts(tier_ttfts(done_u)["high"])
        router.close()
        # (c) the oversubscribed replay with the mid-trace kill
        engines, router = fleet(a.route, saturation_depth=2 * a.slots,
                                journal=a.journal)
        done_o, wall = replay(router, kill_step=a.kill_replica)
        tt = tier_ttfts(done_o)
        high_o, low_o = _pcts(tt["high"]), _pcts(tt["low"])
        ok = sum(1 for c in done_o.values()
                 if c.finish_reason in ("eos", "length"))
        reasons = {}
        for c in done_o.values():
            reasons[c.finish_reason] = reasons.get(c.finish_reason, 0) + 1
        ratio = (round(high_o["p99_ms"] / high_u["p99_ms"], 3)
                 if high_o["p99_ms"] and high_u["p99_ms"] else None)
        toks = sum(len(c.tokens) for c in done_o.values())
        arep = router.anatomy_report()     # read before close
        rec = {
            "metric": f"gpt2_{a.model}_fleet_router_affinity_hit_rate",
            "value": round(hit_rates["affinity"], 4),
            "unit": "fraction", "fleet": N, "route": a.route,
            "kill_step": a.kill_replica, "requests": a.requests,
            "slots": a.slots, "prefix_groups": G, "prefix_len": plen,
            "high_frac": round(n_high / a.requests, 3),
            "arrival_steps": a.arrival_steps,
            "random_hit_rate": round(hit_rates["random"], 4),
            "hit_rate_minus_random": round(
                hit_rates["affinity"] - hit_rates["random"], 4),
            "affinity_cached_tokens_per_replica": aff_cached,
            "ttft": {"high": high_o, "low": low_o},
            "uncontended_high": high_u,
            "high_p99_vs_uncontended": ratio,
            "survived_frac": round(ok / len(stream), 4),
            "completions": reasons,
            "replica_deaths": router.stats["replica_deaths"],
            "replica_dead_reasons": [d["reason"] for d in router.deaths],
            "requeued": router.stats["requeued"],
            "preempts_remote": router.stats["preempts_remote"],
            "tokens_per_sec": round(toks / wall, 1),
            "decode_compiles_max": max(
                e.compile_counts()["decode_step"] for e in engines),
            "prefill_compiles_max": max(
                e.compile_counts()["prefill_chunk"] for e in engines),
            **self.fleet_stamp(N)}
        rec.update(anatomy_fields(arep["summary"]))
        router.close()
        print(json.dumps(rec), flush=True)
        if not a.journal:
            return
        # a recorded window is only a journal if a FRESH fleet driven
        # through it lands on the same tokens
        engines2, router2 = fleet(a.route, saturation_depth=2 * a.slots)
        res, wall2, _ = drive_fleet(router2, a.journal, self.sync)
        report = jnl.check_divergence(a.journal, res,
                                      registry=router2.metrics)
        toks2 = sum(len(c.tokens) for c in res.completions.values())
        router2.close()
        print(json.dumps({
            "metric": f"gpt2_{a.model}_fleet_journal_replay",
            "value": float(report["divergences"]),
            "unit": "divergences", "journal": a.journal,
            "requests": report["requests"],
            "replayed": report["replayed"],
            "replay_identical": 1.0 if report["identical"] else 0.0,
            "rejected": len(res.rejected), "ticks": res.ticks,
            "replay_tokens_per_sec": round(toks2 / max(wall2, 1e-9), 1),
            "first_divergence": report["first"],
            "anatomy_divergences": sum(
                1 for d in report["all"] if d["field"] == "anatomy"),
            "anatomy_requests_recorded": report["anatomy"]["recorded"],
            "anatomy_requests_replayed": report["anatomy"]["replayed"],
            **self.fleet_stamp(N)}), flush=True)

    # -- --autoscale ----------------------------------------------------------
    def run_autoscale(self):
        """The workload replay with the controller closed over the fleet
        (reference ``run_autoscale``). The ``--workload`` journal drives
        an elastic 1..``--autoscale`` fleet (one replica from the start;
        the ``AutoscaleController`` joins and drains the rest on queue
        pressure and per-tenant burn); after the schedule drains, the
        idle tail runs until the fleet is back at its floor. The numbers
        are step-denominated: the replica-count trace, scaling lag,
        chip-steps against static N, the worst gold-tier burn, and each
        join's capture seconds beside its lag. With ``--journal`` the run
        is recorded and replayed through a FRESH fleet and controller —
        ``check_divergence`` on tokens, outcomes, ledger, decisions and
        anatomy lands on the second line."""
        from ..inference import (AutoscaleController, AutoscalePolicy,
                                 EngineReplica, FleetRouter)
        from ..observability import MetricsRegistry, SLOSpec
        from ..observability import journal as jnl
        a = self.args
        rd, wl = self.load_workload()
        max_n = max(int(a.autoscale), 2)
        pol = AutoscalePolicy(
            min_replicas=1, max_replicas=max_n, scale_out_burn=0.5,
            queue_high=float(a.slots), confirm_out=2, queue_low=0.0,
            scale_in_burn=0.25, idle_steps=24, cooldown_steps=12)

        def make_engine():
            # no warm-up: an engine's state is a function of the
            # schedule alone, so record and replay mint identical
            # replicas (a captured engine's programs are ready at its
            # constructor's end)
            return self.engine()

        def build(journal):
            router = FleetRouter(
                [EngineReplica(make_engine(), "a0")],
                registry=MetricsRegistry(), journal=journal,
                name="autoscale0", seed=a.seed)
            # burn on the STEP clock over a count objective: the
            # decision inputs stay deterministic under replay
            step_clock_slo(router, [SLOSpec(
                name="gold-success", tenant="gold", success_frac=0.99,
                windows=(8.0, 64.0), min_count=2)])
            ctl = AutoscaleController(router, make_engine, pol,
                                      static_n=max_n)
            return router, ctl

        def failures(ctl, deaths):
            # what the controller and the router would otherwise absorb:
            # a factory that raised (a join_failed hold) and a replica
            # whose step raised (a death), each with its exception
            return {"join_failed": sum(
                        d["counterfactual"]["blocked"] == "join_failed"
                        for d in ctl.decisions),
                    "join_errors": [e for _, e in ctl.join_errors],
                    "replica_deaths": len(deaths),
                    "replica_dead_reasons": deaths}

        def drive(router, ctl):
            burn = [0.0]

            def on_tick(_k):
                burn[0] = max(burn[0], float(
                    router.scale_signals().get("max_burn") or 0.0))
            res, _, _ = drive_fleet(router, rd, self.sync, on_tick,
                                    controller=ctl)
            for _ in range(600):       # the idle scale-in tail
                if len(router.live_replicas()) <= pol.min_replicas:
                    break
                router.step()
                ctl.tick()
            self.sync()
            burn[0] = max(burn[0], float(
                router.scale_signals().get("max_burn") or 0.0))
            return res, burn[0]

        router, ctl = build(a.journal)
        res, burn_max = drive(router, ctl)
        rep = ctl.report()
        trace = [n for _, n in rep["replica_trace"]]
        elastic_1n1 = trace[0] == 1 and trace[-1] == 1 and max(trace) > 1
        toks = sum(len(c.tokens) for c in res.completions.values())
        joins = [{"replica": d["replica"], "step": d["step"],
                  "lag_steps": d["counterfactual"]["lag_steps"],
                  "capture_s": round(router.replicas[d["replica"]]
                                     .handle.engine.capture_seconds, 4)}
                 for d in ctl.decisions if d["decision"] == "scale_out"]
        router_joins = router.stats["joins"]
        placed = {}
        for sr in (router.metrics.snapshot().get("router_requests_total")
                   or {"series": []})["series"]:
            nm = sr["labels"]["replica"]
            placed[nm] = placed.get(nm, 0) + int(sr["value"])
        deaths = [d["reason"] for d in router.deaths]
        router.close()
        print(json.dumps({
            "metric": f"gpt2_{a.model}_autoscale_chip_steps_saved_frac",
            "value": round(rep["chip_steps_saved_frac"], 4),
            "unit": "fraction", "workload": a.workload,
            "workload_meta": {k: wl.get(k) for k in (
                "seed", "requests", "base_arrivals_per_tick",
                "burst_mult", "horizon_ticks") if k in wl},
            "static_n": ctl.static_n, "chip_steps": rep["chip_steps"],
            "chip_steps_static": rep["chip_steps_static"],
            "chip_steps_under_static": 1.0
            if rep["chip_steps"] < rep["chip_steps_static"] else 0.0,
            "replica_trace": rep["replica_trace"],
            "max_replicas_seen": rep["max_replicas_seen"],
            "elastic_1_n_1": 1.0 if elastic_1n1 else 0.0,
            "gold_burn_max": round(burn_max, 4),
            "gold_burn_under_1": 1.0 if burn_max < 1.0 else 0.0,
            "scaling_lag_max_steps": rep["scaling_lag_max_steps"],
            "decisions": rep["decisions"],
            "blocked_cooldown": rep["blocked_cooldown"],
            "chip_accounting_conserved": 1.0
            if rep["conservation"]["conserved"] else 0.0,
            "requests": len(res.completions),
            "rejected": len(res.rejected),
            "ticks": rep["ticks"], "tokens": toks,
            "router_joins": router_joins, "joins": joins,
            "placements_by_replica": placed, **failures(ctl, deaths), **self.fleet_stamp(max_n)}),
            flush=True)
        if not a.journal:
            return
        router2, ctl2 = build(None)
        res2, _ = drive(router2, ctl2)
        report = jnl.check_divergence(a.journal, res2,
                                      registry=router2.metrics)
        deaths2 = [d["reason"] for d in router2.deaths]
        router2.close()
        print(json.dumps({
            "metric": f"gpt2_{a.model}_autoscale_replay",
            "value": float(report["divergences"]),
            "unit": "divergences", "journal": a.journal,
            "replay_identical": 1.0 if report["identical"] else 0.0,
            "requests": report["requests"],
            "replayed": report["replayed"],
            "scale_decisions": report["scale_decisions"],
            "first_divergence": report["first"],
            **failures(ctl2, deaths2), **self.fleet_stamp(max_n)}),
            flush=True)

    # -- --speculative ---------------------------------------------------------
    def train_synthetic(self, steps):
        """``steps`` Adam steps of the target on the synthetic stream
        next = (tok + 7) mod V with 8% noise (reference
        ``_train_synthetic``): the bench's weights loaded into a port
        ``GPTForCausalLM``, trained in train mode (dropout on) through
        ``TrainStep``, then handed back as ``self.params``. Returns the
        per-step losses (None for ``steps <= 0``)."""
        if steps <= 0:
            return None
        torch = self.torch
        from ..models.gpt import GPTForCausalLM, gen_params, tree_map
        from ..optimizer import Adam
        from ..parallel.api import TrainStep
        model = GPTForCausalLM(self.cfg, device=self.device,
                               seed=self.args.seed)
        dst = []
        tree_map(dst.append, gen_params(model))
        src = []
        tree_map(src.append, self.params)
        torch._foreach_copy_(dst, src)
        model.train()
        step = TrainStep(model, lambda m, x, y: m.loss(x, y),
                         Adam(learning_rate=3e-3), device=self.device)
        vocab, maxpos = self.vocab, self.cfg.max_position_embeddings
        trng = np.random.RandomState(self.args.seed)
        s = min(24, maxpos - 1)
        losses = []
        with torch.enable_grad():
            for _ in range(steps):
                x = np.zeros((16, s + 1), np.int64)
                x[:, 0] = trng.randint(0, vocab, 16)
                for t in range(1, s + 1):
                    nxt = (x[:, t - 1] + 7) % vocab
                    ns = trng.rand(16) < 0.08
                    x[:, t] = np.where(ns, trng.randint(0, vocab, 16), nxt)
                losses.append(step(x[:, :-1], x[:, 1:]))
        model.eval()
        self.params = gen_params(model)
        return torch.stack(losses).float().cpu().numpy()

    def run_speculative(self):
        """The speculative steady-decode replay (reference
        ``run_speculative``) on the target after ``--spec-train-steps``
        of :meth:`train_synthetic`: the same requests twice an engine
        (wave 0 warms, wave 1 is measured from when its prefill drains)
        through one engine per ``--draft-k`` and the per-token and
        adaptive-block baselines."""
        from ..inference import truncate_draft
        a = self.args
        losses = self.train_synthetic(a.spec_train_steps)
        train = {"spec_train_steps": max(int(a.spec_train_steps), 0),
                 "spec_train_loss_first": None
                 if losses is None else float(losses[0]),
                 "spec_train_loss_last": None
                 if losses is None else float(losses[-10:].mean())}
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
                "target_layers": self.cfg.num_layers, **train,
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


def _mesh_leg(info, args, rng_state, stream, prefix_cache, k, kd, wd, cd):
    """One rank of an mp > 1 leg of the default sweep: every rank builds
    the bench (the same weights from seed 0) and the engine on its
    device; rank 0 drives it from the parent's random state and returns
    the run, the others follow."""
    import torch

    from ..inference.tp import make_mesh
    args.device = str(info.device)
    if info.device.type == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // info.nprocs))
    with torch.no_grad():
        bench = Bench(args)
        bench.rng.set_state(rng_state)
        mesh_kw = dict(mesh=make_mesh(info.nprocs, device=info.device),
                       kv_shard=args.kv_shard, collective_dtype=cd)
        if info.rank == 0:
            run = bench.drive(stream, prefix_cache, decode_block=k,
                              kv_dtype=kd, weight_dtype=wd, **mesh_kw)
            run["peak_memory_bytes"] = torch.cuda.max_memory_allocated(
                info.device) if info.device.type == "cuda" else None
            return run
        engine = bench.engine(**bench.drive_kw(prefix_cache, k, kd, wd,
                                               **mesh_kw))
        engine.follow()
        engine.close()
        return None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if (args.mesh.replace("mp=", "") != "1" or args.kv_shard != "heads"
            or args.collective_dtype != "f32") and (
            args.mixed_steady or args.workload or args.fleet
            or args.overload or args.speculative):
        raise SystemExit("--mesh, --kv-shard and --collective-dtype sweep "
                         "the default stream only")
    if args.shared_prefix and args.prefix_len <= 0:
        args.prefix_len = 256
    if args.fleet and args.prefix_len <= 0:
        # the fleet's affinity subject: a 2-page shared system prompt a
        # group (sized into max_seq_len)
        args.prefix_len = 2 * args.page_size
    import torch
    with torch.no_grad():
        bench = Bench(args)
        if args.mixed_steady:
            bench.run_mixed_steady()
        elif args.workload:
            if args.autoscale:
                bench.run_autoscale()
            else:
                bench.run_workload()
        elif args.fleet:
            bench.run_fleet()
        elif args.overload:
            bench.run_overload()
        elif args.speculative:
            bench.run_speculative()
        else:
            bench.run_default()


if __name__ == "__main__":
    main()
