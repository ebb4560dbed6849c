#!/usr/bin/env python3
"""Replay a recorded fleet journal through a fresh fleet of the port's
engines — port of ``tools/replay.py``.

    python3 -m paddle_tpu_torch.tools.replay --journal rec.jsonl
        [--device cpu] [--param-seed 0] [--out replayed.jsonl]
        [--kv-dtype keep|none|bf16|int8|fp8] [--weight-dtype keep|...]
        [--decode-block keep|adaptive|K] [--expect-divergence]
        [--mesh MP] [--collective-dtype keep|f32|int8]
    python3 -m paddle_tpu_torch.tools.replay --selfcheck [--device cpu]

Run from the repository root. Rebuilds a FRESH fleet from the journal's
own config fingerprints (model config, engine levers, the router's
admission tier; weights from ``init_params(cfg, seed=--param-seed)``),
drives it through the recorded schedule with
``observability.journal.replay()`` and diffs the outcome against the
recording with ``check_divergence()``: token streams, finish reasons,
ledger conservation, scale decisions and anatomy segments; the first
divergence is reported with its span context. Runs on the card (CUDA)
unless ``--device cpu`` is given.

- **Identity harness** (default): exits 0 iff the replay is
  token-identical per request and nothing else went wrong.
- **Config A/B**: override a lever (``--kv-dtype``, ``--weight-dtype``,
  ``--decode-block``) and count what it changes; ``--expect-divergence``
  keeps the exit code 0 so a sweep collects the deltas.

A rebuilt ``weights_digest`` that differs from the recorded one is a
problem (exit 2): the weights the journal was recorded with are not the
ones ``--param-seed`` makes. A journal recorded by the JAX reference's
engines says so here, since its weights come from ``paddle.seed``;
replay such a journal through :func:`build_fleet` with the recording's
weights passed as ``params``.

``--out`` writes the REPLAYED run's own journal, its meta cross-linked
(``replayed_from``) to the recorded journal's id.

``--selfcheck`` records a 2-replica fleet scenario with a mid-stream
replica kill, a remote preemption and mixed greedy/sampled traffic,
replays it (must be divergence-free), then tampers one recorded token
(the checker must trip, with span context) and checks the workload
generator's byte-reproducibility.

Workload journals (``observability.journal.write_workload``) carry no
config events: drive those through ``bench_serving --workload``, which
owns the engine configuration.

``--mesh MP`` (MP > 1) rebuilds every replica as a tensor-parallel
engine over MP spawned ranks (``inference/tp.py``; rank 0 replays, the
others follow every replica's dispatches), so a journal recorded on one
card replays on a mesh; under ``f32`` collectives it must replay to the
same tokens. ``--collective-dtype`` overrides the recorded wire format
(an A/B lever, as the others).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile



def _none_if(v):
    return None if v in ("none", "None", "") else v


def _config(model_fp):
    """The port's ``GPTConfig`` from a fingerprint's ``model`` record
    (keys of levers the port does not have, the MoE ones, left out)."""
    from ..models.gpt import GPTConfig
    names = {f.name for f in dataclasses.fields(GPTConfig)}
    return GPTConfig(**{k: v for k, v in model_fp.items() if k in names})


def build_fleet(rec, args, registry, out_writer=None, quiet=False,
                params=None, mesh=None):
    """A fresh fleet from the journal's config events (and the A/B
    overrides in ``args``). ``params`` overrides the weights
    (``init_params(cfg, seed=args.param_seed)`` otherwise), for a journal
    whose weights no seed of the port makes; ``mesh`` makes every
    replica a tensor-parallel engine over it. Returns (router,
    problems)."""
    from ..inference import (EngineReplica, FaultInjector, FleetRouter,
                             ServingEngine)
    from ..models.gpt import init_params
    from ..observability import MetricsRegistry

    problems = []
    cfgs = rec.by_kind("config")
    router_fp = next(
        (e["fingerprint"] for e in cfgs
         if (e.get("fingerprint") or {}).get("kind") == "router"), {})
    eng_cfgs = [e for e in cfgs
                if (e.get("fingerprint") or {}).get("model")]
    if not eng_cfgs:
        raise SystemExit(
            f"{args.journal}: no engine config events — only recorded "
            "journals (FleetRouter/ServingEngine with journal=...) "
            "can rebuild a fleet; drive workload journals through "
            "bench_serving --workload")

    weights = {}

    def weights_for(fp):
        key = json.dumps(fp["model"], sort_keys=True)
        if key not in weights:
            cfg = _config(fp["model"])
            weights[key] = (cfg, params if params is not None else
                            init_params(cfg, seed=int(args.param_seed),
                                        device=args.device))
        return weights[key]

    replicas = []
    for e in eng_cfgs:
        fp = dict(e["fingerprint"])
        nm = e["replica"]
        kw = dict(
            num_slots=fp["num_slots"], page_size=fp["page_size"],
            num_pages=fp.get("num_pages"),
            max_seq_len=fp["max_seq_len"],
            prefill_chunk=fp["prefill_chunk"],
            mixed_step=fp.get("mixed_step", False),
            # the mixed-step engine has no interleaving policy: passing
            # the recorded resolved value would raise
            prefill_chunks_per_step=(
                None if fp.get("mixed_step")
                else fp.get("prefill_chunks_per_step", 1)),
            admit_lookahead=fp.get("admit_lookahead", 4),
            decode_block=fp.get("decode_block", "adaptive"),
            decode_block_buckets=tuple(
                fp.get("decode_block_buckets", (1, 4, 8, 16))),
            kv_dtype=fp.get("kv_dtype"),
            weight_dtype=fp.get("weight_dtype"),
            max_queue=fp.get("max_queue"),
            shed_policy=fp.get("shed_policy", "reject"),
            preemption=fp.get("preemption", True),
            prefix_cache=fp.get("prefix_cache", True),
            registry=MetricsRegistry(),
            fault_injector=FaultInjector())
        if fp.get("speculative") and not quiet:
            print(f"# note: {nm} recorded with speculative decoding — "
                  "replayed without a draft (not reconstructable "
                  "from the fingerprint)", file=sys.stderr)
        # the config-A/B levers
        if args.kv_dtype != "keep":
            kw["kv_dtype"] = _none_if(args.kv_dtype)
        if args.weight_dtype != "keep":
            kw["weight_dtype"] = _none_if(args.weight_dtype)
        if args.decode_block != "keep":
            kw["decode_block"] = (
                args.decode_block if args.decode_block == "adaptive"
                else int(args.decode_block))
        if mesh is not None:
            kw.update(mesh=mesh, collective_dtype=(
                fp.get("collective_dtype", "f32")
                if getattr(args, "collective_dtype", "keep") == "keep"
                else args.collective_dtype))
            if mesh.backend == "gloo":
                kw["_capture"] = False    # host collectives: no CUDA graph
        cfg, p = weights_for(fp)
        eng = ServingEngine(cfg, p, device=args.device, **kw)
        got = eng.config_fingerprint()["weights_digest"]
        want = fp.get("weights_digest")
        if want and got != want:
            problems.append(
                f"{nm}: rebuilt weights digest {got} != recorded "
                f"{want} (wrong --param-seed?)")
        replicas.append(EngineReplica(eng, nm))

    rkw = {}
    if router_fp:
        rkw = dict(
            name=router_fp.get("name", "router0"),
            policy=router_fp.get("policy", "affinity"),
            max_queue=router_fp.get("max_queue"),
            shed_policy=router_fp.get("shed_policy", "reject"),
            saturation_depth=router_fp.get("saturation_depth"),
            dispatch_lookahead=router_fp.get("dispatch_lookahead", 4),
            preemption=router_fp.get("preemption", True),
            seed=router_fp.get("seed", 0),
            affinity_capacity=router_fp.get(
                "affinity_capacity", 65536))
    router = FleetRouter(replicas, registry=registry,
                         journal=out_writer, **rkw)
    return router, problems


def _mesh_replay(info, args):
    """One rank of ``--mesh``: rank 0 replays (and returns the exit
    code), the others follow every replica."""
    import torch

    from ..inference.tp import make_mesh
    from ..observability import MetricsRegistry
    from ..observability import journal as J
    args.device = str(info.device)
    mesh = make_mesh(info.nprocs, device=info.device)
    with torch.no_grad():
        if info.rank == 0:
            return run_replay(args, mesh=mesh)
        router, _ = build_fleet(J.read_journal(args.journal), args,
                                MetricsRegistry(), quiet=True, mesh=mesh)
        engines = [st.handle.engine for st in router.replicas.values()]
        engines[0].follow(*engines[1:])
    return None


def run_replay(args, mesh=None):
    from ..observability import MetricsRegistry
    from ..observability import journal as J

    rec = J.read_journal(args.journal)
    problems = [f"parse: {e}" for e in rec.errors]
    if rec.truncated and not args.quiet:
        print(f"# note: {args.journal} has a torn tail — replaying "
              "the intact prefix", file=sys.stderr)
    registry = MetricsRegistry()
    out_writer = None
    if args.out:
        out_writer = J.JournalWriter(
            args.out, name="replay",
            meta={"replayed_from": rec.meta.get("id"),
                  "replayed_journal": os.path.abspath(args.journal)},
            registry=registry)
    router, build_problems = build_fleet(
        rec, args, registry, out_writer=out_writer, quiet=args.quiet,
        mesh=mesh)
    problems += build_problems
    res = J.replay(rec, router, max_steps=int(args.max_steps))
    report = J.check_divergence(rec, res, registry=registry)
    router.close()
    for st in router.replicas.values():   # a dead replica's too
        st.handle.engine.close()
    if out_writer is not None:
        out_writer.close()

    toks = sum(len(c.tokens) for c in res.completions.values())
    line = {
        "metric": "journal_replay",
        "journal": os.path.abspath(args.journal),
        "requests": report["requests"],
        "replayed": report["replayed"],
        "rejected": len(res.rejected),
        "divergences": report["divergences"],
        "identical": bool(report["identical"]),
        "ticks": res.ticks,
        "wall_s": round(res.wall_s, 3),
        "tokens_per_sec": round(toks / max(res.wall_s, 1e-9), 2),
        "first_divergence": report["first"],
        "problems": problems,
        "platform": args.device,
        "mp": 1 if mesh is None else mesh.mp,
        "backend": None if mesh is None else mesh.backend,
    }
    print(json.dumps(line))
    if problems and not args.quiet:
        for p in problems:
            print(f"PROBLEM: {p}", file=sys.stderr)
    if args.expect_divergence:
        return 0
    return 0 if report["identical"] and not problems else 2


# -- selfcheck ----------------------------------------------------------------

SELFCHECK_MODEL = dict(vocab_size=97, hidden_size=32, num_layers=2,
                       num_heads=4, max_position_embeddings=64,
                       dropout=0.0)


def selfcheck(args):
    import numpy as np

    from ..inference import (EngineReplica, FaultInjector, FleetRouter,
                             ServingEngine)
    from ..models.gpt import GPTConfig, init_params
    from ..observability import MetricsRegistry
    from ..observability import journal as J

    problems = []
    say = (lambda *a: None) if args.quiet else print
    tmpdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_replay_selfcheck_")
    cfg = GPTConfig(**SELFCHECK_MODEL)
    params = init_params(cfg, seed=int(args.param_seed),
                         device=args.device)

    def fleet(journal=None):
        def mk(inj):
            return ServingEngine(
                cfg, params, device=args.device, num_slots=2,
                page_size=8, prefill_chunk=8, max_seq_len=64,
                decode_block=1, registry=MetricsRegistry(),
                fault_injector=inj)
        e0 = mk(FaultInjector())
        return FleetRouter(
            [EngineReplica(e0, "f0"), EngineReplica(mk(None), "f1")],
            registry=MetricsRegistry(), journal=journal,
            saturation_depth=2), e0

    # the scenario in miniature: shared-prefix groups, mixed
    # greedy/fixed-seed sampled traffic, a priority-2 arrival into a
    # saturated fleet (remote preemption), a mid-stream replica kill
    rng = np.random.RandomState(42)
    pref = rng.randint(0, 97, 16)
    reqs = []
    for i in range(12):
        tail = rng.randint(0, 97, 4 + (i % 5))
        reqs.append(dict(
            prompt=np.concatenate([pref, tail]) if i % 2 == 0
            else tail,
            max_new_tokens=6,
            temperature=0.8 if i % 3 == 0 else 0.0,
            seed=100 + i if i % 3 == 0 else 0,
            priority=2 if i == 7 else 0,
            tenant="gold" if i % 3 == 0 else "bulk"))

    rec_path = os.path.join(tmpdir, "recorded.jsonl")
    router, e0 = fleet(journal=rec_path)
    done = {}
    ticks = 0
    for rq in reqs:
        router.submit(**rq)
        for _ in range(2):
            for c in router.step():
                done[c.uid] = c
            ticks += 1
            if ticks == 10:
                e0.faults.inject("replica_down")
    done.update(router.run(max_steps=100_000))
    router.close()
    if len(done) != len(reqs):
        problems.append(
            f"recorded run finished {len(done)}/{len(reqs)}")

    rec = J.read_journal(rec_path)
    for kind in ("meta", "config", "submit", "fault",
                 "replica_dead", "complete", "summary"):
        if not rec.by_kind(kind):
            problems.append(f"recorded journal has no {kind!r} event")

    # record -> replay must be divergence-free
    out_path = os.path.join(tmpdir, "replayed.jsonl")
    rargs = argparse.Namespace(
        journal=rec_path, out=None, kv_dtype="keep", weight_dtype="keep",
        decode_block="keep", param_seed=args.param_seed,
        device=args.device, quiet=True)
    reg2 = MetricsRegistry()
    ow = J.JournalWriter(out_path, name="replay",
                         meta={"replayed_from": rec.meta.get("id")},
                         registry=reg2)
    router2, bp = build_fleet(rec, rargs, reg2, out_writer=ow,
                              quiet=True)
    problems += bp
    res = J.replay(rec, router2)
    report = J.check_divergence(rec, res, registry=reg2)
    router2.close()
    ow.close()
    if not report["identical"]:
        problems.append(
            f"record->replay diverged: {report['first']}")
    rep = J.read_journal(out_path)
    if rep.meta.get("replayed_from") != rec.meta.get("id"):
        problems.append("replayed journal not cross-linked to the "
                        "recorded one")

    # the checker itself must trip on a seeded divergence, with span
    # context naming where to look
    tampered = json.loads(json.dumps(rec.events))
    for e in tampered:
        if e["kind"] == "complete" and e.get("tokens"):
            e["tokens"][0] = (e["tokens"][0] + 1) % 97
            break
    bad = J.check_divergence(tampered, res)
    if bad["identical"] or bad["first"] is None:
        problems.append("divergence checker missed a tampered token")
    elif bad["first"]["field"] != "tokens" or \
            "span" not in bad["first"]:
        problems.append(
            f"tampered-token divergence misreported: {bad['first']}")

    # workload generator: byte-reproducible from its seed
    w1 = os.path.join(tmpdir, "wl1.jsonl")
    w2 = os.path.join(tmpdir, "wl2.jsonl")
    J.write_workload(w1, seed=7, requests=32)
    J.write_workload(w2, seed=7, requests=32)
    if open(w1, "rb").read() != open(w2, "rb").read():
        problems.append("workload journal not byte-reproducible")
    J.write_workload(w2, seed=8, requests=32)
    if open(w1, "rb").read() == open(w2, "rb").read():
        problems.append("workload journal ignores its seed")

    say(f"replay selfcheck: {len(rec.events)} recorded events, "
        f"{report['replayed']} replayed, "
        f"{report['divergences']} divergences, "
        f"{len(problems)} problems [{tmpdir}]")
    for p in problems:
        print(f"PROBLEM: {p}", file=sys.stderr)
    if problems:
        return 2
    shutil.rmtree(tmpdir, ignore_errors=True)   # kept when it failed
    return 0


def _parser():
    ap = argparse.ArgumentParser(
        description="replay a recorded fleet journal against a fresh "
                    "fleet of the port's engines and diff the outcome")
    ap.add_argument("--journal", default=None,
                    help="recorded journal to replay")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the replayed run's journal here "
                         "(meta cross-linked via replayed_from)")
    ap.add_argument("--kv-dtype", default="keep",
                    help="override the KV-cache dtype (e.g. fp8, "
                         "int8, none)")
    ap.add_argument("--weight-dtype", default="keep",
                    help="override the weight stream dtype (bf16, "
                         "int8, none)")
    ap.add_argument("--decode-block", default="keep",
                    help="override the decode block (int or "
                         "'adaptive')")
    ap.add_argument("--param-seed", type=int, default=0,
                    help="init_params seed for rebuilding the weights "
                         "(bench runs record under seed 0)")
    ap.add_argument("--max-steps", type=int, default=2_000_000)
    ap.add_argument("--expect-divergence", action="store_true",
                    help="config-A/B mode: report the delta, exit 0")
    ap.add_argument("--selfcheck", action="store_true",
                    help="record+replay a tiny fleet scenario and "
                         "verify the checker trips on tampering")
    ap.add_argument("--mesh", type=int, default=1,
                    help="replay every replica as a tensor-parallel "
                         "engine over this many spawned ranks")
    ap.add_argument("--collective-dtype", default="keep",
                    choices=("keep", "f32", "int8"),
                    help="override the collective wire format (with "
                         "--mesh)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = _parser()
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    args.device = str(dev)
    if args.mesh > 1:
        if args.selfcheck or not args.journal:
            ap.error("--mesh replays a --journal")
        from ..distributed.spawn import spawn
        return spawn(_mesh_replay, (args,), nprocs=args.mesh,
                     device=dev.type)[0]
    if args.collective_dtype not in ("keep", "f32"):
        ap.error("--collective-dtype int8 needs --mesh > 1")
    import torch
    with torch.no_grad():
        if args.selfcheck:
            return selfcheck(args)
        if not args.journal:
            ap.error("--journal is required (or --selfcheck)")
        return run_replay(args)


if __name__ == "__main__":
    sys.exit(main())
