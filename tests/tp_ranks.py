"""Rank functions of the tensor-parallel serving tests (a helper module,
not collected): ``distributed.spawn`` starts each rank in a fresh
process, which imports this module, so it imports no ``jax``.

:func:`serve` runs one rank of a rank set through a list of scenarios in
turn. Every rank builds each scenario's engine with the same arguments;
rank 0 drives it with the scenario's traffic and returns what it saw,
the other ranks follow until the leader closes the engine.
"""
import numpy as np
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.inference.tp import make_mesh
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.observability import MetricsRegistry

KW = dict(page_size=8, prefill_chunk=8, max_seq_len=64)


def mixed_stream(eng, n=8, seed=0, vocab=97):
    """The reference's shared replay (tests/test_tp_serving.py
    ``_mixed_stream``): mixed lengths and budgets, greedy and fixed-seed
    sampled requests alternating. Returns ``{uid: tokens}``."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        plen = int(rng.choice([3, 8, 17, 30]))
        nnew = int(rng.choice([2, 5, 9, 16]))
        eng.add_request(rng.randint(0, vocab, plen), nnew,
                        temperature=(0.8 if i % 2 else 0.0), seed=i)
    done = eng.run(max_steps=4000)
    eng.kv.verify()
    return {u: tuple(c.tokens) for u, c in done.items()}


def census_stream(eng, n=3):
    """The reference's census traffic (``decode_block=4``, 3 requests of
    9 tokens and 16 new)."""
    rng = np.random.RandomState(2)
    for i in range(n):
        eng.add_request(rng.randint(0, 97, 9), 16, seed=i)
    done = eng.run(max_steps=2000)
    return {u: tuple(c.tokens) for u, c in done.items()}


def preempt_drill(eng):
    """The reference's preempt/resume drill: a sampled low-priority
    request preempted by a high-priority arrival (``num_pages=9``)."""
    rng = np.random.default_rng(1)
    prompt = list(rng.integers(1, 97, size=12))
    u_low = eng.add_request(prompt, max_new_tokens=20, temperature=0.7,
                            seed=7, priority=0)
    for _ in range(64):
        eng.step()
        st = next((s for s in eng._slots.values() if s.uid == u_low), None)
        if st is not None and len(st.out) >= 2:
            break
    else:
        raise AssertionError("victim never reached steady decode")
    eng.add_request(list(rng.integers(1, 97, size=20)), max_new_tokens=16,
                    priority=5)
    done = eng.run(max_steps=2000)
    eng.kv.verify()
    return {u: tuple(c.tokens) for u, c in done.items()}, \
        done[u_low].preemptions


def solo_stream(eng):
    """The drill's victim alone (its reference stream)."""
    rng = np.random.default_rng(1)
    prompt = list(rng.integers(1, 97, size=12))
    u = eng.add_request(prompt, max_new_tokens=20, temperature=0.7, seed=7)
    return {u: tuple(eng.run(max_steps=2000)[u].tokens)}, 0


TRAFFIC = {"mixed": mixed_stream, "census": census_stream,
           "preempt": preempt_drill, "solo": solo_stream}


def record(eng, out, preemptions=None):
    """What the tests read of a driven engine."""
    led = eng.ledger
    return {
        "tokens": out, "preemptions": preemptions,
        "stats": {k: v for k, v in eng.stats.items()},
        "xla_costs": dict(eng.xla_costs),
        "coll_bytes_per_position": led.coll_bytes_per_position,
        "kv_bytes_per_token": led.kv_bytes_per_token,
        "kv_bytes_per_token_chip": led.kv_bytes_per_token_chip,
        "totals": led.totals(), "summary": led.summary(),
        "attribution": led.attribution_check(),
        "tenant_coll": {t: dict(tc["collective_bytes"])
                        for t, tc in led.tenant_totals().items()},
        "pool_shape": tuple(eng.kv.k[0].shape),
        "scale_shape": tuple(eng.kv.k_scale[0].shape)
        if eng.kv.quantized else None,
        "draft_pool_shape": tuple(eng.spec.dk[0].shape)
        if eng.spec is not None else None,
        "logits": {u: [t.numpy() for t in lg]
                   for u, lg in eng.logit_log.items()},
        "chips": eng.chips, "num_slots": eng.num_slots,
        "prefill_chunk": eng.prefill_chunk,
        "fingerprint": eng.config_fingerprint()}


def build(cfg, params, device, mesh, sc):
    kw = dict(KW, num_slots=3, registry=MetricsRegistry(),
              **sc.get("engine", {}))
    return ServingEngine(cfg, params, device=device, mesh=mesh, **kw)


def serve(info, cfg_kw, tree, scenarios):
    """One rank of a rank set: each scenario ``{"traffic": name,
    "engine": kwargs, "fail_follower_at": n}`` in turn. Returns rank 0's
    records (None on the other ranks)."""
    torch.set_num_threads(1)
    cfg = GPTConfig(**cfg_kw)
    params = params_from_numpy(tree, info.device)
    out = []
    for sc in scenarios:
        mesh = make_mesh(info.nprocs, device=info.device)
        eng = build(cfg, params, info.device, mesh, sc)
        if info.rank == 0:
            res = TRAFFIC[sc["traffic"]](eng, **sc.get("args", {}))
            toks, pre = res if isinstance(res, tuple) else (res, None)
            out.append(record(eng, toks, pre))
            eng.close()
        else:
            n = sc.get("fail_follower_at")
            if n is not None:
                _fail_after(eng, n)
            eng.follow()
            eng.close()
    return out if info.rank == 0 else None


def _fail_after(eng, n):
    """Make this follower's ``n``-th program run raise."""
    run, calls = eng._run_program, [0]

    def failing(key, host):
        calls[0] += 1
        if calls[0] >= n:
            raise RuntimeError(f"injected follower failure at run {n}")
        return run(key, host)
    eng._run_program = failing


def raise_on(info, bad_rank):
    """A rank function that fails on ``bad_rank``."""
    if info.rank == bad_rank:
        raise ValueError(f"boom on rank {info.rank}")
    return info.rank


def collectives(info):
    """Each ported collective once on this rank set; returns what this
    rank holds after each (numpy)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env
    r, n = info.rank, info.nprocs
    base = torch.arange(4, dtype=torch.float32) + 10 * r
    out = {"rank": env.get_rank(), "world": env.get_world_size(),
           "initialized": env.is_initialized(),
           "backend": C.get_backend()}
    out["all_reduce"] = C.all_reduce(base.clone()).numpy()
    out["all_reduce_max"] = C.all_reduce(base.clone(),
                                         op=C.ReduceOp.MAX).numpy()
    out["all_reduce_avg"] = C.all_reduce(base.clone(),
                                         op=C.ReduceOp.AVG).numpy()
    out["all_gather"] = [t.numpy() for t in C.all_gather(None, base)]
    out["all_gather_int8"] = [t.numpy() for t in C.all_gather(
        None, base.to(torch.int8))]
    objs = []
    C.all_gather_object(objs, {"rank": r})
    out["all_gather_object"] = objs
    out["broadcast"] = C.broadcast(base.clone(), src=1).numpy()
    out["reduce"] = C.reduce(base.clone(), dst=0).numpy()
    out["reduce_scatter"] = C.reduce_scatter(
        torch.zeros(2), [base[:2] + q for q in range(n)]).numpy()
    out["scatter"] = C.scatter(
        torch.zeros(3), [torch.full((3,), float(q)) for q in range(n)]
        if r == 0 else None, src=0).numpy()
    out["alltoall"] = [t.numpy() for t in C.alltoall(
        [torch.full((2,), float(10 * r + q)) for q in range(n)])]
    if r == 0:
        C.send(base, dst=1)
    elif r == 1:
        out["recv"] = C.recv(torch.zeros(4), src=0).numpy()
    C.barrier()
    out["mp_allreduce"] = C._mp_allreduce(base.clone()).numpy()
    out["c_identity"] = C._c_identity(base).numpy()
    out["c_concat"] = C._c_concat(base).numpy()
    out["c_split"] = C._c_split(torch.arange(2 * n, dtype=torch.float32)
                                ).numpy()
    sub = C.new_group([0, 1])
    out["sub_all_reduce"] = C.all_reduce(base.clone(), group=sub).numpy()
    return out


def capture_refused(info, cfg_kw, tree):
    """The error a captured engine on a gloo mesh raises on this rank."""
    cfg = GPTConfig(**cfg_kw)
    params = params_from_numpy(tree, info.device)
    try:
        ServingEngine(cfg, params, device=info.device,
                      mesh=make_mesh(info.nprocs, device=info.device),
                      **KW)
    except ValueError as e:
        return str(e)
    return None
