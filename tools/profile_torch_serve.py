#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on one NVIDIA GPU.

    python3 tools/profile_torch_serve.py [--kv-dtype bf16|int8|fp8]
        [--weight-dtype bf16|int8|none] [--mixed] [--eager] [--out PATH]

Serves the same 16 requests as ``chip_smoke.py``'s serve phase (GPT-2
small, random weights from seed 0; bf16 weights and KV unless the flags
say otherwise, as in its ``serve_int8``/``serve_fp8``/``serve_w8``
phases) on the captured engine (CUDA graphs; ``--mixed``: the mixed-step
engine; ``--eager``: ``_capture=False``, the programs dispatched from
Python) once to warm up, once timed, then again under ``torch.profiler``
(CPU and CUDA activities), each on a fresh engine built (and captured)
before its run starts, and prints one JSON line:

- ``wall_s`` — the profiled run on the host clock, and
  ``wall_unprofiled_s`` the same run without the profiler;
- ``device_busy_s`` / ``device_idle_frac`` — the union of the CUDA
  kernel intervals over the run, and the share of the run with no
  kernel executing (``device_idle_frac_unprofiled`` against the
  unprofiled wall time, since the profiler slows the host);
- ``by_class`` — device seconds and kernel counts for the ragged
  paged-attention kernel, matrix products, and everything else;
- ``kernels_per_forward`` — CUDA kernels per model forward pass
  (prefill chunk, decode step, or mixed step). The profiler records the
  kernels a graph replay runs one by one, as it records eager ones;
  ``graph_launches_traced`` counts the ``cudaGraphLaunch`` calls it saw.
  Should a build record a graph's launch but not its kernels, the tool
  fails (fewer kernels than replays) rather than report the eager
  kernels alone;
- ``replay_ms`` — the captured engine: the device time of one replay of
  the decode step, the prefill chunk and each fused block (or the mixed
  step), CUDA events over 20 replays at a full state (every slot live,
  512 positions of context; the mixed step with half the slots on a
  prefill chunk), the median of 5 such loops with its [min, max];
- ``spans`` — the eager engine over a quantized pool: the device
  seconds and kernels of the dequantize-insert-requantize writes
  (``kv_requant_write``) and, with int8 weights, of the weight widening
  (``weight_dequant``), each with its share of the busy time and its
  kernels per forward. The tool wraps ``serving._requant_write`` and
  ``serving.dequantize_params`` in ``torch.profiler.record_function``
  for the profiled run only; inside a graph no Python runs, so the
  captured engine has no spans (its capture ran before the profile);
- the top kernels by device time (all 25 written to ``--out`` when
  given).

Needs a CUDA device; exits non-zero without one.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name):
    low = name.lower()
    if "ragged_paged_attention" in low:
        return "paged_attention"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet", "sm90_", "matmul", "splitkreduce")):
        return "matmul"
    return "other"


def full_state(eng, ctx=512):
    """Host inputs of a full dispatch: every slot live at ``ctx``
    positions on pages of its own. Keys as ``eng._progs``."""
    import numpy as np
    S, MP, PS, C = (eng.num_slots, eng.pages_per_slot, eng.page_size,
                    eng.prefill_chunk)
    bt = (1 + np.arange(S * MP, dtype=np.int32).reshape(S, MP)) \
        % eng.kv.num_pages
    lengths = np.full(S, ctx, np.int64)
    tokens = np.arange(S, dtype=np.int64)
    active = np.ones(S, bool)
    temps = np.zeros(S, np.float32)
    budget = (np.full(S, -1, np.int64), np.full(S, 1 << 20, np.int64))
    half = np.arange(S) < S // 2
    kind = np.where(half, 2, 1).astype(np.int32)
    q_lens = np.where(half, C, 1).astype(np.int32)
    start = np.full(S, ctx - 1, np.int64)
    out = {"prefill": (bt[0], np.int64(ctx), np.zeros(C, np.int64),
                       np.int64(C - 1)),
           "mixed": (bt, kind, q_lens, start, np.zeros((S, C), np.int64),
                     np.full(S, C - 1, np.int64), ~half, temps, *budget)}
    for k in eng.decode_block_buckets:
        out[k] = (bt, lengths, tokens, active, temps) + (budget if k > 1
                                                         else ())
    return out


def replay_ms(eng, reps=20):
    """Device ms a replay of each captured program at ``full_state``:
    CUDA events around ``reps`` replays, the median of 5 loops with its
    [min, max]. The engine is done serving: these replays write pages no
    request holds."""
    import torch
    res = {}
    for key, host in full_state(eng).items():
        prog = eng._progs.get(key)
        if prog is None:
            continue
        prog.replay(*host)
        times = []
        for _ in range(5):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                prog.replay(*host)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        times.sort()
        res[str(key)] = {"ms": times[2], "ms_spread": [times[0], times[-1]]}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=("bf16", "int8", "fp8"))
    ap.add_argument("--weight-dtype", default="bf16",
                    choices=("bf16", "int8", "none"))
    ap.add_argument("--mixed", action="store_true",
                    help="the mixed-step engine (mixed_step=True)")
    ap.add_argument("--eager", action="store_true",
                    help="dispatch the programs eagerly (_capture=False)")
    ap.add_argument("--out", default=None,
                    help="also write the full kernel table here (JSON)")
    args = ap.parse_args()
    weight_dtype = None if args.weight_dtype == "none" else args.weight_dtype
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import serve_traffic, smi
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.models.gpt import gpt2_small, init_params

    _build.build_all()
    cfg = gpt2_small()
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    kw = dict(device=dev, num_slots=8, page_size=16, prefill_chunk=32,
              max_seq_len=1024, weight_dtype=weight_dtype,
              kv_dtype=args.kv_dtype, mixed_step=args.mixed,
              _capture=not args.eager)

    def engine():
        """A fresh engine with the requests queued; its capture (warm-up
        calls included) ends before the profiled or timed run starts."""
        eng = ServingEngine(cfg, params, **kw)
        for r in serve_traffic(cfg.vocab_size):
            eng.add_request(**r)
        torch.cuda.synchronize()
        return eng

    def serve(eng):
        t0 = time.perf_counter()
        eng.run(max_steps=20000)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def spanned(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    serve(engine())                           # warm-up
    wall_plain = serve(engine())              # unprofiled reference
    eng = engine()
    span_attrs = {"kv_requant_write": "_requant_write",
                  "weight_dequant": "dequantize_params"}
    plain = {attr: getattr(serving, attr) for attr in span_attrs.values()}
    for name, attr in span_attrs.items():
        setattr(serving, attr, spanned(name, plain[attr]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = serve(eng)
    finally:
        for attr, fn in plain.items():
            setattr(serving, attr, fn)
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in span_attrs]
    ivals = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in ivals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_class, by_name = {}, {}
    for e in kern:
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        c = by_class.setdefault(kernel_class(e.name), {"s": 0.0, "n": 0})
        c["s"] += dur
        c["n"] += 1
        k = by_name.setdefault(e.name, {"s": 0.0, "n": 0})
        k["s"] += dur
        k["n"] += 1
    st = eng.stats
    forwards = (st["mixed_steps"] if args.mixed
                else st["prefill_chunks"] + st["decode_steps"])

    def n_kernels(e):
        return len(e.kernels) + sum(n_kernels(c) for c in e.cpu_children)

    span_res = {}
    for e in events:
        if e.name in span_attrs and e.device_type == DeviceType.CPU:
            r = span_res.setdefault(e.name, {"s": 0.0, "calls": 0,
                                             "kernels": 0})
            r["s"] += e.device_time_total * 1e-6
            r["calls"] += 1
            r["kernels"] += n_kernels(e)
    for r in span_res.values():
        r["share_of_busy"] = r["s"] / (busy_us * 1e-6) if kern else None
        r["kernels_per_forward"] = r["kernels"] / forwards
    graph_launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                         and "cudaGraphLaunch" in e.name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["s"])[:25]
    res = {"tool": "profile_torch_serve", "gpu": smi(),
           "engine": "eager" if args.eager else "captured",
           "mixed_step": args.mixed,
           "kv_dtype": args.kv_dtype, "weight_dtype": args.weight_dtype,
           "wall_s": wall, "tokens": st["tokens_emitted"],
           "forwards": forwards, "dispatches": st["dispatches"],
           "graph_captures": st["graph_captures"],
           "graph_replays": st["graph_replays"],
           "graph_launches_traced": graph_launches,
           "device_kernels": len(kern),
           "device_busy_s": busy_us * 1e-6,
           "device_idle_frac": (1.0 - busy_us * 1e-6 / wall) if kern
           else None,
           # the profiler slows the host; against the unprofiled run
           "wall_unprofiled_s": wall_plain,
           "tokens_per_s_unprofiled": st["tokens_emitted"] / wall_plain,
           "device_idle_frac_unprofiled": (
               1.0 - busy_us * 1e-6 / wall_plain) if kern else None,
           "kernels_per_forward": len(kern) / forwards,
           "by_class": by_class, "spans": span_res,
           "top": [{"name": n[:120], **v} for n, v in top[:8]]}
    if not args.eager:
        res["replay_ms"] = replay_ms(eng)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(res, top=[{"name": n, **v} for n, v in top]),
                      f, indent=1)
    print(json.dumps(res), flush=True)
    if not kern:
        print("profile_torch_serve: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    if graph_launches and len(kern) < st["graph_replays"]:
        print("profile_torch_serve: fewer kernels than graph replays: the "
              "profiler did not record the kernels inside the graphs",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
