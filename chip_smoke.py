#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and
``nvcc``. Phases, one JSON line each; any failure raises and the script
exits non-zero:

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch
   and CUDA versions.
2. ``build``   — compiles every CUDA source of the port with ``nvcc``
   (one process per source, all at once) and reports the seconds.
3. ``kernels`` — each kernel against its plain PyTorch version on the
   card at GPT-2 small's attention shapes (12 heads of 64, pages of 16,
   8 slots, 64 pages a slot): a mixed case (decode row, a full prefill
   row of 32, a k+1-like row, an idle slot, extents across page
   boundaries), the decode shape and the prefill-chunk shape of the
   serving engine. float32 within 1e-4 and bfloat16 within 2e-2 on live
   rows. Times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` over the same K/V gathered
   contiguous (a yardstick the port never calls), cycling through one
   pool pair per layer as the engine does, beside the bound
   max(bytes / 3.35 TB/s, FLOPs / peak).
4. ``serve``   — ``ServingEngine(gpt2_small(), device="cuda")`` with
   bf16 weights and KV, random weights from seed 0, serving 16
   requests (prompts of 32-480 tokens, 32-128 new tokens, 12 greedy and
   4 at temperature 0.8, two sharing a 64-token prefix). Every request
   must finish, the page pool must verify, and the kernel's launch
   count must equal layers x forward passes.
5. ``parity``  — the same model in float32, four greedy requests, with
   the kernel and with the plain version: per-step logits within 1e-3,
   tokens identical up to the first step whose plain top-2 margin is
   below that tolerance.

Then the kernel summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

F32_TOL, BF16_TOL = 1e-4, 2e-2
PARITY_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12              # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,        # non-tensor-core float32
              "bfloat16": 989e12}      # dense bf16 tensor cores
PS, NH, HD, S_SLOTS, MP, CHUNK = 16, 12, 64, 8, 64, 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters):
    import torch
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# -- kernels ------------------------------------------------------------------

def attention_case(kv_lens, q_lens, QB, dtype, rng, layers):
    """Inputs for one attention call shape: ``layers`` pool pairs (one
    per layer, so timed launches find K/V cold as the engine does)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    S = len(kv_lens)
    NP = S * MP + 1
    q = torch.tensor(rng.standard_normal((S, QB, NH, HD), np.float32),
                     device=dev).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    pools = [tuple(torch.randn(NP, PS, NH, HD, device=dev,
                               generator=gen).to(dtype) for _ in range(2))
             for _ in range(layers)]
    bt = torch.tensor(rng.permutation(np.arange(1, NP))[:S * MP]
                      .reshape(S, MP).astype(np.int32), device=dev)
    return dict(q=q, pools=pools, bt=bt,
                kv_lens=torch.tensor(kv_lens, dtype=torch.int32,
                                     device=dev),
                q_lens=torch.tensor(q_lens, dtype=torch.int32, device=dev))


def case_bound(c):
    """Least time for one call: each input read once (q, the K/V rows
    below each slot's extent, tables, lengths), the output written once,
    and the FLOPs the rows' causal limits need, at the card's peaks."""
    import numpy as np
    q = c["q"]
    S, QB = q.shape[0], q.shape[1]
    item = q.element_size()
    kv_lens = np.minimum(c["kv_lens"].cpu().numpy(), MP * PS)
    q_lens = c["q_lens"].cpu().numpy()
    nbytes = 2 * q.numel() * item                       # q in, out
    nbytes += 2 * int(kv_lens.sum()) * NH * HD * item   # K and V rows
    nbytes += c["bt"].numel() * 4 + 2 * S * 4
    j = np.arange(QB)[None, :]
    L, n = kv_lens[:, None], q_lens[:, None]
    lim = np.where(j < n, np.minimum(L, L - n + 1 + j), L)
    lim = np.where(L > 0, np.maximum(lim, 0), 0)
    flops = 4 * int(lim.sum()) * NH * HD                # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def sdpa_inputs(c):
    """The same K/V gathered contiguous per slot, with the rows' causal
    limits as a boolean mask, for the library yardstick."""
    import torch
    from paddle_tpu_torch.kernels.paged_attention import _limits
    q, bt = c["q"], c["bt"].long()
    S, QB = q.shape[0], q.shape[1]
    T = MP * PS
    lim = _limits(c["kv_lens"], c["q_lens"], QB, T)
    Tm = max(int(c["kv_lens"].max()), 1)
    mask = (torch.arange(Tm, device=q.device)[None, None, :]
            < lim[:, :, None])[:, None]                 # [S, 1, QB, Tm]
    kvs = []
    for kp, vp in c["pools"]:
        k = kp[bt].reshape(S, T, NH, HD)[:, :Tm].transpose(1, 2)
        v = vp[bt].reshape(S, T, NH, HD)[:, :Tm].transpose(1, 2)
        kvs.append((k.contiguous(), v.contiguous()))
    return q.transpose(1, 2).contiguous(), kvs, mask


def run_kernel_phase():
    import numpy as np
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    layers = 12
    shapes = {
        # decode row, full prefill row, k+1 row, idle slot, extents that
        # cross page boundaries
        "mixed": ([27, 32, 300, 0, 517, 1024, 49, 100],
                  [1, 32, 5, 1, 1, 32, 17, 1], CHUNK),
        # the engine's decode step: 8 slots of one query each
        "decode": ([47, 133, 260, 301, 388, 455, 512, 590],
                   [1] * S_SLOTS, 1),
        # the engine's prefill chunk: one slot, q_len = kv tail of 32
        "prefill": ([288], [CHUNK], CHUNK),
    }
    results = {}
    for name, (kv_lens, q_lens, QB) in shapes.items():
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            c = attention_case(kv_lens, q_lens, QB, dtype, rng, layers)
            kp, vp = c["pools"][0]
            args = (c["q"], kp, vp, c["bt"], c["kv_lens"], c["q_lens"])
            out = pa.ragged_paged_attention(*args)
            torch.cuda.synchronize()
            ref = pa.ragged_paged_attention_ref(*args)
            live = (torch.arange(QB, device=out.device)[None]
                    < c["q_lens"][:, None])[:, :, None, None]
            err = float(((out.float() - ref.float()).abs() * live).max())
            if not (err <= tol and bool(torch.isfinite(out).all())):
                raise AssertionError(
                    f"kernel vs plain ({name}, {dtype}): max_abs_err "
                    f"{err} > {tol} or non-finite output")
            idle = c["kv_lens"] == 0
            if bool(idle.any()) and bool(out[idle].abs().max() != 0):
                raise AssertionError(f"{name}: idle slot not zero")
            rec = {"max_abs_err": err}
            if dtype == torch.bfloat16:   # the serving dtype: timed
                P = c["pools"]

                def kern(i, c=c, P=P):
                    kp, vp = P[i % layers]
                    pa.ragged_paged_attention(c["q"], kp, vp, c["bt"],
                                              c["kv_lens"], c["q_lens"])

                def plain(i, c=c, P=P):
                    kp, vp = P[i % layers]
                    pa.ragged_paged_attention_ref(c["q"], kp, vp, c["bt"],
                                                  c["kv_lens"],
                                                  c["q_lens"])
                qs, kvs, mask = sdpa_inputs(c)

                def lib(i, qs=qs, kvs=kvs, mask=mask):
                    k, v = kvs[i % layers]
                    F.scaled_dot_product_attention(qs, k, v,
                                                   attn_mask=mask)
                rec["ms"] = cuda_ms(kern, 120)
                rec["plain_ms"] = cuda_ms(plain, 24)
                rec["library_ms"] = cuda_ms(lib, 120)
                rec["bound_ms"], rec["bound_by"] = case_bound(c)
                del qs, kvs, mask
            results.setdefault(name, {})[str(dtype).replace(
                "torch.", "")] = rec
            del c, out, ref
    torch.cuda.empty_cache()
    return results


# -- the serving engine -------------------------------------------------------

def serve_traffic(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 64)
    reqs = []
    for i in range(16):
        plen = int(rng.integers(32, 481))
        prompt = rng.integers(0, vocab, plen)
        if i in (5, 11):          # two requests share a 64-token prefix
            prompt = np.concatenate([shared, prompt[:max(plen - 64, 1)]])
        reqs.append(dict(prompt=prompt,
                         max_new_tokens=int(rng.integers(32, 129)),
                         temperature=0.8 if i % 4 == 3 else 0.0,
                         seed=1000 + i))
    return reqs


def run_serve_phase():
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.gpt import gpt2_small, init_params

    cfg = gpt2_small()
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    kw = dict(device=dev, num_slots=8, page_size=PS, prefill_chunk=CHUNK,
              max_seq_len=1024, weight_dtype="bf16", kv_dtype="bf16")
    # warm-up on a throwaway engine: cuBLAS handles, allocator pools
    warm = ServingEngine(cfg, params, **dict(kw, num_slots=1,
                                             max_seq_len=64))
    warm.add_request(np.arange(40) % cfg.vocab_size, 8)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, **kw)
    reqs = serve_traffic(cfg.vocab_size)
    uids = [eng.add_request(**r) for r in reqs]
    pa.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(max_steps=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    if sorted(done) != sorted(uids):
        raise AssertionError("not every request completed")
    for u, r in zip(uids, reqs):
        c = done[u]
        if c.finish_reason not in ("length", "eos"):
            raise AssertionError(f"request {u} finished {c.finish_reason}")
        if c.finish_reason == "length" and \
                len(c.tokens) != r["max_new_tokens"]:
            raise AssertionError(f"request {u}: {len(c.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"request {u}: token out of range")
    eng.kv.verify()
    st = eng.stats
    forwards = st["prefill_chunks"] + st["decode_steps"]
    if not (launches > 0 and launches == cfg.num_layers * forwards):
        raise AssertionError(
            f"kernel launches {launches} != {cfg.num_layers} layers x "
            f"{forwards} forward passes")
    if st["prefix_hits"] < 64 // PS:
        raise AssertionError("the shared prefix was not served from cache")
    ttft = np.array([done[u].ttft_s for u in uids])
    return {"phase": "serve", "requests": len(uids),
            "tokens_generated": st["tokens_emitted"],
            "wall_s": wall,
            "tokens_per_s": st["tokens_emitted"] / wall,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "dispatches": st["dispatches"],
            "prefill_chunks": st["prefill_chunks"],
            "decode_steps": st["decode_steps"],
            "decode_blocks": st["decode_blocks"],
            "fused_blocks": st["fused_blocks"],
            "prefix_hits": st["prefix_hits"],
            "cow_copies": st["cow_copies"],
            "kernel_launches": launches,
            "launches_per_forward": launches / forwards,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "kv_verify": True, "gpu": smi()}, launches


def run_parity_phase():
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import gpt2_small, init_params

    cfg = gpt2_small()
    dev = torch.device("cuda")
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)), 32)
            for n in rng.integers(40, 201, 4)]
    runs = {}
    for attention in ("auto", "torch"):
        eng = ServingEngine(cfg, params, device=dev, attention=attention,
                            num_slots=4, page_size=PS, prefill_chunk=CHUNK,
                            max_seq_len=1024, record_logits=True)
        uids = [eng.add_request(p, n) for p, n in reqs]
        done = eng.run(max_steps=5000)
        runs[attention] = [(done[u].tokens, eng.logit_log[u]) for u in uids]
        del eng
        torch.cuda.empty_cache()
    max_err, first_tie, steps = 0.0, None, 0
    for (tk, lk), (tp, lp) in zip(runs["auto"], runs["torch"]):
        for i, (a, b) in enumerate(zip(lk, lp)):
            steps += 1
            max_err = max(max_err, float((a - b).abs().max()))
            top2 = torch.topk(b, 2).values
            if float(top2[0] - top2[1]) < PARITY_TOL:
                first_tie = i if first_tie is None else min(first_tie, i)
                break                  # later steps may diverge legally
            if tk[i] != tp[i]:
                raise AssertionError(f"greedy token {i} differs: "
                                     f"{tk[i]} vs {tp[i]}")
    if not max_err <= PARITY_TOL:
        raise AssertionError(f"logits differ by {max_err} > {PARITY_TOL}")
    return {"phase": "parity", "requests": len(reqs),
            "steps_compared": steps, "max_logit_abs_err": max_err,
            "tol": PARITY_TOL, "first_step_top2_below_tol": first_tie,
            "tokens_identical": all(a[0] == b[0] for a, b in
                                    zip(runs["auto"], runs["torch"]))}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: paddle_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from paddle_tpu_torch.kernels import _build

    gpu = smi()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    log = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {n: {"nvcc_s": v["seconds"],
                          "ptxas": [ln.strip() for ln in
                                    v["ptxas"].splitlines()
                                    if "registers" in ln]}
                      for n, v in log.items()}})
    kres = run_kernel_phase()
    emit({"phase": "kernels", "kernels": ["ragged_paged_attention"],
          "ragged_paged_attention": kres, "gpu": gpu})
    serve, launches = run_serve_phase()
    emit(serve)
    emit(run_parity_phase())
    dec = kres["decode"]["bfloat16"]
    emit({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/kernels/paged_attention_pallas.py:37",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for case in kres.values()
                           for r in case.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode: S=8 QB=1 NH=12 HD=64 PS=16 MP=64 bf16",
        "cases": {n: kres[n]["bfloat16"] for n in ("mixed", "prefill")}}]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
