#!/usr/bin/env python3
"""Long-context attention: causal forward + backward of one GPT-2-small
attention layer across sequence lengths, the port's flash kernels against
naive softmax attention — port of ``tools/bench_longctx.py``.

    python3 -m paddle_tpu_torch.tools.bench_longctx [--dtype float32|bfloat16]
        [--device cuda|cpu]

Run from the repository root. The reference's geometry and loss: B = 1,
H = 12, D = 64; T = 2048, 4096, 8192, 16384 and 32768; the gradients of
``sum(out ** 2)`` in q, k and v through
``kernels.flash_attention.flash_attention(causal=True)`` and, up to T =
8192 (its T x T scores), through :func:`naive` (scores, a ``-1e30``
causal mask, softmax, the product with v). Inputs are standard normal
from ``np.random.RandomState(0)``, float32 by default as the reference
feeds (the flash kernels' CUDA-core design); ``--dtype bfloat16`` runs
the wgmma/TMA design. One warm call, then 20 calls between CUDA events
(the host clock on the CPU).

One JSON line a run, the reference's: ``attention_fwd_bwd_flash`` /
``_naive`` with ``seq_len``, ``value`` (ms a call), ``unit`` and
``tflops`` (its count, 3.5 x 2 B H T^2 D), and
``flash_speedup_vs_naive``; each line also names ``dtype`` and the
``device``. A run that does not fit the card prints ``value: null`` with
the error's name (``torch.cuda.OutOfMemoryError`` only; anything else
raises). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

B, H, D = 1, 12, 64           # GPT-2 small's attention geometry
LENGTHS = (2048, 4096, 8192, 16384, 32768)
NAIVE_MAX = 8192              # naive attention's T x T scores beyond
ITERS = 20


def naive(q, k, v):
    """Plain causal softmax attention over ``[B, T, H, D]``."""
    import torch
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / float(np.sqrt(q.shape[-1]))
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def flash(q, k, v):
    from ..kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=True)


def inputs(T, dtype, device, rng):
    """q, k, v ``[B, T, H, D]``, standard normal, requiring grad."""
    import torch
    return [torch.tensor(rng.randn(B, T, H, D).astype(np.float32),
                         device=device).to(dtype).requires_grad_()
            for _ in range(3)]


def grads(fn, q, k, v):
    """The gradients of ``sum(fn(q, k, v) ** 2)`` in q, k and v."""
    import torch
    out = fn(q, k, v)
    return torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))


def _time(fn, q, k, v, iters):
    import torch
    if q.device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            grads(fn, q, k, v)
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        grads(fn, q, k, v)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench_one(fn, tag, T, dtype, device, rng, iters=ITERS, emit=print):
    """One line: the warm call, then ``iters`` timed calls; ms or
    None."""
    import torch
    rec = {"metric": f"attention_fwd_bwd_{tag}", "seq_len": T,
           "dtype": str(dtype).replace("torch.", ""),
           "device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu"}
    try:
        q, k, v = inputs(T, dtype, device, rng)
        grads(fn, q, k, v)
        ms = _time(fn, q, k, v, iters)
    except torch.cuda.OutOfMemoryError as e:
        rec.update(value=None, error=type(e).__name__)
        emit(json.dumps(rec))
        return None
    finally:
        q = k = v = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    flops = 3.5 * 2.0 * B * H * T * T * D
    rec.update(value=ms, unit="ms/step", tflops=flops / (ms * 1e-3) / 1e12)
    emit(json.dumps(rec))
    return ms


def run(lengths=LENGTHS, dtype="float32", device=None, iters=ITERS,
        emit=print):
    """Every length's flash line, and naive's and the speedup up to
    ``NAIVE_MAX``."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    rng = np.random.RandomState(0)
    for T in lengths:
        t_flash = bench_one(flash, "flash", T, dt, dev, rng, iters, emit)
        if T <= NAIVE_MAX:
            t_naive = bench_one(naive, "naive", T, dt, dev, rng, iters,
                                emit)
            if t_flash and t_naive:
                emit(json.dumps({"metric": "flash_speedup_vs_naive",
                                 "seq_len": T, "value": t_naive / t_flash,
                                 "unit": "x",
                                 "dtype": str(dt).replace("torch.", "")}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(dtype=args.dtype, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
