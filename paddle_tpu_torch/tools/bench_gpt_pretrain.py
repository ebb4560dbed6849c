#!/usr/bin/env python3
"""GPT-2 small pretraining throughput and MFU on one NVIDIA GPU — port of
``tools/bench_gpt_pretrain.py``.

    python3 -m paddle_tpu_torch.tools.bench_gpt_pretrain [--batch B]
        [--seq S] [--k K] [--sweep] [--recompute | --no-recompute]
        [--ce-chunk N] [--fused-ce] [--bf16-residual | --f32-residual]
        [--numerics off|stats|watch]

Run from the repository root. Measures tokens a second for the full
pretraining step (O1 bf16 autocast, flash attention, AdamW 6e-4 with
weight decay 0.1, K steps a ``TrainStep.multi_step`` call) on one fixed
batch of random tokens (numpy ``RandomState(0)``): two warm calls, then
``reps`` timed calls, host clock ending in a read of the losses. MFU is
against the H100's dense bf16 peak, 989 TFLOP/s. Model FLOPs per token
are the reference's (``:33-35``): 6 x the matmul parameters
(``L * 12 d^2 + d V``, the tied head included) plus ``6 L s d`` for
causal attention. ``--fused-ce`` is the reference's flagship
configuration: the head and the cross entropy in the fused-CE kernels.

``--numerics stats|watch`` runs the step with ``TrainStep``'s numerics
pass (``stats``: the gradients' TensorHealth, one ``tensor_health``
launch a step; ``watch``: gradients, parameters and updates, three) and
then the same configuration with it off, and adds the reference's
``numerics``, ``tokens_per_sec_numerics_off`` and
``numerics_overhead_pct`` (``:165-177``).

Prints one JSON line (one a batch with ``--sweep``) with the card's
``nvidia-smi`` name and power limit. Not ported: there is no mesh (one
device), and the reference's ``vs_baseline`` (relative to a target set
for a TPU) is dropped. Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores


def model_flops_per_token(L, d, V, s):
    n_mat = L * 12 * d * d + d * V
    return 6 * n_mat + 6 * L * s * d


def run(batch: int, seq: int, k: int = 8, reps: int = 3,
        recompute: bool = False, ce_chunk: int = 0,
        fused_ce: bool = False, bf16_residual: bool = True,
        numerics: str = "off"):
    """``(tokens_per_s, mfu, last_loss)`` of the step, on the current CUDA
    device (``resolve_device``: raises without one)."""
    if numerics not in ("off", "stats", "watch"):
        raise ValueError(f"numerics must be off|stats|watch, got "
                         f"{numerics!r}")
    import torch

    from .. import amp
    from ..device import resolve_device
    from ..models.gpt import GPTForCausalLM, gpt2_small
    from ..optimizer import AdamW
    from ..parallel.api import TrainStep

    dev = resolve_device()
    cfg = gpt2_small(dropout=0.0, recompute=recompute, ce_chunk=ce_chunk,
                     fused_ce=fused_ce, bf16_residual=bf16_residual)
    model = GPTForCausalLM(cfg, device=dev, seed=0)

    def loss_fn(m, ids, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(ids, labels)

    step = TrainStep(model, loss_fn, AdamW(6e-4, weight_decay=0.1),
                     device=dev,
                     numerics=None if numerics == "off" else numerics)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (k, batch, seq)).astype(np.int64)
    idt = torch.as_tensor(ids, device=dev)
    lbt = torch.as_tensor(np.roll(ids, -1, axis=-1), device=dev)

    for _ in range(2):                      # allocator, cuBLAS handles
        losses = step.multi_step(idt, lbt)
    losses.cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        losses = step.multi_step(idt, lbt).cpu()
    dt = (time.perf_counter() - t0) / (reps * k)
    tok_per_s = batch * seq / dt
    fpt = model_flops_per_token(cfg.num_layers, cfg.hidden_size,
                                cfg.vocab_size, seq)
    return tok_per_s, tok_per_s * fpt / PEAK_FLOPS, float(losses[-1])


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--sweep", action="store_true",
                    help="batch-size sweep, one line per batch")
    ap.add_argument("--recompute", action="store_true", default=True,
                    help="recompute the MLP half of each block (default)")
    ap.add_argument("--no-recompute", dest="recompute",
                    action="store_false")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="sequence-chunked LM loss, tokens per chunk")
    ap.add_argument("--fused-ce", action="store_true",
                    help="the head and cross entropy in the fused-CE "
                         "kernels: no [tokens, vocab] logits")
    ap.add_argument("--bf16-residual", dest="bf16_residual",
                    action="store_true", default=True,
                    help="bf16 residual stream between blocks (default)")
    ap.add_argument("--f32-residual", dest="bf16_residual",
                    action="store_false")
    ap.add_argument("--k", type=int, default=8,
                    help="steps a multi_step call")
    ap.add_argument("--numerics", choices=("off", "stats", "watch"),
                    default="off",
                    help="the TensorHealth pass: 'stats' the gradients, "
                         "'watch' gradients, parameters and updates; the "
                         "line adds the overhead against an off run")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_gpt_pretrain: no CUDA device", file=sys.stderr)
        return 2
    kw = dict(k=args.k, recompute=args.recompute, ce_chunk=args.ce_chunk,
              fused_ce=args.fused_ce, bf16_residual=args.bf16_residual,
              numerics=args.numerics)
    gpu = smi()
    if args.sweep:
        for b in (16, 24, 32, 48) if args.recompute else (4, 8, 16, 24, 32):
            try:
                tok, mfu, loss = run(b, args.seq, **kw)
            except torch.cuda.OutOfMemoryError as e:   # ends the sweep
                print(json.dumps({"batch": b, "error": str(e)[:120]}),
                      flush=True)
                break
            print(json.dumps({"batch": b, "tokens_per_sec": round(tok),
                              "mfu": round(mfu, 4), "k": args.k,
                              "recompute": args.recompute,
                              "fused_ce": args.fused_ce, "gpu": gpu}),
                  flush=True)
            torch.cuda.empty_cache()
        return 0
    tok, mfu, loss = run(args.batch, args.seq, **kw)
    rec = record(args.batch, args.seq, tok, mfu, loss, **kw)
    if args.numerics != "off":
        # the same configuration with the pass off, measured second
        tok_off, _, _ = run(args.batch, args.seq, **dict(kw, numerics="off"))
        rec["numerics"] = args.numerics
        rec["tokens_per_sec_numerics_off"] = round(tok_off, 1)
        rec["numerics_overhead_pct"] = round(
            100.0 * (1.0 - tok / tok_off), 2) if tok_off > 0 \
            else None
    print(json.dumps(rec), flush=True)
    return 0


def record(batch, seq, tok, mfu, loss, *, k, recompute, ce_chunk, fused_ce,
           bf16_residual, numerics="off"):
    """The tool's JSON line for one run."""
    import torch
    return {"metric": "gpt2_small_pretrain_tokens_per_sec_per_chip",
            "value": round(tok, 1), "unit": "tokens/sec/chip",
            "mfu": round(mfu, 4), "mfu_peak_flops": PEAK_FLOPS,
            "k": k, "batch": batch, "seq": seq, "recompute": recompute,
            "ce_chunk": ce_chunk, "fused_ce": fused_ce,
            "bf16_residual": bf16_residual, "loss_last": loss,
            "device": torch.cuda.get_device_name(0), "gpu": smi()}


if __name__ == "__main__":
    sys.exit(main())
