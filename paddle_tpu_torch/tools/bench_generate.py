#!/usr/bin/env python3
"""GPT-2 decode throughput through dense KV-cache generation — port of
``tools/bench_generate.py``.

    python3 -m paddle_tpu_torch.tools.bench_generate [--batch 8]
        [--prompt-len 32] [--new-tokens 224] [--reps 3]
        [--model tiny|small|medium] [--device cuda|cpu]

Run from the repository root. The reference's configuration and loop:
GPT-2 small with ``vocab_size=50304`` and random weights (numpy seed 0),
prompts of uniform ids from ``np.random.RandomState(0)``,
``GPTForCausalLM.generate`` at bf16 weights with ``temperature=1.0`` and
``top_k=40``: one warm call with the exact timed arguments (it captures
the decode step's CUDA graph), then ``--reps`` timed calls (seeds 0, 1,
...), each ending in a host read of the tokens, host clock.

Prints one JSON line with the reference's keys: ``metric``, ``value``
(generated tokens a second on this one card: ``batch x new_tokens`` over
a call's seconds), ``unit``, ``batch``, ``seq`` and ``ms_per_token_step``
(a call's ms over ``prompt_len + new_tokens - 1``, the reference's
count). ``approx_topk`` is false: the port's top-k is exact (the
reference's line ran ``approx_max_k``; its ``approx_topk_recall`` is
left out). ``device`` and ``power_limit`` name the card. Runs on the card
unless ``--device cpu``; ``--model tiny`` sizes its position table to
the prompt and the new tokens.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

VOCAB = 50304


def card():
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


def build_model(name, device, total):
    """The bench's model: random weights from numpy seed 0, eval mode."""
    from ..models.gpt import (GPTForCausalLM, gpt2_medium, gpt2_small,
                              gpt2_tiny)
    if name == "tiny":
        cfg = gpt2_tiny(max_position_embeddings=max(128, total))
    else:
        cfg = {"small": gpt2_small, "medium": gpt2_medium}[name](
            vocab_size=VOCAB)
    model = GPTForCausalLM(cfg, device=device, seed=0)
    model.eval()
    return model


def run(model, batch=8, prompt_len=32, new_tokens=224, reps=3,
        dtype="bfloat16", top_k=40, temperature=1.0, **gen_kw):
    """The reference's warm call and ``reps`` timed calls on ``model``;
    returns ``(record, last tokens)``."""
    import torch
    vocab = model.gpt.cfg.vocab_size
    dev = model.gpt.wte.weight.device
    ids = np.random.RandomState(0).randint(0, vocab, (batch, prompt_len))

    def call(seed):
        out = model.generate(ids, max_new_tokens=new_tokens,
                             temperature=temperature, top_k=top_k,
                             seed=seed, dtype=dtype, **gen_kw)
        return out.cpu().numpy()

    call(99)
    t0 = time.perf_counter()
    for seed in range(reps):
        toks = call(seed)
    dt = (time.perf_counter() - t0) / reps
    name = {768: "small", 1024: "medium"}.get(model.gpt.cfg.hidden_size,
                                              "tiny")
    smi = card() if dev.type == "cuda" else None
    rec = {"metric": f"gpt2_{name}_decode_tokens_per_sec_per_chip",
           "value": batch * new_tokens / dt, "unit": "tokens/sec/chip",
           "batch": batch, "seq": prompt_len + new_tokens,
           "approx_topk": False,
           "ms_per_token_step": dt / (prompt_len + new_tokens - 1) * 1e3,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu",
           "power_limit": smi.split(",")[-1].strip() if smi else None}
    return rec, toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=224)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model", choices=("tiny", "small", "medium"),
                    default="small")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    import torch

    from ..device import resolve_device
    dev = resolve_device(args.device)
    with torch.no_grad():
        model = build_model(args.model, dev,
                            args.prompt_len + args.new_tokens)
        rec, _ = run(model, args.batch, args.prompt_len, args.new_tokens,
                     args.reps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
