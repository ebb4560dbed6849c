#!/usr/bin/env python3
"""BERT-base fine-tune throughput on one NVIDIA GPU — port of
``tools/bench_bert.py``.

    python3 -m paddle_tpu_torch.tools.bench_bert [--batch B] [--pack N]
        [--pack-dense] [--reps R]

Run from the repository root. Measures sequences a second for the
fine-tune step of ``BertForSequenceClassification(bert_base(),
num_classes=2)`` in training mode (dropout 0.1), AdamW(3e-5, weight
decay 0.01), the forward under O1 bf16 autocast and the cross entropy
outside it, K=8 steps a ``TrainStep.multi_step`` call, on one fixed set
of K batches of random tokens (numpy ``RandomState(0)``): two warm calls,
then ``reps`` timed calls, host clock ending in a read of the losses.

- ``--pack 0`` (default): ``batch`` rows of 128 tokens, one label a row.
- ``--pack N``: ``batch / N`` rows of ``128 N`` tokens, N sequences a
  row, one label a sequence; the mask is ``SegmentIds(ids,
  start_positions, dense=--pack-dense)``: attention inside each sequence
  (the packed kernels, or the dense block-diagonal mask), positions
  restarting at each sequence, one CLS pool a sequence. Throughput is
  counted in sequences either way.

MFU counts the reference's FLOPs a sequence (``:127-129``: 6 x the
matmul parameters ``L * 12 d^2`` x 128 tokens, plus ``12 L s^2 d`` for
attention, forward and backward) against the H100's dense bf16 peak, 989
TFLOP/s. The reference's ``vs_baseline`` (against a figure for another
card) is dropped. Prints one JSON line with seq/s, step ms, MFU and peak
memory beside the card's ``nvidia-smi`` name and power limit. Needs a
CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
SEQ, K = 128, 8


def flops_per_seq(L=12, d=768, s=SEQ):
    """``tools/bench_bert.py:127-129``."""
    return 6 * (L * 12 * d * d) * s + 12 * L * s * s * d


def make_data(batch, pack, k=K, vocab=30522, seq=SEQ, seed=0):
    """``(ids [k, rows, row_len] int64, labels, segment ids int32 [rows,
    row_len] or None, start positions int64 [rows, pack] or None)`` as
    the reference draws them (``:68-108``), ``seq`` tokens a sequence."""
    rng = np.random.RandomState(seed)
    if pack > 1:
        if batch % pack:
            raise ValueError(f"batch {batch} is not a multiple of pack "
                             f"{pack}")
        rows, rlen = batch // pack, seq * pack
        ids = rng.randint(0, vocab, (k, rows, rlen)).astype(np.int64)
        y = rng.randint(0, 2, (k, rows, pack)).astype(np.int64)
        seg = np.repeat(np.arange(pack), seq)[None].repeat(rows, 0) \
            .astype(np.int32)
        starts = (np.arange(pack) * seq)[None].repeat(rows, 0) \
            .astype(np.int64)
        return ids, y, seg, starts
    ids = rng.randint(0, vocab, (k, batch, seq)).astype(np.int64)
    y = rng.randint(0, 2, (k, batch)).astype(np.int64)
    return ids, y, None, None


def make_loss_fn(mask=None, amp_level="O1"):
    """The reference's loss (``:58-61``, ``:98-103``): logits of the
    model under ``auto_cast(amp_level)`` (``None``: no autocast), with
    ``mask`` as the attention mask (a ``SegmentIds`` for packed rows:
    ``[rows, P, classes]`` logits, one label a sequence), then the mean
    cross entropy outside the autocast."""
    import contextlib

    from .. import amp
    from ..nn.functional import cross_entropy

    def loss_fn(m, ids, y):
        ctx = (amp.auto_cast(level=amp_level, dtype="bfloat16")
               if amp_level else contextlib.nullcontext())
        with ctx:
            logits = m(ids) if mask is None else m(ids, attention_mask=mask)
        return cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             y.reshape(-1))
    return loss_fn


def run(batch=64, pack=0, pack_dense=False, reps=3, device=None):
    """One measurement, on the current CUDA device unless ``device`` is
    given (``resolve_device``: raises without CUDA). Returns the record
    :func:`main` prints, with every step's loss under ``"losses"``."""
    import torch

    from ..device import resolve_device
    from ..kernels.packed_flash import SegmentIds
    from ..models.bert import BertForSequenceClassification, bert_base
    from ..optimizer import AdamW
    from ..parallel.api import TrainStep

    dev = resolve_device(device)
    cfg = bert_base()
    model = BertForSequenceClassification(cfg, num_classes=2, device=dev,
                                          seed=0)
    model.train()
    ids, y, seg, starts = make_data(batch, pack)
    mask = None
    if seg is not None:
        mask = SegmentIds(torch.as_tensor(seg, device=dev),
                          start_positions=torch.as_tensor(starts,
                                                          device=dev),
                          dense=bool(pack_dense))
    step = TrainStep(model, make_loss_fn(mask),
                     AdamW(learning_rate=3e-5, weight_decay=0.01),
                     device=dev)
    idt = torch.as_tensor(ids, device=dev)
    yt = torch.as_tensor(y, device=dev)

    losses = []
    for _ in range(2):                      # allocator, cuBLAS handles
        losses += step.multi_step(idt, yt).float().cpu().tolist()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        losses += step.multi_step(idt, yt).float().cpu().tolist()
    dt = (time.perf_counter() - t0) / (reps * K)
    seq_per_s = batch / dt
    rec = {"metric": "bert_base_finetune_seq_per_sec_per_chip",
           "value": seq_per_s, "unit": "seq/sec/chip",
           "batch_per_chip": batch, "step_ms": dt * 1e3,
           "mfu": seq_per_s * flops_per_seq() / PEAK_FLOPS,
           "mfu_peak_flops": PEAK_FLOPS, "pack": pack,
           "pack_dense": bool(pack_dense), "k": K, "reps": reps,
           "loss_last": losses[-1], "losses": losses}
    if dev.type == "cuda":
        rec.update(peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                   device=torch.cuda.get_device_name(dev), gpu=smi())
    return rec


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64,
                    help="sequences a step")
    ap.add_argument("--pack", type=int, default=0,
                    help="pack N 128-token sequences a row (0: unpacked)")
    ap.add_argument("--pack-dense", action="store_true",
                    help="with --pack: the dense block-diagonal mask "
                         "instead of the packed kernels")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed multi_step calls of K=8 steps")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_bert: no CUDA device", file=sys.stderr)
        return 2
    rec = run(args.batch, args.pack, args.pack_dense, args.reps)
    rec.pop("losses")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
