#!/usr/bin/env python3
"""Where the PyTorch port's training-step time goes on one NVIDIA GPU.

    python3 -m paddle_tpu_torch.tools.profile_train [--steps N] [--out PATH]
        [--fused-ce [--share-p] | --bert [--pack P] | --resnet
        [--data-format NHWC]]

Run from the repository root. Builds the training step of
``chip_smoke.py``'s train phase (GPT-2
small, random weights from seed 0, AdamW with the global-norm clip, O1
bf16 autocast, MLP recompute, batch 16 x seq 1024, one fixed batch; with
``--fused-ce`` its ``train_fused_ce`` phase, the head and CE in the
fused-CE kernels, and with ``--share-p`` too its ``train_fused_ce_sharep``
phase (``kernels.fused_ce._SHARE_P`` set: the shared-dl dh/dw pair); with
``--bert`` the BERT-base fine-tune step of
``tools/bench_bert.py``, 64 sequences of 128, packed ``--pack`` to a row
through the packed flash kernels when ``--pack`` is above 1; with
``--resnet`` the ResNet-50 step of ``bench_resnet`` (``bench.py``'s: O1
bf16, Momentum 0.1, batches of 128 images of 224 x 224, 8 of them made on
the card), in ``--data-format``),
runs ``TrainStep.multi_step`` of 8 steps to warm up, ``--steps`` steps
timed without the profiler, and ``--steps`` steps under
``torch.profiler`` (CPU and CUDA activities), then prints one JSON line:

- ``step_ms`` — unprofiled, host clock ending in a synchronize;
- ``device_busy_ms_per_step`` / ``device_idle_frac`` — the union of the
  CUDA kernel intervals in the profiled window, and the share of the
  window with no kernel executing (``device_idle_frac_unprofiled``
  against the unprofiled step time, since the profiler slows the host);
- ``by_class`` — device milliseconds per step and kernel counts for the
  three flash-attention kernels, the three fused-CE kernels, the three
  packed flash kernels, convolution (cuDNN's forward, data- and
  weight-gradient kernels and its layout transposes), matrix products,
  batch norm, pooling, the optimizer (``multi_tensor_apply``: AdamW's or
  Momentum's update), softmax/cross-entropy, elementwise kernels (casts,
  ReLU and its gradient, the residual adds), and everything else;
- ``kernels_per_step`` and the top kernels by device time (all 30
  written to ``--out`` when given).

Needs a CUDA device; exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys
import time

B, S = 16, 1024


def kernel_class(name):
    low = name.lower()
    for part in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "fused_ce_fwd", "fused_ce_dh",
                 "fused_ce_dw", "packed_flash_fwd", "packed_flash_dq",
                 "packed_flash_dkv"):
        if part in low:
            return part
    if any(s in low for s in ("convolve", "conv2d", "conv_", "fprop",
                              "dgrad", "wgrad", "cudnn", "implicit_gemm",
                              "nchwtonhwc", "nhwctonchw", "tensortransform")):
        return "convolution"
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet", "sm90_", "matmul", "splitkreduce")):
        return "matmul"
    if "batch_norm" in low or "batchnorm" in low:
        return "batch_norm"
    if "pool" in low:
        return "pooling"
    if "multi_tensor_apply" in low:
        return "optimizer"
    if any(s in low for s in ("softmax", "nll_loss", "cross_entropy")):
        return "softmax_ce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def busy_us(kernels):
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def bert_step(pack, dev):
    """bench_bert's step (BERT-base, dropout 0.1, AdamW 3e-5, O1 bf16) on
    its K=8 batches of 64 sequences: ``(step, stacked, batch, seq)``,
    ``stacked(k)`` the first k batches."""
    import torch

    from paddle_tpu_torch.kernels.packed_flash import SegmentIds
    from paddle_tpu_torch.models.bert import (
        BertForSequenceClassification, bert_base)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.tools import bench_bert

    model = BertForSequenceClassification(bert_base(), device=dev, seed=0)
    ids, y, seg, starts = bench_bert.make_data(64, pack)
    mask = None if seg is None else SegmentIds(
        torch.as_tensor(seg, device=dev),
        start_positions=torch.as_tensor(starts, device=dev))
    step = TrainStep(model, bench_bert.make_loss_fn(mask),
                     AdamW(3e-5, weight_decay=0.01), device=dev)
    idt, yt = torch.as_tensor(ids, device=dev), torch.as_tensor(y, device=dev)
    return step, (lambda k: (idt[:k], yt[:k])), 64, bench_bert.SEQ


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="steps timed, and steps profiled")
    ap.add_argument("--out", default=None,
                    help="also write the full kernel table here (JSON)")
    ap.add_argument("--fused-ce", action="store_true",
                    help="GPTConfig(fused_ce=True): the head and CE in "
                         "the fused-CE kernels")
    ap.add_argument("--share-p", action="store_true",
                    help="with --fused-ce: the shared-dl backward pair "
                         "(kernels.fused_ce._SHARE_P)")
    ap.add_argument("--bert", action="store_true",
                    help="the BERT-base fine-tune step of bench_bert")
    ap.add_argument("--pack", type=int, default=0,
                    help="with --bert: sequences packed to a row")
    ap.add_argument("--resnet", action="store_true",
                    help="the ResNet-50 step of bench_resnet (bench.py)")
    ap.add_argument("--data-format", default="NCHW",
                    choices=("NCHW", "NHWC"), help="with --resnet")
    args = ap.parse_args()
    if (args.bert or args.resnet) and (args.fused_ce or args.steps > 8):
        ap.error("--bert and --resnet take no --fused-ce and at most 8 "
                 "--steps (their 8 batches)")
    if args.bert and args.resnet:
        ap.error("--bert or --resnet, not both")
    if args.share_p and not args.fused_ce:
        ap.error("--share-p needs --fused-ce")
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_small
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep

    _build.build_all()
    fc._SHARE_P = args.share_p
    dev = torch.device("cuda")
    if args.bert:
        step, stacked, batch, seq = bert_step(args.pack, dev)
    elif args.resnet:
        from paddle_tpu_torch.tools import bench_resnet
        _, step = bench_resnet.build(args.data_format, dev)
        x, y = bench_resnet.make_data(8, bench_resnet.BATCH, args.data_format,
                                      dev)
        batch, seq = bench_resnet.BATCH, None

        def stacked(k):
            return x[:k], y[:k]
    else:
        batch, seq = B, S
        cfg = gpt2_small(dropout=0.0, recompute=True,
                         fused_ce=args.fused_ce)
        model = GPTForCausalLM(cfg, device="cuda", seed=0)

        def bf16_loss(m, i, y):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                return m.loss(i, y)

        step = TrainStep(model, bf16_loss, AdamW(
            6e-4, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)),
            device="cuda")
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
        labels = np.roll(ids, -1, axis=-1)

        def stacked(k):
            return (torch.as_tensor(ids, device=dev).expand(k, -1, -1),
                    torch.as_tensor(labels, device=dev).expand(k, -1, -1))

    step.multi_step(*stacked(8)).cpu()               # warm-up
    t0 = time.perf_counter()
    step.multi_step(*stacked(args.steps)).cpu()
    step_s = (time.perf_counter() - t0) / args.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step.multi_step(*stacked(args.steps)).cpu()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us(kern) * 1e-6
    by_class, by_name = {}, {}
    for e in kern:
        dur = (e.time_range.end - e.time_range.start) * 1e-3 / args.steps
        c = by_class.setdefault(kernel_class(e.name), {"ms": 0.0, "n": 0})
        c["ms"] += dur
        c["n"] += 1
        k = by_name.setdefault(e.name, {"ms": 0.0, "n": 0})
        k["ms"] += dur
        k["n"] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:30]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = {"tool": "profile_train", "gpu": gpu,
           "model": ("bert_base" if args.bert else "resnet50" if args.resnet
                     else "gpt2_small"),
           "data_format": args.data_format if args.resnet else None,
           "fused_ce": args.fused_ce, "share_p": args.share_p, "pack": args.pack if args.bert else None,
           "batch": batch, "seq": seq, "steps": args.steps,
           "step_ms": step_s * 1e3,
           "profiled_step_ms": wall * 1e3 / args.steps,
           "device_kernels": len(kern),
           "kernels_per_step": len(kern) / args.steps,
           "device_busy_ms_per_step": busy * 1e3 / args.steps,
           "device_idle_frac": (1.0 - busy / wall) if kern else None,
           "device_idle_frac_unprofiled": (
               1.0 - busy / (step_s * args.steps)) if kern else None,
           "by_class": by_class,
           "top": [{"name": n[:120], **v} for n, v in top[:10]]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(res, top=[{"name": n, **v} for n, v in top]),
                      f, indent=1)
    print(json.dumps(res), flush=True)
    if not kern:
        print("profile_train: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
