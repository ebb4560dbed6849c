#!/usr/bin/env python3
"""ResNet-50 training throughput on one NVIDIA GPU — port of the
repository's headline ``bench.py``.

    python3 -m paddle_tpu_torch.tools.bench_resnet [--k K] [--reps R]
        [--data-format NCHW|NHWC]

Run from the repository root. ``bench.py``'s configuration and loop:
``resnet50(num_classes=1000)`` in training mode, the forward under
``auto_cast(level="O1", dtype="bfloat16")`` and the cross entropy
outside it, ``Momentum(learning_rate=0.1, momentum=0.9)``, and
``TrainStep.multi_step`` over K = 30 batches of 128 images of 3 x 224 x
224: two warm-up calls, then ``--reps`` timed calls (6), host clock
ending in a read of the losses. The K batches are made once on the card
before the warm-up (uniform [0, 1) images and labels in [0, 1000) from a
``torch.Generator`` seeded with 0; ``bench.py`` draws the same
distributions from numpy's unseeded global generator), so no host copy
falls inside the timed window. Weights are random from numpy seed 0.

Prints one JSON line: ``bench.py``'s ``metric``, ``value`` and ``unit``
(images a second on this one card), ``step_ms``, MFU, peak memory, the
first and last losses, and the card's ``nvidia-smi`` name and power
limit. MFU counts the model's conv and linear FLOPs from their shapes
(``2 Cout Cin/groups kh kw Hout Wout`` a conv, ``2 in out`` the head, an
image, read off one forward by hooks), x3 for forward and backward, over
the H100's dense bf16 peak, 989 TFLOP/s. ``bench.py``'s ``vs_baseline``
(against a target set for the TPU) is left out. Needs a CUDA device;
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
BATCH, K, WARMUP, REPS, SIZE, CLASSES = 128, 30, 2, 6, 224, 1000


def forward_flops_per_image(model, image_shape, device):
    """Multiply-add FLOPs (x2) of the model's convs and linear layers for
    one image of ``image_shape``, read off an eval-mode forward (which
    leaves the running statistics alone)."""
    import torch

    from ..nn import Conv2D, Linear

    total = [0]

    def conv_hook(m, inputs, out):
        cout, cin_g, kh, kw = m.weight.shape
        spatial = out.shape[1:3] if m._data_format == "NHWC" \
            else out.shape[2:]
        total[0] += 2 * cout * cin_g * kh * kw * spatial[0] * spatial[1]

    def linear_hook(m, inputs, out):
        total[0] += 2 * m.weight.shape[0] * m.weight.shape[1]

    hooks = [m.register_forward_hook(conv_hook if isinstance(m, Conv2D)
                                     else linear_hook)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros((1, *image_shape), device=device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total[0]


def image_shape(data_format):
    return (SIZE, SIZE, 3) if data_format == "NHWC" else (3, SIZE, SIZE)


def make_data(k, batch, data_format, device):
    """``(x [k, batch, *image], y [k, batch] int64)`` on ``device``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.rand((k, batch, *image_shape(data_format)), generator=gen,
                   device=device)
    y = torch.randint(0, CLASSES, (k, batch), generator=gen, device=device)
    return x, y


def loss_fn(m, x, y):
    """``bench.py``'s loss: logits under O1 bf16, cross entropy outside
    (so, as there, in the logits' bf16)."""
    from .. import amp
    from ..nn.functional import cross_entropy
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        logits = m(x)
    return cross_entropy(logits, y)


def build(data_format="NCHW", device=None):
    """``(model, TrainStep)`` of ``bench.py``."""
    from ..optimizer import Momentum
    from ..parallel.api import TrainStep
    from ..vision.models import resnet50

    model = resnet50(num_classes=CLASSES, data_format=data_format,
                     device=device, seed=0)
    model.train()
    step = TrainStep(model, loss_fn, Momentum(learning_rate=0.1, momentum=0.9),
                     device=device)
    return model, step


def run(batch=BATCH, k=K, warmup=WARMUP, reps=REPS, data_format="NCHW",
        device=None):
    """One measurement, on the current CUDA device unless ``device`` is
    given (``resolve_device``: raises without CUDA). Returns the record
    :func:`main` prints, with every step's loss under ``"losses"``."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    model, step = build(data_format, dev)
    x, y = make_data(k, batch, data_format, dev)
    flops = forward_flops_per_image(model, image_shape(data_format), dev)
    losses, first_call_s = [], None
    t0 = time.perf_counter()
    for i in range(warmup):          # cuDNN heuristics, allocator
        losses += step.multi_step(x, y).float().cpu().tolist()
        if i == 0:
            first_call_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        losses += step.multi_step(x, y).float().cpu().tolist()
    dt = (time.perf_counter() - t0) / (reps * k)
    imgs = batch / dt
    rec = {"metric": "resnet50_train_imgs_per_sec_per_chip",
           "value": imgs, "unit": "imgs/sec/chip",
           "batch_per_chip": batch, "k": k, "warmup": warmup, "reps": reps,
           "data_format": data_format, "step_ms": dt * 1e3,
           "mfu": imgs * 3 * flops / PEAK_FLOPS,
           "mfu_peak_flops": PEAK_FLOPS,
           "forward_flops_per_image": flops,
           "first_call_s": first_call_s,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses}
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
    ap.add_argument("--k", type=int, default=K,
                    help="steps a multi_step call")
    ap.add_argument("--reps", type=int, default=REPS,
                    help="timed multi_step calls")
    ap.add_argument("--data-format", default="NCHW",
                    choices=("NCHW", "NHWC"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_resnet: no CUDA device", file=sys.stderr)
        return 2
    rec = run(k=args.k, reps=args.reps, data_format=args.data_format)
    rec.pop("losses")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
