#!/usr/bin/env python3
"""Guard for the numerics-postmortem surface — port of
``tools/numerics_check.py`` (``validate_bundle`` ``:41``, ``self_drive``
``:121``).

    python3 -m paddle_tpu_torch.tools.numerics_check [--bundle DIR]
        [--device cpu|cuda] [--quiet]

Validates a postmortem bundle against the
``paddle_tpu-numerics-postmortem-v1`` schema or, with no ``--bundle``,
self-drives a tiny train loop of the port (``TrainStep(numerics="watch",
skip_nonfinite=True)``, an ``AnomalyWatchdog`` with the ``halt``
policy) with a NaN written into one weight mid-run: the watchdog must
raise ``NumericsAnomalyError`` with its bundle on disk, naming the
poisoned weight, and the bundle must validate:

- ``bundle.json`` exists, parses, carries the format tag and every
  required section;
- every stats kind has the five stat vectors, all of ``len(names)``;
- a ``nonfinite`` bundle names its first nonfinite tensor, and that
  tensor exists;
- every tensor dump is a loadable ``.npy`` beside the bundle;
- every flight-recorder dump parses with its format tag.

The self-drive runs on CUDA unless ``--device cpu`` is given. Prints
one JSON line (unless ``--quiet``); exits non-zero on any problem.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REQUIRED_KEYS = ("format", "reason", "step", "ts", "policy", "health",
                 "tensor_dumps", "flight_dumps")
STATS = ("nan", "inf", "absmax", "sq_sum", "zero_frac")


def validate_bundle(bundle_dir):
    """Schema problems of one bundle dir (an empty list: valid)."""
    from ..observability.numerics import NUMERICS_BUNDLE_FORMAT
    from ..observability.tracing import FLIGHT_RECORDER_FORMAT

    path = os.path.join(bundle_dir, "bundle.json")
    if not os.path.isfile(path):
        return [f"missing {path}"]
    try:
        with open(path) as f:
            doc = json.load(f)
    except ValueError as e:
        return [f"bundle.json does not parse: {e}"]
    problems = [f"bundle.json missing key {k!r}" for k in REQUIRED_KEYS
                if k not in doc]
    if doc.get("format") != NUMERICS_BUNDLE_FORMAT:
        problems.append(f"format is {doc.get('format')!r}, expected "
                        f"{NUMERICS_BUNDLE_FORMAT!r}")
    if problems:
        return problems
    health = doc["health"]
    names = health.get("names")
    if not isinstance(names, list) or not names:
        return ["health.names missing or empty"]
    stats = health.get("stats", {})
    if not stats:
        problems.append("health.stats has no kinds")
    for kind, st in stats.items():
        for s in STATS:
            vec = st.get(s)
            if vec is None:
                problems.append(f"health.stats[{kind}] missing {s!r}")
            elif len(vec) != len(names):
                problems.append(f"health.stats[{kind}][{s}] has {len(vec)} "
                                f"entries for {len(names)} tensors")
    if doc["reason"] == "nonfinite":
        first = health.get("first_nonfinite")
        if not first or "tensor" not in first or "kind" not in first:
            problems.append("nonfinite bundle lacks first_nonfinite "
                            "provenance")
        elif first["tensor"] not in names:
            problems.append(f"first_nonfinite names unknown tensor "
                            f"{first['tensor']!r}")
    for td in doc["tensor_dumps"]:
        f = os.path.join(bundle_dir, td.get("file", ""))
        if not os.path.isfile(f):
            problems.append(f"tensor dump missing: {td.get('file')}")
            continue
        try:
            np.load(f)
        except (OSError, ValueError) as e:
            problems.append(f"tensor dump unreadable: {td['file']}: {e}")
    for f in doc["flight_dumps"]:
        if not os.path.isfile(f):
            problems.append(f"flight dump missing: {f}")
            continue
        try:
            with open(f) as fh:
                fr = json.load(fh)
        except ValueError as e:
            problems.append(f"flight dump does not parse: {f}: {e}")
            continue
        if fr.get("format") != FLIGHT_RECORDER_FORMAT:
            problems.append(f"flight dump {f} format {fr.get('format')!r} "
                            f"!= {FLIGHT_RECORDER_FORMAT!r}")
    return problems


def self_drive(workdir, device=None):
    """The injected-NaN run: 3 clean steps, a NaN written into one weight,
    one more step under the ``halt`` policy. Returns ``(bundle dir, the
    poisoned tensor's name)``; raises SystemExit when the watchdog fires
    on a clean step or not at all."""
    import torch

    from ..device import resolve_device
    from ..nn import Linear, ReLU
    from ..observability import numerics as nmod
    from ..observability import tracing as trc
    from ..optimizer import AdamW
    from ..parallel.api import TrainStep

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    net = torch.nn.Sequential(Linear(8, 16, rng=rng, device=dev), ReLU(),
                              Linear(16, 4, rng=rng, device=dev))

    def loss_fn(m, x, y):
        d = m(x) - y
        return (d * d).mean()

    step = TrainStep(net, loss_fn, AdamW(0.01), device=dev,
                     numerics="watch", skip_nonfinite=True)
    # a live tracer registered for postmortems, so the bundle's
    # flight_dumps section is exercised
    tracer = trc.Tracer("numerics-check")
    tracer.start_trace("train", trace_id="run0")
    handle = trc.register_postmortem(tracer,
                                     os.path.join(workdir, "flight.json"))
    dog = nmod.watch(nmod.WatchPolicy(
        action="halt", dump_dir=os.path.join(workdir, "bundles"),
        save_tensors=2))
    dog.params_provider = lambda: list(net.named_parameters())
    x = torch.as_tensor(rng.random((16, 8), np.float32), device=dev)
    y = torch.as_tensor(rng.random((16, 4), np.float32), device=dev)
    try:
        for i in range(3):
            step(x, y)
            dog.check(step.numerics_view(step=i), step=i)
        with torch.no_grad():
            net[2].weight[0, 0] = float("nan")
        step(x, y)
        try:
            dog.check(step.numerics_view(step=3), step=3)
        except nmod.NumericsAnomalyError as e:
            if e.bundle is None:
                raise SystemExit("the halt carried no bundle") from None
            return e.bundle, "2.weight"
        raise SystemExit("watchdog did not fire on the poisoned step")
    finally:
        trc.unregister_postmortem(handle)
        tracer.end_trace("run0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bundle", default=None,
                    help="a bundle dir to validate (default: self-drive "
                         "an injected-NaN run)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    expect = None
    if args.bundle is None:
        bundle, expect = self_drive(tempfile.mkdtemp(
            prefix="numerics_check_"), args.device)
    else:
        bundle = args.bundle
    problems = validate_bundle(bundle)
    if expect is not None and not problems:
        with open(os.path.join(bundle, "bundle.json")) as f:
            doc = json.load(f)
        first = doc["health"].get("first_nonfinite") or {}
        if first.get("tensor") != expect:
            problems.append(f"provenance named {first.get('tensor')!r}, "
                            f"the poisoned tensor was {expect!r}")
        if not doc["tensor_dumps"]:
            problems.append("nonfinite bundle saved no tensors")
        if not doc["flight_dumps"]:
            problems.append("no flight-recorder dump despite a registered "
                            "tracer")
    if not args.quiet:
        print(json.dumps({"bundle": bundle, "problems": problems}))
    if problems:
        for p in problems:
            sys.stderr.write(f"numerics_check: {p}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
