#!/usr/bin/env python3
"""Serve tokens/s of two checkouts of the port, in turns on one card.

    python3 tools/ab_torch_serve.py TREE_A TREE_B [--engines N]

Each TREE is a directory holding ``chip_smoke.py`` and
``paddle_tpu_torch/`` (this repository, or an unpacked ``git archive`` of
another commit). The legs run A, B, B, A, each in a fresh process that
imports that tree's ``chip_smoke`` and serves its ``serve`` traffic
(GPT-2 small, random weights from seed 0, bf16 weights and pools, 8
slots, 16 requests) on N fresh captured engines (default 5), timing
each run by the host clock around ``run()`` ending in a synchronise.
Prints one JSON line a leg (the tree and its tokens/s per engine) and a
last line with each tree's median over its legs and B's median over
A's, beside the card's ``nvidia-smi`` name and power limit. Needs a
CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys

LEG = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
cfg, params = model = cs.serve_model()
reqs = cs.serve_traffic(cfg.vocab_size)
rates = []
for _ in range(int(sys.argv[2])):
    eng, uids, done, wall, counts = cs.serve_run(
        cfg, params, reqs, "ab", weight_dtype="bf16", kv_dtype="bf16")
    rates.append(eng.stats["tokens_emitted"] / wall)
    del eng
print(json.dumps({"tree": sys.argv[1], "tokens_per_s": rates}))
'''


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    engines = 5
    if "--engines" in argv:
        i = argv.index("--engines")
        engines = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) != 2:
        raise SystemExit(__doc__)
    a, b = (os.path.abspath(t) for t in argv)
    rates = {a: [], b: []}
    for tree in (a, b, b, a):
        res = subprocess.run([sys.executable, "-c", LEG, tree,
                              str(engines)], capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f"{tree}: {res.stderr[-3000:]}")
        leg = json.loads(res.stdout.strip().splitlines()[-1])
        rates[tree] += leg["tokens_per_s"]
        print(json.dumps(leg), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    med = {t: statistics.median(r) for t, r in rates.items()}
    print(json.dumps({"median_tokens_per_s": med,
                      "b_over_a": med[b] / med[a], "gpu": card}))


if __name__ == "__main__":
    main()
