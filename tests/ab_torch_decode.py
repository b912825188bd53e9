#!/usr/bin/env python3
"""Decode time of whole families, two trees of the port in turns on one
CUDA card:

    python tests/ab_torch_decode.py --tree parent=build/parent --tree change=. \\
        [--arch internlm2-1.8b rwkv6-7b] [--order parent change change parent]

Each turn is a process of its own that puts the tree's ``chip_smoke.py``
first on the path, builds the tree's kernels and runs
``chip_smoke.family_generate`` (batch 4, prompt 64, 32 greedy tokens,
replayed against an eager loop) on each arch at full width and every
layer, bf16 with int8 weights from the port's init (seed 0). Prints one
line a turn: the decode ms a step on the card and on the host clock,
kernels a step and GQMM ms a step, by arch; then the card's name and power
limit. A tree is a checkout's root (for a parent, unpack ``git archive``
under ``build/``, which is git-ignored).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
cs.CARD["smi"] = cs.card()
cs.cuda_build.build_all()
dev = torch.device("cuda", 0)
out = {}
for arch in sys.argv[2:]:
    model = cs.build(cs.load_config(arch))
    params = model.init(seed=cs.SERVE["seed"], device=dev)
    eng = cs.InferenceEngine(model, params, quantize=True, device=dev,
                             cache_len=cs.SERVE["prompt_len"] + cs.SERVE["max_new_tokens"]
                             + cs.SPEC["k"])
    del params
    r = cs.family_generate(dev, eng, arch)
    out[arch] = {k: r[k] for k in ("decode_ms_device", "decode_ms_wall", "kernels_per_step",
                                   "gqmm_ms_per_step")}
    del eng, model
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="TAG=PATH",
                    help="a tree of the port by tag, e.g. parent=build/parent")
    ap.add_argument("--arch", nargs="+", default=["internlm2-1.8b", "rwkv6-7b"])
    ap.add_argument("--order", nargs="+", default=None,
                    help="tags in the order of the turns (default: first, second, second, "
                         "first)")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    tags = list(trees)
    order = args.order or [tags[0], tags[-1], tags[-1], tags[0]]
    for tag in order:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD, str(Path(trees[tag]).resolve()),
                               *args.arch], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(f"{tag} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            return 1
        print(f"{tag} {time.perf_counter() - t0:.1f} s {lines[0][len('RESULT '):]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
