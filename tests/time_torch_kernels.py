#!/usr/bin/env python3
"""Device times of the f32 flash-attention kernel and the int3 GQMV kernel
of whichever ``repro_torch`` is first on the path, on one CUDA card, so that
two trees of the port can be timed in turns in one run:

    PYTHONPATH=<tree>/src python tests/time_torch_kernels.py --tag NAME [--out FILE]

Shapes: the f32 cases of chip_smoke.py's FLASH_TIMED (TinyLlama's 32/4
heads at hd 64 over 4 x 64 and 1 x 2048 tokens, gemma2-2b's 8/4 at hd 256
and zamba2-7b's 32/32 at hd 112 over 1 x 2048, causal) and TinyLlama's five
projections as int3 GQMV at GS 256. Each time is the mean of back-to-back
calls between CUDA events, queued behind a GPU spin that keeps the host's
launch cost out (as chip_smoke.device_time_ms); GQMV calls cycle through
weight copies larger than the L2. Inputs come from a seeded generator.
Prints one line per shape and, with --out, writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from repro_torch.core.quant import quantize, quantize_activation
from repro_torch.kernels import flash_attn, gqmv

FLASH = (("4x64", 4, 32, 4, 64, 64), ("1x2048", 1, 32, 4, 2048, 64),
         ("gemma2_1x2048", 1, 8, 4, 2048, 256), ("zamba2_1x2048", 1, 32, 32, 2048, 112))
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
GS = 256
SPIN_CYCLES_PER_MS = 2.0e6


def device_time_ms(fn, iters: int, host_ms_guess: float = 0.1) -> float:
    fn(0)
    torch.cuda.synchronize()
    spin_ms = max(1.0, 2.0 * host_ms_guess * iters)
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * spin_ms:
            return start.elapsed_time(end) / iters
        spin_ms = 2.0 * host_ms
    raise RuntimeError("the host's enqueue outlasted every GPU spin; no device time read")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True, help="name of the tree, printed on every line")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, b, h, kv, s, hd in FLASH:
        q = torch.randn((b * h, s, hd), generator=gen, device=dev)
        k = torch.randn((b * kv, s, hd), generator=gen, device=dev)
        v = torch.randn((b * kv, s, hd), generator=gen, device=dev)
        kw = dict(group=h // kv, scale=hd ** -0.5, causal=True)
        us = 1e3 * device_time_ms(lambda i: flash_attn.flash_attention_cuda(q, k, v, **kw), 20)
        rows.append({"tag": args.tag, "kernel": "flash_attn_f32", "shape": name, "us": us})
    for name, m, n in PROJECTIONS:
        w = quantize(torch.randn((m, n), generator=gen, device=dev), GS, "int3")
        x = quantize_activation(torch.randn((n,), generator=gen, device=dev), GS)
        copies = max(1, math.ceil(160e6 / (w.qvalues.numel() + 4 * w.scales.numel())))
        pool = [(w.qvalues.clone(), w.scales.clone()) for _ in range(copies)]
        us = 1e3 * device_time_ms(lambda i: gqmv.gqmv_cuda(
            *pool[i % copies], x.qvalues, x.scales, group_size=GS, fmt="int3"), max(50, 2 * copies))
        rows.append({"tag": args.tag, "kernel": "gqmv_int3", "shape": name, "us": us})
        del pool
    for r in rows:
        print(f"[time] {r['tag']:8s} {r['kernel']:15s} {r['shape']:14s} {r['us']:10.2f} us  [{card}]",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
