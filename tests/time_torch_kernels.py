#!/usr/bin/env python3
"""Device times of the GQMV kernels (and, on request, the f32 flash-attention
kernel and the fused RMSNorm + quantize) of whichever ``repro_torch`` is
first on the path, on one CUDA card, so that two trees of the port can be
timed in turns in one run:

    PYTHONPATH=<tree>/src python tests/time_torch_kernels.py --tag NAME \\
        [--kernels gqmv flash rmsq pass] [--sass] [--out FILE]

Shapes: TinyLlama's five projections as GQMV of int8, int4, int3 and fp8
weights at GS 256 (``gqmv``); the f32 cases of chip_smoke.py's FLASH_TIMED
(``flash``: TinyLlama's 32/4 heads at hd 64 over 4 x 64 and 1 x 2048
tokens, gemma2-2b's 8/4 at hd 256 and zamba2-7b's 32/32 at hd 112 over
1 x 2048, causal); chip_smoke.py's RMSQ_TIMED rows at GS 256 with bf16 and
f32 x and w (``rmsq``: (4, 2048), (256, 2048), (256, 5632)); one forward
pass of TinyLlama's 89 int8 projections (22 layers x wqkv, wo, w13, w2, then
the classifier) as back-to-back GQMV calls (``pass``; where the tree has the
knob, also with every row on the first design). Each time is the mean of
back-to-back calls between CUDA events, queued behind a GPU spin that keeps
the host's launch cost out (as chip_smoke.device_time_ms); GQMV calls cycle
through weight copies larger than the L2. Inputs come from a seeded
generator, the same in every tree, and each GQMV and RMSNorm row carries a
checksum of its output's bytes (GQMV: the f32 output; RMSNorm: the int8
values), so that two trees' results can be compared bit for bit; an
RMSNorm row also lists the int8 values that differ from the plain
version's (flat position, value, plain value: two trees' flips compare
through them), and where the tree has one, an empty kernel launched as the
row design launches its kernel is timed beside each shape (the card's floor
for it). ``--sass`` also counts the SASS instructions of each streamed GQMV
kernel at GS 256 in the built library (``cuobjdump -sass``), by opcode.
Prints one line per shape and, with --out, writes them as JSON.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import re
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core.quant import quantize, quantize_activation
from repro_torch.kernels import cuda_build, flash_attn, gqmv, ref, rmsnorm_quant

FLASH = (("4x64", 4, 32, 4, 64, 64), ("1x2048", 1, 32, 4, 2048, 64),
         ("gemma2_1x2048", 1, 8, 4, 2048, 256), ("zamba2_1x2048", 1, 32, 32, 2048, 112))
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
GQMV_FORMATS = ("int8", "int4", "int3", "fp8")
RMSQ = ((4, 2048), (256, 2048), (256, 5632))
RMSQ_DTYPES = (torch.bfloat16, torch.float32)
GS = 256
SPIN_CYCLES_PER_MS = 2.0e6
# the SASS opcodes shown per streamed kernel (the rest are counted in the total)
SASS_SHOWN = ("FFMA", "FMUL", "FADD", "IDP", "PRMT", "LOP3", "SHF", "IMAD", "F2FP", "HADD2",
              "I2F", "LDG", "LDS", "STS", "SHFL")


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


def time_flash(tag: str, gen) -> list[dict]:
    rows = []
    for name, b, h, kv, s, hd in FLASH:
        q = torch.randn((b * h, s, hd), generator=gen, device="cuda")
        k = torch.randn((b * kv, s, hd), generator=gen, device="cuda")
        v = torch.randn((b * kv, s, hd), generator=gen, device="cuda")
        kw = dict(group=h // kv, scale=hd ** -0.5, causal=True)
        us = 1e3 * device_time_ms(lambda i: flash_attn.flash_attention_cuda(q, k, v, **kw), 20)
        rows.append({"tag": tag, "kernel": "flash_attn_f32", "shape": name, "us": us})
    return rows


def time_gqmv(tag: str, gen) -> list[dict]:
    rows = []
    for fmt in GQMV_FORMATS:
        for name, m, n in PROJECTIONS:
            w = quantize(torch.randn((m, n), generator=gen, device="cuda"), GS, fmt)
            x = quantize_activation(torch.randn((n,), generator=gen, device="cuda"), GS)
            out = gqmv.gqmv_cuda(w.qvalues, w.scales, x.qvalues, x.scales, group_size=GS, fmt=fmt)
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
            copies = max(1, math.ceil(160e6 / (w.qvalues.numel() + 4 * w.scales.numel())))
            pool = [(w.qvalues.clone(), w.scales.clone()) for _ in range(copies)]
            us = 1e3 * device_time_ms(lambda i: gqmv.gqmv_cuda(
                *pool[i % copies], x.qvalues, x.scales, group_size=GS, fmt=fmt),
                max(50, 2 * copies))
            rows.append({"tag": tag, "kernel": f"gqmv_{fmt}", "shape": name, "us": us,
                         "design": gqmv.gqmv_design(n, fmt), "checksum": digest})
            del pool
    return rows


def time_rmsq(tag: str, gen) -> list[dict]:
    rows = []
    for (m, n), dt in ((s, d) for s in RMSQ for d in RMSQ_DTYPES):
        x = (torch.randn((m, n), generator=gen, device="cuda") * 3).to(dt)
        w = (1 + 0.1 * torch.randn((n,), generator=gen, device="cuda")).to(dt)
        q, _ = rmsnorm_quant.rmsnorm_quant_cuda(x, w, group_size=GS)
        digest = hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest()[:16]
        plain = ref.rmsnorm_quant_ref(x, w, group_size=GS)[0]
        at = torch.nonzero((q != plain).flatten()).flatten()
        us = 1e3 * device_time_ms(
            lambda i: rmsnorm_quant.rmsnorm_quant_cuda(x, w, group_size=GS), 100)
        rows.append({"tag": tag, "kernel": "rmsnorm_quant",
                     "shape": f"{str(dt).split('.')[-1]} {m}x{n}", "us": us,
                     "checksum": digest, "differ_from_plain": int(at.numel()),
                     "differ_at": [[int(k), int(q.flatten()[k]), int(plain.flatten()[k])]
                                   for k in at.tolist()]})
        if hasattr(rmsnorm_quant, "empty_cuda") and dt == RMSQ_DTYPES[0]:
            ctas = rmsnorm_quant.plan(m, n)[2]
            dev = torch.device("cuda", torch.cuda.current_device())
            rows.append({"tag": tag, "kernel": "empty (floor)", "shape": f"{ctas} CTAs",
                         "us": 1e3 * device_time_ms(
                             lambda i: rmsnorm_quant.empty_cuda(ctas, dev), 100)})
    return rows


def time_pass(tag: str, gen) -> list[dict]:
    layers = 22
    shapes = [(m, n) for _, m, n in PROJECTIONS[:4]] * layers + [PROJECTIONS[4][1:]]
    projs = []
    for m, n in shapes:
        w = quantize(torch.randn((m, n), generator=gen, device="cuda"), GS, "int8")
        x = quantize_activation(torch.randn((n,), generator=gen, device="cuda"), GS)
        projs.append((w, x))

    def step(_):
        for w, x in projs:
            gqmv.gqmv_cuda(w.qvalues, w.scales, x.qvalues, x.scales, group_size=GS)

    rows = [{"tag": tag, "kernel": "gqmv_int8 pass", "shape": f"{len(projs)} calls",
             "us": 1e3 * device_time_ms(step, 4, host_ms_guess=4.0)}]
    if hasattr(gqmv, "set_stream_max_n"):
        prev = gqmv.set_stream_max_n(0)
        try:
            rows.append({"tag": tag, "kernel": "gqmv_int8 pass", "shape": "first design",
                         "us": 1e3 * device_time_ms(step, 4, host_ms_guess=4.0)})
        finally:
            gqmv.set_stream_max_n(prev)
    return rows


def sass_counts() -> dict[str, dict[str, int]]:
    """SASS opcode counts of each streamed GQMV kernel at GS 256 in the
    built gqmm library (instructions in the code, not executed), keyed by
    its loader (StreamInt4, StreamInt3, StreamFp8, StreamInt8)."""
    from torch.utils.cpp_extension import CUDA_HOME

    lib = cuda_build.build_all(["gqmm"])["gqmm"].path
    text = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            m = re.search(r"gqmv_stream_(?:mma_)?kernelINS_\d+(\w+?)ELi8E", head.group(1))
            current = collections.Counter() if m else None
            if m:
                counts[m.group(1)] = current
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if current is not None and ins:
            current[ins.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True, help="name of the tree, printed on every line")
    ap.add_argument("--kernels", nargs="+", choices=("gqmv", "flash", "rmsq", "pass"),
                    default=["gqmv"],
                    help="which kernels to time (default: gqmv)")
    ap.add_argument("--sass", action="store_true",
                    help="also count the streamed GQMV kernels' SASS instructions")
    ap.add_argument("--out", default=None, help="also write the rows as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    if "flash" in args.kernels:
        rows += time_flash(args.tag, gen)
    if "gqmv" in args.kernels:
        rows += time_gqmv(args.tag, gen)
    if "rmsq" in args.kernels:
        rows += time_rmsq(args.tag, gen)
    if "pass" in args.kernels:
        rows += time_pass(args.tag, gen)
    for r in rows:
        print(f"[time] {r['tag']:8s} {r['kernel']:15s} {r['shape']:14s} {r['us']:10.2f} us  "
              + (f"{r['design']:6s} " if "design" in r else "")
              + (f"{r['checksum']}  " if "checksum" in r else "")
              + (f"{r['differ_from_plain']} differ from plain  " if "differ_from_plain" in r
                 else "")
              + f"[{card}]", flush=True)
    result = {"card": card, "rows": rows}
    if args.sass:
        result["sass"] = sass_counts()
        for loader, c in result["sass"].items():
            shown = "  ".join(f"{op} {c.get(op, 0)}" for op in SASS_SHOWN)
            print(f"[sass] {args.tag:8s} {loader:10s} total {sum(c.values())}  {shown}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
