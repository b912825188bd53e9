#!/usr/bin/env python3
"""Where the flash-attention backward's time goes on one CUDA card
(``flash_attn_bwd`` in ``csrc/flash_attn.cu``), and what its plain version
runs:

    PYTHONPATH=src python tests/profile_torch_flash_bwd.py [--cases NAME ...] \
        [--dtypes f32 bf16] [--no-plain] [--out FILE]

1. ptxas's report of the built library for every backward kernel (each
   dtype, head dim and role): registers, stack frame, spill stores and
   loads, from nvcc's ``-Xptxas -v`` log.
2. At TinyLlama's 1 x 2048 (32/4 heads, hd 64) and zamba2-7b's 1 x 2048
   (32/32, hd 112), causal (by default; ``--cases`` also takes the other
   shapes of chip_smoke.py's phase 11 (a): TinyLlama 4 x 128, the seamless
   encoder's 4 x 512 non-causal, and gemma2's hd 256 without its window
   and cap), in f32 and bf16: the backward's time by CUDA events, its
   launches by torch.profiler (D, dK/dV, dQ, the group sum), each
   products kernel's rate on the visible pairs (dK/dV: four products
   of 2 * hd operations a pair, dQ: three) against the card's peak for the
   dtype (``bounds.PEAK_OPS_PER_S``), the CTAs an SM and shared memory of
   each (``flash_attn_bwd_layout``); the forward kernel's time and rate at
   the same shape (two products); unless ``--no-plain``, the plain version
   (``ref.flash_attention_bwd_ref``) timed by CUDA events and by
   torch.profiler, with its five heaviest kernels by name.
3. Unless ``--no-plain``: the f32 gradients of the kernel and of the
   plain version against a float64 gradient on the card (autograd of
   softmax(q k^T scale) v), as max |error| / max |f64|: TF32 in a product
   would show as ~1e-3.

Two trees compare in one run by putting each first on PYTHONPATH in turn.

Prints one line per reading and, with --out, writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

from repro_torch.kernels import bounds, cuda_build, flash_attn, ref

# name: (b*H, b*KV, s, hd, causal)
CASES = {"tinyllama 1x2048": (32, 4, 2048, 64, True), "zamba2 1x2048": (32, 32, 2048, 112, True),
         "tinyllama 4x128": (128, 16, 128, 64, True), "seamless 4x512": (64, 64, 512, 64, False),
         "gemma2 1x4608": (8, 4, 4608, 256, True)}
DEFAULT_CASES = ("tinyllama 1x2048", "zamba2 1x2048")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SPIN_CYCLES_PER_MS = 2.0e6


def device_time_ms(fn, iters: int) -> float:
    """Mean device ms of fn() run back to back between CUDA events, queued
    behind a GPU spin that outlasts the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    spin_ms = 2.0
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * spin_ms:
            return start.elapsed_time(end) / iters
        spin_ms = 2.0 * host_ms
    raise RuntimeError("the host's enqueue outlasted every GPU spin; no device time read")


def profile_ms(fn, reps: int) -> dict[str, float]:
    """Device ms per call of fn() by kernel name (torch.profiler, CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / reps
    return out


def bwd_part(name: str) -> str:
    return ("D" if "delta" in name else "group sum" if "group_sum" in name
            else "dQ" if "true>" in name else "dK/dV")


def ptxas_report(log: str) -> list[dict]:
    """The flash_bwd entries of nvcc's -Xptxas -v log: kernel, dtype, head
    dim, role, registers, stack frame and spill bytes."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"mangled": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            name = cur.pop("mangled")
            kern = re.search(r"(flash_bwd_\w+?_kernel)", name)
            if kern:
                hd = re.search(r"Li(\d+)E", name)
                role = re.search(r"Lb([01])E", name)
                cur.update(kernel=kern.group(1),
                           dtype=("bf16" if "nv_bfloat16" in name else "fp16"
                                  if "__half" in name else "f32"),
                           hd=int(hd.group(1)) if hd and "delta" not in kern.group(1) else None,
                           role=None if role is None else "dQ" if role.group(1) == "1"
                           else "dK/dV")
                rows.append(cur)
            cur = None
    return sorted(rows, key=lambda r: (r["kernel"], r["dtype"], r["hd"] or 0, r["role"] or ""))


def grads_f64(q, k, v, do, group, scale, causal):
    """(dq, dk, dv) of softmax attention in float64, by autograd."""
    qd, kd, vd = (x.double().requires_grad_(True) for x in (q, k, v))
    kk, vv = kd.repeat_interleave(group, 0), vd.repeat_interleave(group, 0)
    sc = (qd @ kk.transpose(-1, -2)) * scale
    s = q.shape[1]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    ok = ok.tril() if causal else ok
    out = torch.softmax(sc.masked_fill(~ok, float("-inf")), -1) @ vv
    return torch.autograd.grad(out, (qd, kd, vd), do.double())


def rel_errs(got, want) -> list[float]:
    return [((g.double() - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]


def run_case(name, dtype, gen, card, plain: bool) -> dict:
    h, kv, s, hd, causal = CASES[name]
    group, scale = h // kv, hd ** -0.5
    q = torch.randn((h, s, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((kv, s, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((kv, s, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((h, s, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(group=group, scale=scale, causal=causal)
    out, lse = flash_attn.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    pairs = h * (s * (s + 1) // 2 if causal else s * s)
    peak = bounds.PEAK_OPS_PER_S["f32" if dtype == torch.float32 else "bf16"]
    row = {"case": name, "dtype": str(dtype).split(".")[-1], "heads": h, "kv_heads": kv,
           "s": s, "hd": hd, "causal": causal, "pairs": pairs, "card": card}
    row["fwd_us"] = 1e3 * device_time_ms(
        lambda: flash_attn.flash_attention_cuda(q, k, v, **kw), 10)
    row["fwd_rate"] = 2 * 2 * hd * pairs / (row["fwd_us"] * 1e-6) / peak
    row["bwd_us"] = 1e3 * device_time_ms(
        lambda: flash_attn.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw), 10)
    row["bwd_rate"] = 5 * 2 * hd * pairs / (row["bwd_us"] * 1e-6) / peak
    parts: dict[str, float] = {}
    for kname, ms in profile_ms(
            lambda: flash_attn.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw), 5).items():
        if "flash_bwd" in kname:
            parts[bwd_part(kname)] = parts.get(bwd_part(kname), 0.0) + 1e3 * ms
    row["parts_us"] = parts
    row["parts_rate"] = {p: n * 2 * hd * pairs / (parts[p] * 1e-6) / peak
                         for p, n in (("dK/dV", 4), ("dQ", 3)) if p in parts}
    row["layout"] = {}
    for role, dq in (("dK/dV", False), ("dQ", True)):
        smem, ctas = flash_attn.bwd_layout(hd, dtype, dq)
        row["layout"][role] = {"smem_bytes": smem, "ctas_per_sm": ctas}
    if not plain:
        return row
    row["plain_us_events"] = 1e3 * device_time_ms(
        lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw), 3)
    plain = profile_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw), 1)
    row["plain_us_profiler"] = 1e3 * sum(plain.values())
    row["plain_top"] = [(kname[:90], 1e3 * ms)
                        for kname, ms in sorted(plain.items(), key=lambda kv_: -kv_[1])[:5]]
    if dtype == torch.float32:
        want = grads_f64(q, k, v, do, group, scale, causal)
        got = flash_attn.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        row["kernel_err_vs_f64"] = rel_errs(got, want)
        row["plain_err_vs_f64"] = rel_errs(
            ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw), want)
        del want, got
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", choices=tuple(CASES), default=DEFAULT_CASES)
    ap.add_argument("--dtypes", nargs="+", choices=tuple(DTYPES), default=tuple(DTYPES))
    ap.add_argument("--no-plain", action="store_true",
                    help="skip the plain version and the float64 check")
    ap.add_argument("--out", default=None, help="also write the readings as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_flash_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    built = cuda_build.build_all(["flash_attn"])["flash_attn"]
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "float32_matmul_precision": torch.get_float32_matmul_precision(),
              "ptxas": ptxas_report(built.log), "cases": []}
    print(f"[env] torch {result['torch']} cuda {result['cuda']} allow_tf32 "
          f"{result['allow_tf32']} float32_matmul_precision "
          f"{result['float32_matmul_precision']} [{card}]", flush=True)
    for r in result["ptxas"]:
        print(f"[ptxas] {r['kernel']:27s} {r['dtype']:4s} hd {str(r['hd']):4s} "
              f"{str(r['role']):6s} {r['registers']:3d} registers, {r['stack']} bytes stack, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spill stores / loads", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.cases:
        for dtype in (DTYPES[d] for d in args.dtypes):
            row = run_case(name, dtype, gen, card, not args.no_plain)
            result["cases"].append(row)
            print(f"[case] {row['dtype']:8s} {name:17s} hd {row['hd']:3d}: forward "
                  f"{row['fwd_us']:.1f} us ({100 * row['fwd_rate']:.1f} % of peak); backward "
                  f"{row['bwd_us']:.1f} us ({100 * row['bwd_rate']:.1f} % of peak on 5 "
                  "products); "
                  + ", ".join(f"{p} {us:.1f} us" for p, us in row["parts_us"].items())
                  + "; rates " + ", ".join(f"{p} {100 * x:.1f} %" for p, x in
                                          row["parts_rate"].items())
                  + "; layout " + ", ".join(f"{p} {x['smem_bytes']} B {x['ctas_per_sm']} CTA/SM"
                                            for p, x in row["layout"].items())
                  + (f"; plain {row['plain_us_events']:.1f} us (events), "
                     f"{row['plain_us_profiler']:.1f} us (profiler)" if "plain_top" in row
                     else "")
                  + (f"; f32 error vs f64 kernel "
                     + "/".join(f"{e:.2e}" for e in row["kernel_err_vs_f64"]) + " plain "
                     + "/".join(f"{e:.2e}" for e in row["plain_err_vs_f64"])
                     if "kernel_err_vs_f64" in row else "") + f" [{card}]", flush=True)
            for kname, us in row.get("plain_top", ()):
                print(f"[plain] {row['dtype']:8s} {name:17s} {us:9.1f} us  {kname}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
