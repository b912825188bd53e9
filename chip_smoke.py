#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports the port only (never JAX nor the reference package) and fails,
printing no result, when CUDA is missing. Phases, each fatal on failure:

1. build:    compile every CUDA source of the port with nvcc (sm_90a).
2. kernels:  GQMM at b in {1, 4, 256} and GQMV at b=1, at every TinyLlama
             projection shape, against their plain PyTorch versions on the
             card (rtol 1e-5, atol 1e-5 * max|plain|: the int32 group sums
             are exact, only the f32 order of <= 22 group terms differs),
             timed with CUDA events over weight copies that exceed the L2,
             behind a GPU spin that keeps the host's launch cost out.
3. serve:    full-width TinyLlama-1.1B (22 layers, d 2048, bf16, int8
             weights from the port's own init_lm) through
             InferenceEngine.generate: batch 4, prompt 64, 32 greedy tokens.
             The GQMM launch count must be 89 per forward pass (4 per layer
             x 22 + classifier). The same run on the plain versions must give
             first-step logits within 5e-2 * max|logit| (bf16 rounds every
             projection output to 2^-8 and 22 layers compound the kernel's
             other f32 summation order); the greedy-token agreement is shown.
             Then the matvec path: ops.quantized_matmul on 1-D activations
             (the GQMV kernel) over the same 89 projections.
4. golden:   TinyLlama at full width (depth cut to the golden file's), f32,
             int8 weights drawn by bridge.init_params_numpy: the greedy
             tokens must equal the reference package's (written by
             tests/make_torch_golden.py) exactly.

The lines before the last are a JSON object of the kernels, then the card's
name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.quant import QuantizedTensor, quantize_activation  # noqa: E402
from repro_torch.kernels import cuda_build, ops  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels.ref import gqmm_ref, gqmv_ref  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s, int8 tensor operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

ARCH = "tinyllama-1.1b"
# (name, m, n): every quantized projection TinyLlama runs, per layer and once
PROJECTIONS = (("wqkv", 2560, 2048), ("wo", 2048, 2048), ("w13", 11264, 2048),
               ("w2", 2048, 5632), ("classifier", 32000, 2048))
KERNEL_BATCHES = (1, 4, 256)
RTOL = 1e-5
SERVE = {"batch": 4, "prompt_len": 64, "max_new_tokens": 32, "seed": 0}
LOGIT_TOL = 5e-2
GOLDEN_FILE = ROOT / "src" / "repro_torch" / "golden_tinyllama.json"
GOLDEN = {"arch": ARCH, "num_layers": 2, "dtype": "float32", "quantize": "int8",
          "seed": 0, "prompt_seed": 1, "batch": 2, "prompt_len": 16,
          "max_new_tokens": 16}
SOURCES = {"gqmv_int8": "src/repro_torch/csrc/gqmm.cu", "gqmm_int8": "src/repro_torch/csrc/gqmm.cu"}
REPLACES = {"gqmv_int8": "src/repro/kernels/gqmv.py:166",     # gqmv_pallas
            "gqmm_int8": "src/repro/kernels/gqmv.py:312"}     # gqmm_pallas


def golden_config():
    cfg = load_config(GOLDEN["arch"])
    return dataclasses.replace(cfg, num_layers=GOLDEN["num_layers"],
                               param_dtype=GOLDEN["dtype"], compute_dtype=GOLDEN["dtype"])


def golden_prompt(vocab_size: int) -> np.ndarray:
    rng = np.random.RandomState(GOLDEN["prompt_seed"])
    return rng.randint(0, vocab_size, size=(GOLDEN["batch"], GOLDEN["prompt_len"]))


def weights_checksum(tree) -> str:
    """sha256 over every leaf's bytes, in sorted key order."""
    h = hashlib.sha256()

    def feed(node):
        if isinstance(node, dict):
            for k in sorted(node):
                feed(node[k])
        else:
            h.update(np.ascontiguousarray(node).tobytes())

    feed(tree)
    return h.hexdigest()


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_s(nbytes: int, ops: int) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")


def call_bytes(wq, ws, xq, xs, out_numel: int) -> int:
    """Each input read once, the f32 output written once."""
    return (wq.numel() + 4 * ws.numel() + xq.numel() + 4 * xs.numel() + 4 * out_numel)


SPIN_CYCLES_PER_MS = 2.0e6   # >= the H100's top SM clock: a spin of x ms lasts >= x ms


def device_time_ms(fn, iters: int, host_ms_guess: float = 0.1) -> tuple[float, float]:
    """(mean device ms, mean host enqueue ms) of fn(0), ..., fn(iters-1) run
    back to back. A GPU spin queued first keeps the card busy while the host
    enqueues the calls, so the host's per-call cost (Python checks, ctypes,
    PyTorch dispatch) stays out of the CUDA-event reading; the spin grows
    until it outlasts the enqueue."""
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
            return start.elapsed_time(end) / iters, host_ms / iters
        spin_ms = 2.0 * host_ms
    raise RuntimeError("the host's enqueue outlasted every GPU spin; no device time read")


def profile_device(fn, reps: int) -> dict:
    """Device time per call of fn() by kernel name, from torch.profiler's
    CUDA activity (CUPTI also sees the kernels launched through ctypes)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    count = 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3 / reps
            count += evt.count
    total = sum(by_name.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": total, "kernels": count // reps,
            "gqmm_ms": sum(v for k, v in by_name.items() if "gqmm_int8_kernel" in k),
            "top": top}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_q(gen, shape, gs, dev):
    q = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((*shape[:-1], shape[-1] // gs), generator=gen, device=dev) * 1e-2 + 1e-4
    return q, s


def check_close(name, got, want):
    err = (got - want).abs()
    tol = RTOL * want.abs() + RTOL * want.abs().max()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max |err| {err.max().item():.3e}, tol {tol.max().item():.3e})")
    return err.max().item()


def phase_kernels(dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    gs = load_config(ARCH).group_size
    rows = []
    for name, m, n in PROJECTIONS:
        wq, ws = _rand_q(gen, (m, n), gs, dev)
        wbytes = wq.numel() + 4 * ws.numel()
        copies = max(1, math.ceil(160e6 / wbytes))          # cycle through > 3x the L2
        pool = [(wq, ws)] + [(wq.clone(), ws.clone()) for _ in range(copies - 1)]
        for kname, b in [("gqmm_int8", bb) for bb in KERNEL_BATCHES] + [("gqmv_int8", 1)]:
            xq, xs = _rand_q(gen, (b, n) if kname == "gqmm_int8" else (n,), gs, dev)
            if kname == "gqmm_int8":
                kfn, pfn = kern.gqmm_cuda, gqmm_ref
            else:
                kfn, pfn = kern.gqmv_cuda, gqmv_ref
            got = kfn(wq, ws, xq, xs, group_size=gs)
            want = pfn(wq, ws, xq, xs, group_size=gs)
            torch.cuda.synchronize()
            err = check_close(f"{kname} {name} b={b}", got, want)
            k_ms, k_host = device_time_ms(
                lambda i: kfn(*pool[i % copies], xq, xs, group_size=gs), max(50, 2 * copies))
            p_ms, _ = device_time_ms(
                lambda i: pfn(*pool[i % copies], xq, xs, group_size=gs), 5, host_ms_guess=1.0)
            bnd, by = bound_s(call_bytes(wq, ws, xq, xs, got.numel()), 2 * b * m * n)
            rows.append({"kernel": kname, "shape": name, "m": m, "n": n, "b": b,
                         "max_abs_err": err, "us": 1e3 * k_ms, "host_us": 1e3 * k_host,
                         "plain_us": 1e3 * p_ms, "bound_us": 1e6 * bnd, "bound_by": by})
            log(f"[kernels] {kname:9s} {name:10s} m={m:5d} n={n:4d} b={b:3d}  "
                f"max|err| {err:.2e}  {1e3 * k_ms:8.1f} us (host {1e3 * k_host:5.1f})  "
                f"plain {1e3 * p_ms:8.1f} us  bound {1e6 * bnd:6.1f} us ({by})")
        del pool
    return rows


# ---------------------------------------------------------------------------
# phase 3: full-width serving, kernels against plain, and the matvec path
# ---------------------------------------------------------------------------

def model_projections(params) -> list[QuantizedTensor]:
    """The 89 quantized projections of one forward pass, in call order."""
    lay = params["layers"]
    out = []
    for i in range(lay["attn"]["wqkv"].qvalues.shape[0]):
        out += [lay["attn"]["wqkv"][i], lay["attn"]["wo"][i],
                lay["mlp"]["w13"][i], lay["mlp"]["w2"][i]]
    return out + [params["classifier"]]


def step_timing(projs, b: int, dev, rows) -> dict:
    """One forward pass's 89 projections back to back at batch b (b=1 as
    1-D GQMV) on the model's own weights: the kernels' device time, and the
    summed bound. The plain versions' time is the sum of their per-shape
    device times from phase 2 (a back-to-back pass of them queues more
    launches than the GPU-spin timing can hold)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    acts, nbytes, nops = [], 0, 0
    for w in projs:
        m, n = w.shape
        x = torch.randn((b, n) if b > 1 else (n,), generator=gen, device=dev)
        xq = quantize_activation(x, w.group_size)
        acts.append((w, xq))
        nbytes += call_bytes(w.qvalues, w.scales, xq.qvalues, xq.scales, b * m)
        nops += 2 * b * m * n
    kname, kfn = ("gqmm_int8", kern.gqmm_cuda) if b > 1 else ("gqmv_int8", kern.gqmv_cuda)

    def step(_):
        for w, xq in acts:
            kfn(w.qvalues, w.scales, xq.qvalues, xq.scales, group_size=w.group_size)

    k_ms, k_host = device_time_ms(step, 4, host_ms_guess=4.0)
    plain_us = {(r["m"], r["n"]): r["plain_us"] for r in rows
                if r["kernel"] == kname and r["b"] == b}
    p_ms = sum(plain_us[tuple(w.shape)] for w in projs) / 1e3
    bnd, by = bound_s(nbytes, nops)
    return {"ms": k_ms, "host_ms": k_host, "plain_ms": p_ms, "bound_ms": 1e3 * bnd,
            "bound_by": by}


def phase_serve(dev, rows) -> dict:
    cfg = load_config(ARCH)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=SERVE["seed"], device=dev)
    engine = InferenceEngine(model, params, cache_len=SERVE["prompt_len"] + SERVE["max_new_tokens"],
                             quantize=True, device=dev)
    del params
    torch.cuda.synchronize()
    log(f"[serve] {cfg.arch_id}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.param_dtype}, "
        f"int8 fraction {engine.quantized_fraction:.3f}, init+quantize "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SERVE["seed"])
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(SERVE["batch"], SERVE["prompt_len"])))}
    engine.generate(batch, 2)                               # warm-up
    torch.cuda.synchronize()

    kern.reset_launches()
    t0 = time.perf_counter()
    logits_k, _ = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = dict(kern.LAUNCHES)

    # the main path: counts zeroed just before, read just after
    kern.reset_launches()
    t0 = time.perf_counter()
    res = engine.generate(batch, SERVE["max_new_tokens"])
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)

    per_pass = 4 * cfg.num_layers + 1
    passes = 1 + SERVE["max_new_tokens"]
    if prefill_launches["gqmm_int8"] != per_pass:
        raise AssertionError(f"prefill launched GQMM {prefill_launches['gqmm_int8']} "
                             f"times, expected {per_pass}")
    if launches["gqmm_int8"] != per_pass * passes:
        raise AssertionError(f"generate launched GQMM {launches['gqmm_int8']} times, "
                             f"expected {per_pass} x {passes}")
    toks = res.tokens
    if toks.shape != (SERVE["batch"], SERVE["max_new_tokens"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_padded)).all()):
        raise AssertionError(f"bad tokens: shape {tuple(toks.shape)}")
    if not bool(torch.isfinite(res.logits_last).all()):
        raise AssertionError("non-finite logits")

    with ops.impl_scope("plain"):
        logits_p, _ = engine.prefill(batch)
        res_p = engine.generate(batch, SERVE["max_new_tokens"])
    lk, lp = logits_k.float(), logits_p.float()
    logit_err = (lk - lp).abs().max().item() / lp.abs().max().item()
    agree = (toks == res_p.tokens).float().mean().item()
    first_agree = (toks[:, 0] == res_p.tokens[:, 0]).float().mean().item()
    log(f"[serve] first-step logits kernel vs plain: max|diff|/max|logit| {logit_err:.3e} "
        f"(tol {LOGIT_TOL}); greedy-token agreement {agree:.4f} (first token {first_agree:.2f})")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"kernel logits differ from plain by {logit_err:.3e}")

    b, p, new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new_tokens"]
    t_decode = t_gen - t_prefill
    out = {"prefill_s": t_prefill, "generate_s": t_gen, "decode_s": t_decode,
           "prefill_tok_s": b * p / t_prefill, "decode_tok_s": b * new / t_decode,
           "decode_ms_per_step": 1e3 * t_decode / new,
           "launches": launches, "prefill_launches": prefill_launches,
           "logit_rel_err": logit_err, "token_agreement": agree}
    log(f"[serve] prefill {b}x{p}: {t_prefill * 1e3:.1f} ms ({out['prefill_tok_s']:.0f} tok/s); "
        f"decode {new} steps: {t_decode * 1e3:.1f} ms ({out['decode_tok_s']:.1f} tok/s, "
        f"{out['decode_ms_per_step']:.2f} ms/step); GQMM launches {launches['gqmm_int8']} "
        f"= {per_pass} x {passes}")

    # where the card's time goes: kernel time by name from the profiler
    logits0, cache = engine.prefill(batch)
    tok0 = logits0.argmax(-1)
    steps = iter(range(p, p + 8))
    dec = profile_device(lambda: engine.decode_step(tok0, cache, next(steps)), 3)
    pre = profile_device(lambda: engine.prefill(batch), 1)
    out.update({"decode_profile": dec, "prefill_profile": pre,
                "decode_device_busy_share": dec["device_ms"] / out["decode_ms_per_step"],
                "prefill_device_busy_share": pre["device_ms"] / (1e3 * t_prefill)})
    log(f"[serve] profiler: decode step {dec['device_ms']:.3f} ms of device time "
        f"({100 * out['decode_device_busy_share']:.1f} % of the {out['decode_ms_per_step']:.2f} ms "
        f"step), GQMM {dec['gqmm_ms']:.3f} ms, {dec['kernels']} kernels; prefill "
        f"{pre['device_ms']:.3f} ms ({100 * out['prefill_device_busy_share']:.1f} % busy), "
        f"GQMM {pre['gqmm_ms']:.3f} ms")
    for name, ms in dec["top"]:
        log(f"[serve]   decode {ms:8.4f} ms/step  {name[:90]}")

    projs = model_projections(engine.params)
    out["step_gqmm"] = step_timing(projs, SERVE["batch"], dev, rows)
    out["step_gqmv"] = step_timing(projs, 1, dev, rows)
    sm, sv = out["step_gqmm"], out["step_gqmv"]
    log(f"[serve] one pass of 89 projections: GQMM b={b} {sm['ms']:.3f} ms (plain "
        f"{sm['plain_ms']:.2f} ms, bound {sm['bound_ms']:.3f} ms); GQMV {sv['ms']:.3f} ms "
        f"(plain {sv['plain_ms']:.2f} ms, bound {sv['bound_ms']:.3f} ms)")

    # the matvec path: 1-D activations reach GQMV through quantized_matmul
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = [torch.randn((w.shape[1],), generator=gen, device=dev, dtype=torch.bfloat16)
          for w in projs]
    kern.reset_launches()
    ys = [ops.quantized_matmul(x, w) for x, w in zip(xs, projs)]
    torch.cuda.synchronize()
    out["matvec_launches"] = dict(kern.LAUNCHES)
    if out["matvec_launches"]["gqmv_int8"] != len(projs):
        raise AssertionError(f"matvec path launched GQMV {out['matvec_launches']['gqmv_int8']} "
                             f"times, expected {len(projs)}")
    err = 0.0
    for x, w, y in zip(xs, projs, ys):
        err = max(err, check_close("quantized_matmul 1-D", y,
                                   ops.quantized_matmul(x, w, impl="plain")))
    out["matvec_max_abs_err"] = err
    log(f"[serve] matvec path: {len(projs)} GQMV launches through quantized_matmul, "
        f"max|err| vs plain {err:.2e}")
    return out


# ---------------------------------------------------------------------------
# phase 4: golden tokens from the reference package
# ---------------------------------------------------------------------------

def phase_golden(dev) -> dict:
    golden = json.loads(GOLDEN_FILE.read_text())
    for k, v in GOLDEN.items():
        if golden[k] != v:
            raise AssertionError(f"{GOLDEN_FILE.name}: {k}={golden[k]!r}, this script uses {v!r}")
    cfg = golden_config()
    t0 = time.perf_counter()
    tree = init_params_numpy(cfg, GOLDEN["seed"])
    checksum = weights_checksum(tree)
    if checksum != golden["weights_checksum"]:
        raise AssertionError(f"numpy drew other weights than the golden run "
                             f"({checksum!r} vs {golden['weights_checksum']!r})")
    prompt = golden_prompt(cfg.vocab_size)
    if prompt.tolist() != golden["prompt"]:
        raise AssertionError("golden prompt differs")
    params = params_from_numpy(tree, dev)
    del tree
    engine = InferenceEngine(build(cfg), params, device=dev, quantize=True,
                             cache_len=GOLDEN["prompt_len"] + GOLDEN["max_new_tokens"])
    kern.reset_launches()
    res = engine.generate({"tokens": torch.as_tensor(prompt)}, GOLDEN["max_new_tokens"])
    launches = dict(kern.LAUNCHES)
    got = res.tokens.tolist()
    same = sum(a == b for ra, rb in zip(got, golden["tokens"]) for a, b in zip(ra, rb))
    total = GOLDEN["batch"] * GOLDEN["max_new_tokens"]
    log(f"[golden] {cfg.arch_id} d {cfg.d_model} x {cfg.num_layers} layers f32 int8: "
        f"{same}/{total} tokens equal the reference's ({time.perf_counter() - t0:.1f} s, "
        f"GQMM launches {launches['gqmm_int8']})")
    if got != golden["tokens"]:
        raise AssertionError(f"golden tokens differ:\n port {got}\n  ref {golden['tokens']}")
    return {"tokens_equal": same, "tokens_total": total, "launches": launches}


# ---------------------------------------------------------------------------

def kernel_entries(rows, serve) -> list[dict]:
    entries = []
    for kname, step_key, launches, path in (
            ("gqmm_int8", "step_gqmm", serve["launches"]["gqmm_int8"],
             f"InferenceEngine.generate, batch {SERVE['batch']}, prompt {SERVE['prompt_len']}, "
             f"{SERVE['max_new_tokens']} tokens"),
            ("gqmv_int8", "step_gqmv", serve["matvec_launches"]["gqmv_int8"],
             "ops.quantized_matmul on 1-D activations over the 89 projections")):
        mine = [r for r in rows if r["kernel"] == kname]
        step = serve[step_key]
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": step["ms"], "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
            "bound_by": step["bound_by"], "library_ms": None,
            "per": "one forward pass of the 89 TinyLlama projections at b="
                   + str(SERVE["batch"] if kname == "gqmm_int8" else 1),
            "path": path,
            "shapes": [{k: r[k] for k in ("shape", "m", "n", "b", "us", "plain_us",
                                          "bound_us", "max_abs_err")} for r in mine],
        })
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None, help="also write the full results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    # float32 matmuls in full precision: the plain versions and the f32 golden run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = cuda_build.build_all()
    log(f"[build] {len(built)} librar{'y' if len(built) == 1 else 'ies'} in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{b.name} ({'cached' if b.cached else f'{b.seconds:.1f} s'})"
                    for b in built.values()))
    for b in built.values():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {b.name}: {line.strip()}")

    rows = phase_kernels(dev)
    serve = phase_serve(dev, rows)
    golden = phase_golden(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    entries = kernel_entries(rows, serve)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(
            {"card": smi, "kernel_rows": rows, "serve": serve, "golden": golden,
             "kernels": entries, "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
