"""Trace where the port's golden run on the card first leaves its run on the CPU.

    PYTHONPATH=src python tests/trace_torch_card.py [FORMAT ...] [--layers N] [--against NPZ]

Run on a machine with a CUDA card. For each weight setting (default: int8
int4 int3 fp8 mixed mixed3) it builds the golden configuration
(``chip_smoke.GOLDEN``: TinyLlama at full width, 2 layers, f32, the golden
weights and prompt), quantizes it with the port, and runs ``generate`` three
ways: on the card with the CUDA kernels, on the card with the plain
versions, and on the CPU with the plain versions; it prints each run's
agreement with the reference's golden tokens. Then it replays the golden
tokens through prefill and every decode step on the card (kernels) and on
the CPU in lockstep, records the input of every quantized projection, and
prints, for each batch row, the first calls (up to EVENTS) in which the two
devices round an int8 activation differently: step, projection, the float
inputs' largest difference in that row, and for the first flips the
position and column and each device's x and x / S. A first flip whose
float inputs agree to f32 rounding and whose x / S lies within a few ulp of
a .5 boundary is a tie; the later ones follow from it. With
``--layers 22`` (int8 only) it does the same for the deep golden
(``chip_smoke.GOLDEN_DEEP``): ~3 minutes, most of it the CPU's 22-layer
runs. ``--against NPZ`` (one format) holds the card's replay to the
REFERENCE's activations instead, as ``tests/trace_torch_golden.py --dump``
wrote them on the CPU for the same setting, depth and tokens, and skips the
CPU runs. ``--spec K`` (card only) holds the speculative verify path to
vanilla decode instead: the golden tokens replayed through verify chunks of
K that advance one token a step (chunk row 0 carries the step: the
arithmetic of a speculative run whose drafts are all rejected) against the
same tokens through decode steps, the first int8 rounding each batch row
makes differently printed the same way. Imports the port only (no JAX),
like ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402


EVENTS = 4


def _equal(a, b) -> int:
    return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def _replay(engine, prompt, tokens) -> list[list]:
    """Prefill, then decode the given tokens; every quantized projection's
    (x, xq, xs) per forward pass, on the host."""
    calls: list = []
    qmm = ops.quantized_matmul

    def record(x, w, *, impl=None):
        q = ops.quantize_activation(x, group_size=w.group_size)
        calls[-1].append([t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                          for t in (x, q.qvalues, q.scales)])
        return qmm(x, w, impl=impl)

    ops.quantized_matmul = record
    try:
        with torch.inference_mode():
            calls.append([])
            _, cache = engine.prefill({"tokens": torch.as_tensor(prompt)})
            for step in range(tokens.shape[1] - 1):
                calls.append([])
                tok = torch.as_tensor(tokens[:, step]).to(engine.device)
                _, cache = engine.decode_step(tok, cache, prompt.shape[1] + step)
    finally:
        ops.quantized_matmul = qmm
    return calls


def _verify_replay(engine, prompt, tokens, k: int) -> list[list]:
    """Prefill, then one verify chunk a step, tokens[:, s:s + k] (the last
    repeated past the end), committing its first row only: every quantized
    projection's (x, xq, xs) of chunk row 0 per forward pass, on the host
    (prefill: all positions)."""
    calls: list = []
    qmm = ops.quantized_matmul

    def record(x, w, *, impl=None):
        q = ops.quantize_activation(x, group_size=w.group_size)
        row0 = [t[:, 0] if x.ndim == 3 and calls[-1] is not prefill else t
                for t in (x, q.qvalues, q.scales)]
        calls[-1].append([t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()
                          for t in row0])
        return qmm(x, w, impl=impl)

    b, n = tokens.shape
    padded = np.concatenate([tokens, np.repeat(tokens[:, -1:], k, 1)], 1)
    prefill: list = []
    ops.quantized_matmul = record
    try:
        with torch.inference_mode():
            calls.append(prefill)
            _, cache = engine.prefill({"tokens": torch.as_tensor(prompt)})
            pos = torch.full((b,), prompt.shape[1], dtype=torch.long, device=engine.device)
            one = torch.ones((b,), dtype=torch.long, device=engine.device)
            for step in range(n - 1):
                calls.append([])
                chunk = torch.as_tensor(padded[:, step:step + k]).to(engine.device)
                _, rows = engine.model.verify(engine.params, chunk, cache, pos)
                engine.model.commit_verify(cache, rows, pos, one)
                pos += 1
    finally:
        ops.quantized_matmul = qmm
    return calls


def _dumped(path, tokens) -> list[list]:
    """The reference's (x, xq, xs) per forward pass from a trace dump."""
    d = np.load(path)
    if not np.array_equal(d["tokens"], tokens):
        raise SystemExit(f"{path} was traced on other tokens than the golden file's")
    return [[(d[f"s{st}_c{i}_x"], d[f"s{st}_c{i}_q"], d[f"s{st}_c{i}_s"])
             for i in range(int(d["calls"]))] for st in range(int(d["steps"]))]


def main(formats, layers: int | None = None, against: str | None = None,
         spec: int | None = None) -> None:
    g = chip_smoke.GOLDEN
    golden = json.loads(chip_smoke.GOLDEN_FILE.read_text())
    cfg = chip_smoke.golden_config(layers)
    tree = init_params_numpy(cfg, g["seed"])
    prompt = chip_smoke.golden_prompt(cfg.vocab_size)
    cache_len = g["prompt_len"] + g["max_new_tokens"] + (spec or 0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build(cfg)
    names = ["wqkv", "wo", "w13", "w2"] * cfg.num_layers + ["classifier"]
    for fmt in formats:
        if layers and layers != g["num_layers"]:
            want = golden["deep"]["tokens"][fmt]
        else:
            want = golden["tokens"] if fmt == "int8" else golden["formats"][fmt]
        devs = ("cuda",) if against or spec else ("cuda", "cpu")
        engines = {d: InferenceEngine(model, params_from_numpy(tree, d), quantize=fmt,
                                      cache_len=cache_len, device=d) for d in devs}
        runs = {}
        for label, dname, impl in (("card kernels", "cuda", "auto"),
                                   ("card plain", "cuda", "plain"),
                                   ("cpu plain", "cpu", "auto"))[:len(devs) + 1]:
            with ops.impl_scope(impl):
                toks = engines[dname].generate({"tokens": torch.as_tensor(prompt)},
                                               g["max_new_tokens"]).tokens.tolist()
            runs[label] = _equal(toks, want)
        total = g["batch"] * g["max_new_tokens"]
        print(f"{fmt}: tokens equal to the reference's: "
              + ", ".join(f"{k} {v}/{total}" for k, v in runs.items()), flush=True)
        tokens = np.asarray(want)
        card = _replay(engines["cuda"], prompt, tokens)
        if spec:
            cpu = _verify_replay(engines["cuda"], prompt, tokens, spec)
            other = f"verify (k {spec})"
            sp = engines["cuda"].generate({"tokens": torch.as_tensor(prompt)},
                                          g["max_new_tokens"], spec_k=spec)
            print(f"{fmt}: speculative generate (k {spec}) on the card: "
                  f"{_equal(sp.tokens.tolist(), want)}/{total} tokens equal the reference's; "
                  f"{sp.spec_stats}", flush=True)
        else:
            cpu = _dumped(against, tokens) if against else _replay(engines["cpu"], prompt,
                                                                   tokens)
            other = "reference" if against else "cpu"
        for row in range(tokens.shape[0]):
            events = []          # (step, call) where the row's int8 activations differ
            for step, (cs, ps) in enumerate(zip(card, cpu)):
                for i, pair in enumerate(zip(cs, ps)):
                    # both sides as (b, positions, width): a decode step has one position
                    (x0, q0, s0), (x1, q1, s1) = (
                        [a.reshape(tokens.shape[0], -1, a.shape[-1])[row] for a in side]
                        for side in pair)
                    flips = np.argwhere(q0 != q1)
                    if len(flips) and len(events) < EVENTS:
                        events.append((step, i, x0, s0, x1, s1, flips))
            if not events:
                print(f"  {fmt} row {row}: no int8 activation differs between card and "
                      f"{other} over the replay")
            for step, i, x0, s0, x1, s1, flips in events:
                gs = x0.shape[-1] // s0.shape[-1]
                print(f"  {fmt} row {row}: int8 flips at "
                      f"{'prefill' if step == 0 else f'decode step {step}'}, call {i} "
                      f"({names[i]}, layer {i // 4}); the row's float inputs max|dx| "
                      f"{np.abs(x0 - x1).max():.3e} at max|x| {np.abs(x1).max():.3e}; "
                      f"{len(flips)} flips")
                for j in flips[:3]:
                    j = tuple(int(k) for k in j)
                    grp = (*j[:-1], j[-1] // gs)
                    print(f"    at {j}: card x={x0[j]!r} x/S={x0[j] / s0[grp]!r}; "
                          f"{other} x={x1[j]!r} x/S={x1[j] / s1[grp]!r}", flush=True)
        del engines, card, cpu


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("formats", nargs="*", default=["int8", *chip_smoke.FORMAT_SETTINGS])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--spec", type=int, default=None)
    a = ap.parse_args()
    main(a.formats, a.layers, a.against, a.spec)
