"""Where a family's prefill on the card leaves its plain version, layer by layer.

    PYTHONPATH=src python tests/trace_torch_families.py [--arch ID] [--layers N] [--seeds K]

Run on a machine with a CUDA card. It builds the arch at full width, cut to
N layers (default: ``chip_smoke.FAMILIES``' depth), with the port's own
random weights (seed 0) and int8 weights, and runs one 1 x
``chip_smoke.FAMILY_PATCH_PROMPT`` prefill (``chip_smoke.patch_batch``:
for pixtral-12b the first positions are patch embeddings drawn N(0, 1))
with the CUDA kernels and with their plain versions on the same weights.
It prints, for K prompt seeds, the last position's logits difference as a
fraction of max|logit| (what ``chip_smoke.py`` holds to ``LOGIT_TOL``), with
and without the patch embeddings, and for the first seed the residual
stream's difference after each layer, at the last position and at the
worst one, as a fraction of that row's max|x|; then the first seed with
the patch embeddings scaled to the token embeddings' 0.02. Then the model
in f32 (f32 weights and compute, int8 projections): the same per-layer
view, the plain run with every kernel launched beside it (its logits must
not move: no kernel acts outside its output), the plain run with layer 0's
first projection output moved one f32 ulp (how far the model carries a
rounding-sized change), and each projection's kernel output against its
plain version on the same input. A kernel-vs-plain gap that the one-ulp
move matches, with every projection within f32 rounding and no side
effect, is the model's sensitivity, not a kernel's fault. Imports the port
only (no JAX).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402


def _layers(engine, batch, mode: str) -> tuple[torch.Tensor, list]:
    """``chip_smoke.prefill_logits`` in ``mode``, with each layer's output."""
    block, record = transformer._block, []

    def recorded(*a, **k):
        out = block(*a, **k)
        record.append(out.float())
        return out

    transformer._block = recorded
    try:
        return chip_smoke.prefill_logits(engine, batch, mode), record
    finally:
        transformer._block = block


def _batch(cfg, seed: int, patch_scale: float | None) -> dict:
    batch = chip_smoke.patch_batch(cfg, seed)
    if patch_scale is None or cfg.frontend != "patch_embed":
        return {"tokens": batch["tokens"]}
    return dict(batch, patch_embeds=batch["patch_embeds"] * np.float32(patch_scale))


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _compare(engine, batch, per_layer: bool) -> tuple[float, list]:
    lk, rk = _layers(engine, batch, "kernel")
    lp, rp = _layers(engine, batch, "plain")
    layers = []
    if per_layer:
        for i, (a, b) in enumerate(zip(rk, rp)):
            rows = ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()
            layers.append((i, _rel(a[:, -1], b[:, -1]), rows))
    return _rel(lk, lp), layers


def _calls(engine, batch) -> list[tuple]:
    """Each projection of one kernel prefill against its plain version on the
    same input: (call, x shape, w shape, max|diff| / max|plain|)."""
    out = []

    def run(qmm, x, w):
        y = qmm(x, w, impl="cuda")
        out.append((len(out), tuple(x.shape), tuple(w.shape),
                    _rel(y, qmm(x, w, impl="plain"))))
        return y

    with torch.inference_mode(), chip_smoke.projections_as(run):
        engine.prefill(batch)
    return out


def _print_layers(layers) -> None:
    for i, last, rows in layers:
        print(f"    after layer {i:2d}: last position {last:.3e}, worst position "
              f"{rows:.3e} of its max|x|")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="pixtral-12b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cpu: a dry run of the plain versions")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trace_torch_families: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.card() if dev.type == "cuda" else "cpu dry run"
    cfg = chip_smoke.family_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    cache = chip_smoke.FAMILY_PATCH_PROMPT

    def engine_of(c):
        model = build(c)
        return InferenceEngine(model, model.init(seed=0, device=dev), quantize=True,
                               cache_len=cache, device=dev)

    engine = engine_of(cfg)
    print(f"{args.arch}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.param_dtype}, int8 "
          f"weights; 1 x {cache} prefill, kernels against plain [{smi}]")
    for seed in range(args.seeds):
        err, layers = _compare(engine, _batch(cfg, seed, 1.0), per_layer=seed == 0)
        text, _ = _compare(engine, _batch(cfg, seed, None), per_layer=False)
        print(f"seed {seed}: logits {err:.3e} of max|logit| (text only: {text:.3e})")
        _print_layers(layers)
    err, _ = _compare(engine, _batch(cfg, 0, 0.02), per_layer=False)
    print(f"seed 0, patch embeddings x 0.02: logits {err:.3e}")
    del engine
    torch.cuda.empty_cache()
    f32 = engine_of(dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"))
    batch = _batch(cfg, 0, 1.0)
    err, layers = _compare(f32, batch, per_layer=True)
    print(f"seed 0, f32 model: logits {err:.3e}")
    _print_layers(layers)
    base = chip_smoke.prefill_logits(f32, batch, "plain")
    for mode in ("shadow", "ulp"):
        print(f"f32 model, plain run {mode}: logits "
              f"{_rel(chip_smoke.prefill_logits(f32, batch, mode), base):.3e} from the plain "
              "run's")
    calls = _calls(f32, batch)
    worst = max(calls, key=lambda c: c[-1])
    print(f"f32 model, each projection's kernel output against its plain version on the same "
          f"input: {len(calls)} calls, the worst {worst[-1]:.3e} (call {worst[0]}, x "
          f"{worst[1]}, w {worst[2]})")


if __name__ == "__main__":
    main()
