"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of the uniform-batch path of ``repro/launch/serve.py``: random
weights from ``--seed``, group-wise W8A8 PTQ unless ``--no-quantize``, then
a batch of greedy requests, timed warm (first call) and hot. Runs on
``--device cuda`` by default; pass ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import build, load_config
from repro_torch.serving.engine import InferenceEngine


def _timed(engine: InferenceEngine, batch, steps: int):
    t0 = time.perf_counter()
    res = engine.generate(batch, steps)     # tokens come back to the host: synchronised
    return res, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=64, help="tokens to generate")
    ap.add_argument("--no-quantize", action="store_true",
                    help="float weights instead of the paper's W8A8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.arch)
        device = resolve_device(args.device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    params = model.init(seed=args.seed, device=device)
    engine = InferenceEngine(model, params, cache_len=args.prompt_len + args.steps,
                             quantize=not args.no_quantize, device=device)
    print(f"arch: {cfg.arch_id}  device: {device}  quantized bytes fraction: "
          f"{engine.quantized_fraction:.3f}")

    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)))}
    _, warm = _timed(engine, batch, args.steps)
    res, hot = _timed(engine, batch, args.steps)
    toks = args.batch * args.steps
    print(f"generated {toks} tokens: warm {warm:.2f}s, hot {hot:.2f}s "
          f"({toks / hot:.2f} tok/s)")
    print("first sequence:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
