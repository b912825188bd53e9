"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Counterpart of ``repro/launch/serve.py``: an arch (``--arch``, one of
``registry.PORTED_ARCHS``, all 11 configs), full size or ``--reduced``,
random weights from ``--seed``, group-wise PTQ unless ``--no-quantize``
(the config's W8A8, or ``--quantize-format``
int8/int4/int3/fp8/mixed/mixed3), optionally a quantized KV cache
(``--kv-quant int8|fp8``), then requests, greedy or ``--sampler top_p``
(``--top-p``, ``--temperature``), optionally speculative (``--spec-k``,
``--drafter ngram|model:<arch-id>``), timed warm (first call) and hot: a
uniform batch through ``InferenceEngine.generate``, or with ``--ragged`` a
mixed-length trace through ``serve_ragged`` (``--mode``
auto/paged/continuous/bucketed, ``--slots``, ``--block-size``; auto takes
the family's preferred mode: paged, or continuous for the MLA and the
recurrent archs). The encoder-decoder (seamless-m4t-large-v2) serves
``generate`` with frame embeddings (batch, prompt_len, d_model) drawn after
the prompt, as the reference does; its ``--ragged`` exits (the bucketed
path gives the encoder no frames). What a family lacks (a paged cache,
``--spec-k``, ``--kv-quant`` on the MLA, recurrent and encoder-decoder
archs) exits with the reference's error. ``--sanitize`` arms repro-san
(analysis/sanitizer.py; as ``REPRO_SAN=1`` does). Runs on ``--device cuda`` by
default; pass ``--device cpu`` to run on the CPU. Prints the captured
programs by name (``serving/graphs.py``): how many, and their warm-up and
capture seconds (on the CPU the programs run eagerly and none is
captured).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.policy import format_breakdown
from repro_torch.device import resolve_device
from repro_torch.models.registry import PORTED_ARCHS, build, load_config
from repro_torch.serving.batching import Request, bucket_length, resolve_mode, serve_ragged
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.spec import resolve_drafter


def _timed(engine: InferenceEngine, batch, steps: int, **kw):
    t0 = time.perf_counter()
    res = engine.generate(batch, steps, **kw)   # tokens come back to the host: synchronised
    return res, time.perf_counter() - t0


def _report_programs(engine: InferenceEngine) -> None:
    for name, st in sorted(engine.graphs.stats().items()):
        print(f"program {name}: {st['builds']} built, {st['captured']} captured "
              f"(warm-up {st['warmup_s']:.2f}s, capture {st['capture_s']:.2f}s, "
              f"graph pool {st['pool_bytes'] / 1e6:.1f}MB)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, help=f"ported: {', '.join(PORTED_ARCHS)}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=64, help="tokens to generate")
    ap.add_argument("--no-quantize", action="store_true",
                    help="float weights instead of the paper's W8A8")
    ap.add_argument("--quantize-format", default=None,
                    help="registry format (int8, int4, int3, fp8) or policy preset "
                         "(mixed, mixed3); default: the arch config's quant_format")
    ap.add_argument("--kv-quant", default=None, choices=["int8", "fp8"],
                    help="store the KV cache quantized (per-row scales, "
                         "dequantized in the attention kernel)")
    ap.add_argument("--sampler", default="greedy", choices=["greedy", "top_p"])
    ap.add_argument("--top-p", type=float, default=0.9,
                    help="nucleus mass for --sampler top_p")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature for --sampler top_p")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ragged", action="store_true",
                    help="serve a mixed-length trace through serve_ragged "
                         "(paged/continuous-batching scheduler where supported)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots for --ragged continuous batching")
    ap.add_argument("--mode", default="auto",
                    help="--ragged scheduler: auto, paged, continuous, or bucketed "
                         "(auto prefers paged; validated against the arch's capabilities)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="KV block size (tokens) for the paged scheduler")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode chunk: verify the current token plus "
                         "spec_k-1 drafted candidates a forward pass (0 = off; needs >= 2)")
    ap.add_argument("--drafter", default="ngram",
                    help="speculative drafter: 'ngram' (prompt lookup, no weights) or "
                         "'model:<arch-id>' (a small registry model, greedy drafts)")
    ap.add_argument("--sanitize", action="store_true",
                    help="repro-san debug mode: shadow block/slot tracking, poison-on-free "
                         "use-after-free detection, NaN/Inf tripwires (equivalent to "
                         "REPRO_SAN=1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sampler_kw = ({"p": args.top_p, "temperature": args.temperature}
                  if args.sampler == "top_p" else None)
    spec_k = args.spec_k or None
    if spec_k and args.kv_quant:
        ap.error("--kv-quant is incompatible with --spec-k (the verify chunk commits float "
                 "rows; quantized rows cannot be partially rewritten)")

    try:
        cfg = load_config(args.arch)
        device = resolve_device(args.device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        ap.error(str(e))
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    params = model.init(seed=args.seed, device=device)
    drafter = None
    if spec_k:
        try:
            drafter = resolve_drafter(args.drafter, reduced=args.reduced, seed=args.seed + 7,
                                      device=device)
        except (ValueError, NotImplementedError) as e:
            ap.error(str(e))
    gen_kw = dict(sampler=args.sampler, sampler_kw=sampler_kw, spec_k=spec_k, drafter=drafter)
    cache_len = args.prompt_len + args.steps + (spec_k or 0)
    if args.ragged:
        # ragged prompts are padded up to power-of-two buckets
        cache_len = max(cache_len, bucket_length(args.prompt_len))
    quantize: bool | str = not args.no_quantize
    if quantize and args.quantize_format is not None:
        quantize = args.quantize_format
    try:
        engine = InferenceEngine(model, params, cache_len=cache_len, quantize=quantize,
                                 kv_quant=args.kv_quant, device=device,
                                 sanitize=True if args.sanitize else None)
    except ValueError as e:
        ap.error(str(e))
    breakdown = format_breakdown(engine.params)
    print(f"arch: {cfg.arch_id}  device: {device}  quantized bytes fraction: "
          f"{engine.quantized_fraction:.3f}  "
          + "  ".join(f"{k}: {v / 1e6:.2f}MB" for k, v in sorted(breakdown.items()))
          + f"  kv cache: {args.kv_quant or cfg.param_dtype}")

    rng = np.random.default_rng(args.seed)
    if args.ragged:
        lengths = rng.integers(2, args.prompt_len + 1, size=(args.batch,))
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=(n,)).tolist())
                for i, n in enumerate(lengths)]
        try:
            mode = resolve_mode(engine, args.mode)    # resolved for the report
        except ValueError as e:
            ap.error(str(e))                          # lists the valid modes
        kw = dict(slots=args.slots, mode=mode, block_size=args.block_size, **gen_kw)
        try:
            serve_ragged(engine, reqs, args.steps, **kw)  # warm
        except (ValueError, NotImplementedError) as e:
            # e.g. --spec-k with bucketed, encdec; --sanitize on a quantized pool
            ap.error(str(e))
        t0 = time.perf_counter()
        out = serve_ragged(engine, reqs, args.steps, seed=args.seed + 1, **kw)
        hot = time.perf_counter() - t0
        toks = sum(r.length for r in out)
        print(f"ragged ({mode}, lengths {sorted(lengths.tolist())}): "
              f"{toks} tokens in {hot:.2f}s ({toks / hot:.2f} tok/s)")
        print("first sequence:", out[0].tokens[:16].tolist())
        _report_programs(engine)
        return out

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)))}
    if cfg.model_type == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32))
    try:
        _, warm = _timed(engine, batch, args.steps, **gen_kw)
    except ValueError as e:
        ap.error(str(e))                              # e.g. --spec-k on a recurrent arch
    res, hot = _timed(engine, batch, args.steps, seed=args.seed + 1, **gen_kw)
    toks = args.batch * args.steps
    print(f"generated {toks} tokens: warm {warm:.2f}s, hot {hot:.2f}s "
          f"({toks / hot:.2f} tok/s)")
    if res.spec_stats:
        st = res.spec_stats
        print(f"speculative ({drafter.name}): {st['verify_steps']} verify steps for "
              f"{st['generated']} tokens ({st['verify_steps'] / max(st['generated'], 1):.2f} "
              f"fwd/tok, acceptance {st['accepted'] / max(st['drafted'], 1):.2f})")
    print("first sequence:", res.tokens[0, :16].tolist())
    _report_programs(engine)
    return res


if __name__ == "__main__":
    main()
