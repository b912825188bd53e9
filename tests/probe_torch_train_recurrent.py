#!/usr/bin/env python3
"""Peak memory and step time of the recurrent families' train step on one
CUDA card at chosen depths, the numbers that set ``chip_smoke.py``'s
``TRAIN_RECURRENT`` depth cuts:

    python tests/probe_torch_train_recurrent.py [--arch rwkv6-7b zamba2-7b] \
        [--layers N ...] [--steps 4] [--profile] [--blockwise N] [--out FILE]

For each arch and each depth in ``--layers`` (full width, bf16; the depth
cut to N layers), ``chip_smoke.train_recurrent_run`` with the train CLI's
defaults (batch 8 x seq 128, lr 3e-4) for ``--steps`` steps: ms a step on
the host clock and on the card (CUDA events), the peak memory allocated
and reserved (torch.cuda), and the reckoning of ``chip_smoke.train_memory``
(12 bytes a parameter of state, 24 at the update). With ``--profile``, one
more step under torch.profiler: its kernels' time summed (the card's busy
time, against the step's span), the kernel count and the heaviest kernels.
With ``--blockwise N``, zamba2's 1 x 2048 step under blockwise_attention and
chunked_ssd at N layers (``chip_smoke.train_blockwise``, the kernels built
first). Run from the root of a checkout; imports ``chip_smoke``.

Prints one line per reading and, with --out, writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=list(cs.TRAIN_RECURRENT))
    ap.add_argument("--layers", nargs="+", type=int, default=None,
                    help="depths to run (default: chip_smoke.TRAIN_RECURRENT's)")
    ap.add_argument("--steps", type=int, default=cs.TRAIN_RECURRENT_STEPS)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--blockwise", type=int, default=None, metavar="N")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)      # the allocator's statistics exist from here
    cs.CARD["smi"] = cs.card()
    cs.TRAIN_RECURRENT_STEPS = args.steps
    out = {"card": cs.CARD["smi"], "torch": torch.__version__, "runs": []}
    for arch in args.arch:
        for layers in args.layers or [cs.TRAIN_RECURRENT[arch]]:
            cs.TRAIN_RECURRENT[arch] = layers
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            r = cs.train_recurrent_run(dev, arch)
            r.update({"max_reserved": torch.cuda.max_memory_reserved(dev),
                      "seconds": time.perf_counter() - t0})
            if args.profile:
                cfg, model, data, opt_cfg = cs.train_setup(dev, cs.TRAIN["seq"],
                                                           cs.TRAIN["batch"], layers, arch)
                params = model.init(seed=cs.TRAIN["seed"], device=dev)
                opt_state = cs.adamw.init(params)
                step_fn = cs.make_train_step(model, opt_cfg)
                batch = cs.batch_to(data.batch_at(0), dev)
                r["profile"] = cs.profile_device(lambda: step_fn(params, opt_state, batch), 1)
                r["busy_share"] = r["profile"]["device_ms"] / r["card_ms_per_step"]
                del params, opt_state
                torch.cuda.empty_cache()
            cs.log(f"[probe] {arch} {layers} layers: peak allocated {r['peak_bytes'] / 1e9:.2f} "
                   f"GB, reserved {r['max_reserved'] / 1e9:.2f} GB; {r['ms_per_step']:.1f} ms a "
                   f"step (host), {r['card_ms_per_step']:.1f} on the card"
                   + (f"; profiled step: kernels {r['profile']['device_ms']:.1f} ms "
                      f"({100 * r['busy_share']:.1f} % of the span), {r['profile']['kernels']} "
                      "kernels, top " + ", ".join(f"{k[:50]} {v:.1f}"
                                                  for k, v in r["profile"]["top"][:6])
                      if args.profile else "") + f" [{cs.CARD['smi']}]")
            out["runs"].append(r)
            torch.cuda.empty_cache()
    if args.blockwise:
        cs.cuda_build.build_all()
        torch.cuda.reset_peak_memory_stats(dev)
        bw = cs.train_blockwise(dev, "zamba2-7b", args.blockwise, "(f)", chunked_ssd=True)
        bw["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["blockwise"] = bw
        cs.log(f"[probe] zamba2 blockwise {args.blockwise} layers: peak "
               f"{bw['peak_bytes'] / 1e9:.2f} GB, leaves within {cs.TRAIN_LEAF_TOL}: "
               f"{bw['leaves_within_tol']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
