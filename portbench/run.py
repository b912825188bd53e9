"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``portbench/configs/<config>.json``: the
published config, the port's fields under ``port``, the weight format) and a
traffic mix (``portbench/traffic/<traffic>.json``). The run draws the float
weights on the card from the seed, lets the engine quantize them, captures
every program the cell's calls replay (set-up), then runs whole passes over
the seed's requests back to back until ``--seconds`` have passed (the
window). ``--trace 1`` then profiles the pass's first requests once more
(``portbench/trace.py``): where the mix decodes, once to their first token and
once cut to the mix's trace length, and the per-layer readers read the
difference, the decode steps alone. Afterwards the program's state is freed and a sample of the served tokens is held to the
plain reference (``portbench/check.py``) against the cell's limits
(``portbench/limits/<cell>.json``).

Each metric is read by ``portbench/metrics/<metric>.py``, or by the file of
its name without its last suffix (``device_idle_pct.tok`` and ``.ttft`` share
``device_idle_pct.py``): ``read(run)``; None leaves it out. The cell's
end-to-end metrics are read with ``--trace 0``, its per-layer metrics with
``--trace 1``. The last line of standard output is the
result as JSON; the numbers compared, with their limits, are the last lines
of standard error and the result's last key.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()          # set-up starts with the process

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# the torch extension cache at a fixed path inside the checkout (the port's
# own nvcc builds already live under its build/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX one or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read.

    ``setup_s``, ``window_s``: host seconds. ``calls``: each call of the
    window, {"start", "end" (perf_counter s), "requests": [(prompt tokens,
    served tokens)]}. ``decode_steps``: the program's decode steps in the
    window; ``slots``: the mix's decode slots (None for ``generate``).
    ``window_captures``: programs built inside the window; ``capture_s``:
    warm-up and capture seconds of set-up. ``work`` / ``gqmm_work``:
    ``counts.Work`` the window's inputs need (all of it / the projections a
    GQMM runs). ``trace``: ``trace.reduce``'s numbers of the traced call, or
    of its decode steps (``trace.difference``), or None."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def served_tokens(self) -> int:
        return sum(s for c in self.calls for _, s in c["requests"])

    @property
    def prompt_tokens(self) -> int:
        return sum(p for c in self.calls for p, _ in c["requests"])

    @property
    def latencies_ms(self) -> list[float]:
        return [1e3 * (c["end"] - c["start"]) for c in self.calls]


def load_cell(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {', '.join(sorted(cells))}")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell,
            "config": json.loads((ROOT / config["file"]).read_text()),
            "mix": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``, else of the file of the name
    without its last suffix."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window_work(shape: dict, quant: dict, run_calls: list, entry: str):
    """The work the window's inputs need (``counts``), all of it and the
    projections a GQMM runs. A ``generate`` request decodes its tokens after
    the first, one step each; a serve call's decode steps are the
    scheduler's, and its prefills share one read of the weights."""
    from portbench import counts

    full, gq = counts.Work(), counts.Work()
    for c in run_calls:
        lens = [p for p, _ in c["requests"]]
        ctx = [x for p, s in c["requests"] for x in counts.request_contexts(p, s)]
        steps = max(s for _, s in c["requests"]) - 1 if entry == "generate" else c["steps"]
        full = full + counts.prefill(shape, quant, lens) + counts.decode(shape, quant, steps, ctx)
        gq = (gq + counts.prefill(shape, quant, lens, gqmm_only=True)
              + counts.decode(shape, quant, steps, ctx, gqmm_only=True))
    return full, gq


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             shape: dict | None = None, mix: dict | None = None, limits: dict | None = None,
             weight_format: str | None = None, t0: float | None = None) -> dict:
    """One run of cell ``name``; returns the result (its ``checks`` last).
    ``shape``, ``mix``, ``limits`` and ``weight_format`` replace the cell's
    own (the CPU tests' small sizes, the control's int4 weights)."""
    import torch

    from portbench import check, drive
    from portbench import trace as tr
    from portbench import traffic as tf
    from portbench import weights as W

    t0 = T0 if t0 is None else t0
    c = load_cell(name)
    shape = shape or c["config"]["port"]
    mix = mix or c["mix"]
    limits = limits or c["limits"]
    quant = c["config"]["quant"]            # the configuration's: the reference's
    dev = torch.device(device)

    # set-up: weights from the seed, the engine's own quantization, captures
    params = W.build_tree(shape, seed, dev)
    system = drive.System(shape, mix, params, weight_format or quant["format"], dev)
    del params
    reqs = tf.requests(mix, seed, shape["vocab_size"])
    calls = tf.calls(mix, reqs)
    system.warm(calls)
    st0 = system.program_stats()
    setup_s = time.perf_counter() - t0

    # the window: whole passes until `seconds` have passed
    done, run_calls, spans = [], [], []

    def serve(reqs_c: list) -> dict:
        a = time.perf_counter()
        served = system.call(reqs_c)
        b = time.perf_counter()
        spans.append((mix["entry"], int(a * 1e9), int(b * 1e9)))
        return {"start": a, "end": b, "steps": system.decode_steps, "served": served,
                "requests": [(len(r.tokens), len(x)) for r, x in zip(reqs_c, served)]}

    w0 = time.perf_counter()
    while True:
        for reqs_c in calls:
            c_ = serve(reqs_c)
            run_calls.append(c_)
            done.extend({"prompt": list(r.tokens), "served": x, "budget": r.max_new}
                        for r, x in zip(reqs_c, c_.pop("served")))
        if time.perf_counter() - w0 >= seconds:
            break
    w1 = time.perf_counter()
    st1 = system.program_stats()
    traced = []                 # (Slice, call) of each traced call
    if trace and dev.type == "cuda":
        # the traced calls: the pass's first requests once more, cut to
        # `tokens` tokens; where that decodes, first cut to their first token
        # (their prefill alone), so that the difference is the decode steps
        k, n = mix["trace"]["requests"], mix["trace"]["tokens"]
        for cut, label in ([(1, "traced prefill")] if n > 1 else []) + [(n, "traced call")]:
            sub = [tf.Req(r.id, r.tokens, min(r.max_new, cut)) for r in reqs[:k]]
            sl = tr.Slice()
            call = sl.profile_call(lambda s=sub: serve(s), spans, label)
            call.pop("served")
            traced.append((sl, call))
        captures = system.program_stats()["builds"] - st1["builds"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        kind, count = torch.cuda.get_device_name(dev), 1
    else:
        peak, kind, count = 0, "cpu", 1
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    w2 = time.perf_counter()
    failed = sum(len(d["served"]) != d["budget"] for d in done)
    whole = [d for d in done if len(d["served"]) == d["budget"]]
    sample = check.pick(whole, mix["check_requests"], seed)
    got = check.logit_gaps(shape, quant, seed, dev, sample) if sample else {}
    checks = {k: {"value": got.get(k), "limit": lim} for k, lim in limits.items()}
    checks["failed"] = {"value": failed, "limit": 0}
    checks["tokens_compared"] = {"value": got.get("tokens_compared", 0), "limit": 1}
    w3 = time.perf_counter()
    correct = (all(c["value"] is not None and c["value"] <= c["limit"]
                   for k, c in checks.items() if k != "tokens_compared")
               and checks["tokens_compared"]["value"] >= 1)

    full, gq = window_work(shape, quant, run_calls, mix["entry"])
    reds = []
    for sl, call in traced:
        r = tr.reduce(sl, spans)
        if r is not None:
            r["work"], r["gqmm_work"] = window_work(shape, quant, [call], mix["entry"])
            r["tokens"] = sum(x for _, x in call["requests"])
        reds.append(r)
    red = reds[-1] if reds and None not in reds else None
    per_layer = red if len(reds) < 2 or red is None else tr.difference(red, reds[0])
    run = Run(setup_s=setup_s, window_s=w1 - w0, calls=run_calls,
              decode_steps=sum(cl["steps"] for cl in run_calls),
              slots=mix.get("slots") if mix["entry"] == "serve_ragged" else None,
              window_captures=st1["builds"] - st0["builds"], capture_s=st0["capture_s"],
              work=full, gqmm_work=gq, trace=per_layer)
    metrics = {}
    for m in c["per_layer" if trace else "end_to_end"]:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
               "count": count, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(done), "failed": failed,
           "metrics": metrics, "device": devinfo}
    if trace:
        if red is not None:
            devinfo.update(busy_s=red["busy_s"], window_s=red["window_s"])
            out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        out["trace_info"] = {"events": [r and r["events"] for r in reds],
                             "clock": red and red["clock"],
                             "captures": captures if traced else None,
                             "read": per_layer and {k: per_layer[k] for k in (
                                 "busy_s", "window_s", "gqmm_s", "tokens")}}
    out["gap_stats"] = got.get("stats")
    out["phases_s"] = {"setup": setup_s, "window": w1 - w0, "free": w2 - w1,
                       "reference": w3 - w2, "calls": len(run_calls)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control of `correct` (portbench/tests): the program with its own
    # int4 weight path switched on; the benchmark's runs never pass it
    ap.add_argument("--weight-format", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    try:
        import torch

        import repro_torch  # noqa: F401  (the system under test must be here)
    except ImportError as e:
        print(f"portbench: cannot import the system under test: {e}", file=sys.stderr)
        return 2
    chips = load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   weight_format=args.weight_format)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of JAX or of the JAX package: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
