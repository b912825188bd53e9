"""A cell's windows with the program's spans (``repro_torch.serving.spans``)
recorded in turns, and its traced calls read against them.

    python3 portbench/spanrun.py --workload <cell> --seed <n> --seconds <s> \\
        [--order off,on,on,off] [--trace 1]

One set-up, then one window per entry of ``--order`` (whole passes until
``--seconds`` have passed, as ``run.py``'s), the recorder on in the ``on``
ones; with ``--trace 1`` the traced calls of ``run.py`` follow, profiled as
there, with the recorder on. The last line of standard output is JSON: each
window's end-to-end metrics (``run.py``'s readers), an ``on`` window's span
metrics (every reader of ``SPAN_METRICS`` that finds something to read) and
host milliseconds by span, and each traced call's idle gaps labelled by
program span, ``idle_by_span`` (also for the decode steps: the last call less
the first), the idle gaps under 10 us and ``commit_overlap``. Nothing here is
a cell's run: no check against the reference, no result line of ``run.py``'s
form. The reductions are ``spanread.py``'s.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.spanread import decode_view, host_ms_by_span, named, replay_stats, slice_view  # noqa: E402,I001

# the readers of ``Run.spans``; each reads None where its spans are absent
SPAN_METRICS = ("round_gap_ms.tok", "replay_us.tok", "itl_ms_p50.tok",
                "prefill_ms_p50.ttft", "serve_host_ms_p50.ttft")


def run_spans(name: str, seed: int, seconds: float, order: list[str], trace: bool, *,
              device: str = "cuda", shape: dict | None = None, mix: dict | None = None) -> dict:
    """One set-up, the windows of ``order``, then (``trace``) the traced
    calls; ``shape`` and ``mix`` replace the cell's (the CPU tests')."""
    import torch

    from portbench import drive, run
    from portbench import trace as tr
    from portbench import traffic as tf
    from portbench import weights as W
    from repro_torch.serving import spans

    c = run.load_cell(name)
    shape = shape or c["config"]["port"]
    mix = mix or c["mix"]
    dev = torch.device(device)
    params = W.build_tree(shape, seed, dev)
    system = drive.System(shape, mix, params, c["config"]["quant"]["format"], dev)
    del params
    reqs = tf.requests(mix, seed, shape["vocab_size"])
    calls = tf.calls(mix, reqs)
    system.warm(calls)
    setup_s = time.perf_counter() - T0
    harness = []                        # (label, start, end) ns: run.py's spans

    def serve(reqs_c):
        a = time.perf_counter()
        served = system.call(reqs_c)
        b = time.perf_counter()
        harness.append((mix["entry"], int(a * 1e9), int(b * 1e9)))
        return {"start": a, "end": b, "steps": system.decode_steps,
                "requests": [(len(r.tokens), len(x)) for r, x in zip(reqs_c, served)]}

    def window():
        got, w0 = [], time.perf_counter()
        while True:
            got.extend(serve(r) for r in calls)
            if time.perf_counter() - w0 >= seconds:
                return got, w0, time.perf_counter()

    windows = []
    for mode in order:
        if mode == "on":
            with spans.record() as recs:
                got, w0, w1 = window()
        else:
            recs = None
            got, w0, w1 = window()
        r = run.Run(setup_s=setup_s, window_s=w1 - w0, calls=got, spans=recs, trace=None)
        e2e = {m["name"]: run.reader(m["name"])(r) for m in c["end_to_end"]
               if m["name"] != "setup_s"}
        w = {"spans": mode, "end_to_end": e2e, "calls": len(got)}
        if recs is not None:
            got_m = {m: run.reader(m)(r) for m in SPAN_METRICS}
            w["metrics"] = {m: v for m, v in got_m.items() if v is not None}
            w["recorded"] = len(recs)
            w["host_ms_by_span"] = host_ms_by_span(recs)
            rb = [s.end_ns - s.start_ns for s in named(recs, "round.readback")]
            w["readback_us_p50"] = statistics.median(rb) / 1e3 if rb else None
            w["replay_us"] = replay_stats(recs)
        windows.append(w)
    out = {"workload": name, "seed": seed, "setup_s": setup_s, "windows": windows}
    if trace and dev.type == "cuda":
        k, n = mix["trace"]["requests"], mix["trace"]["tokens"]
        views = []
        for cut, label in ([(1, "traced prefill")] if n > 1 else []) + [(n, "traced call")]:
            sub = [tf.Req(r.id, r.tokens, min(r.max_new, cut)) for r in reqs[:k]]
            sl = tr.Slice()
            with spans.record() as recs:
                sl.profile_call(lambda s=sub: serve(s), harness, label)
            red = tr.reduce(sl, harness)
            v = slice_view(sl, recs, mix["entry"])
            if v is not None:
                v["harness_idle_gaps"] = red and red["idle_gaps"]
                v["rounds"] = len(named(recs, "round.replay"))
                v["replay_us"] = replay_stats(recs)
                v["host_ms_by_span"] = host_ms_by_span(recs)
            views.append(v)
        out["traced"] = views
        if len(views) == 2 and None not in views:
            out["decode_steps"] = decode_view(views[1], views[0])
    if dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(dev)
    system.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--order", default="on", help="windows, comma-separated: on / off")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    order = args.order.split(",")
    if not set(order) <= {"on", "off"}:
        raise SystemExit(f"--order takes on / off, got {args.order!r}")
    import torch

    if not torch.cuda.is_available():
        print("spanrun: needs a CUDA device", file=sys.stderr)
        return 3
    out = run_spans(args.workload, args.seed, args.seconds, order, bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
