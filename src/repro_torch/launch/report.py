"""Render the dry-run table from the dry-run's results (counterpart of
``repro/launch/report.py``).

    python -m repro_torch.launch.report [results.json]

One row a cell: parameters, model FLOPs, bytes a device by argument
(params, AdamW state, batch, cache), whether they fit one device, and the
least time from the card's data-sheet peaks (``launch/dryrun.py``). There
is no compile, MFU or collective column: nothing here is measured.
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch.dryrun import RESULTS_PATH


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def dryrun_table(results: dict) -> str:
    rows = ["| cell | mesh | step | status | params | model FLOPs | params/dev | opt/dev "
            "| batch/dev | cache/dev | args/dev | fits | compute | memory | least |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(results):
        r = results[key]
        parts = key.split("|")
        arch, shape = parts[0], parts[1]
        if len(parts) > 3:
            arch += f" [{parts[3]}]"
        head = f"| {arch} x {shape} | {r['mesh']} | {r['step']}"
        if r["status"] == "ok":
            m, lt = r["memory"], r["least"]
            rows.append(
                f"{head} | ok | {r['num_params'] / 1e9:.3f}B | {r['model_flops']:.2e} "
                f"| {fmt_bytes(m['params_bytes'])} | {fmt_bytes(m['opt_bytes'])} "
                f"| {fmt_bytes(m['batch_bytes'])} | {fmt_bytes(m['cache_bytes'])} "
                f"| {fmt_bytes(m['argument_bytes'])} | {'yes' if r['fits'] else '**no**'} "
                f"| {fmt_s(lt['compute_s'])} | {fmt_s(lt['memory_s'])} "
                f"| **{fmt_s(lt['least_s'])}** ({lt['bound_by']}) |")
        elif r["status"] == "skipped":
            rows.append(f"{head} | SKIP |" + " - |" * 10 + f" {r['reason'][:60]} |")
        else:
            rows.append(f"{head} | **ERROR** |" + " - |" * 10 + f" {r['error'][:60]} |")
    return "\n".join(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else RESULTS_PATH
    with open(path) as f:
        results = json.load(f)
    print("## Dry-run table (from shapes; nothing compiled or measured)\n")
    print(dryrun_table(results))


if __name__ == "__main__":
    main()
