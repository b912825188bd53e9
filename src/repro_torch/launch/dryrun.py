"""Per-cell dry-run from shapes alone (counterpart of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch ID|all] [--shape NAME|all]
        [--mesh single|multi|both|host] [--device cuda|cpu] [--out PATH]

The reference's cells: arch x ``SHAPES`` x mesh, with its skip rule. The
reference lowers and compiles each cell's step for 256 or 512 TPU chips;
torch has no such compiler, so here a cell is computed from shapes on the
shape-only production mesh (``launch/mesh.make_production_mesh``), nothing
compiled or allocated (meta tensors, ``models/registry.param_struct``):

  num_params      the reference's ``count_params`` over the cell's parameter
                  tree (float for train, quantized at tp = the model axis
                  for serve cells: qvalues and scales)
  model_flops     6ND (train) / 2ND (prefill, decode), N with the active
                  experts only for MoE
  bytes/device    the sum over the step's arguments of one device's block
                  under the placements of ``dist/sharding.py``: params; AdamW
                  m, v (placed as the params) and its step (train); the batch;
                  the cache (decode)
  least time      model_flops over chips x the card's peak (bf16 for train,
                  the int8 tensor rate for the int8 serve cells), and
                  bytes/device over HBM (``kernels/bounds.py``, data sheet)

Nothing is measured, so there is no MFU and no collective column.
``--mesh host`` is the ``make_host_mesh()`` cell: the ranks that exist now
(one process: 1 x 1, the one card here); ``fits`` says whether a cell's
arguments fit one device's memory, and ``roofline`` is the cell's step
recorded on its meta arguments (``analysis/program.py``, the counterpart of
the reference's ``launch/hlo_analysis``): the operations of its entry
points and dot ops, the bytes of every op's new buffers (an eager step
fuses nothing), and the reference's roofline fields, ``mfu`` 0.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.core import flags as perf_flags
from repro_torch.core.policy import quantize_params
from repro_torch.core.tree import tensor_items, tree_map
from repro_torch.dist import sharding as shd
from repro_torch.dist.logical import axis_sizes
from repro_torch.ft.elastic import ensure_process_group
from repro_torch.kernels.bounds import HBM_BYTES_PER_S, PEAK_OPS_PER_S
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.registry import (
    ARCH_IDS,
    build,
    cache_specs,
    input_specs,
    load_config,
    param_struct,
)

RESULTS_PATH = "experiments/dryrun_torch_results.json"

# one device's memory (NVIDIA H100 SXM 80 GB, data sheet)
DEVICE_BYTES = 80e9


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 500k decode cache/attn is quadratic-class (DESIGN.md)"
    return None


def count_params(struct) -> int:
    return sum(math.prod(t.shape) for _, t in tensor_items(struct) if t.ndim > 0)


def model_flops(cfg: ModelConfig, shape: ShapeSpec, n_params: int) -> float:
    """6*N*D (train) / 2*N*D (inference); N = active params for MoE."""
    n = n_params
    if cfg.moe:
        m = cfg.moe
        expert_p = cfg.num_layers * m.num_experts * 3 * m.d_expert * cfg.d_model
        active = cfg.num_layers * (m.top_k + m.num_shared) * 3 * m.d_expert * cfg.d_model
        n = n - expert_p + active
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


@functools.lru_cache(maxsize=None)
def _params(arch: str) -> dict:
    return param_struct(load_config(arch))


@functools.lru_cache(maxsize=None)
def _qparams(arch: str, tp: int) -> dict:
    cfg = load_config(arch)
    return quantize_params(_params(arch), cfg.group_size, tp=tp, formats=cfg.quant_format)


def _bytes(tree, specs: dict, mesh) -> int:
    return sum(shd.shard_nbytes(t.shape, t.dtype, specs[path], mesh)
               for path, t in tensor_items(tree))


def cell_arguments(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    """The step's arguments of one cell as meta trees with their specs:
    {name: (tree, {path: spec})} in the reference's argument order, and the
    parameter tree whose leaves ``num_params`` counts."""
    if shape.kind == "train":
        params = _params(cfg.arch_id)
        p_specs = shd.param_specs(params, mesh, "train")
        moment = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"),
                          params)
        opt = {"step": torch.empty((), dtype=torch.int32, device="meta"), "m": moment,
               "v": moment}
        o_specs = {"step": (), **{f"{g}/{k}": s for g in ("m", "v") for k, s in p_specs.items()}}
        batch = input_specs(cfg, shape)
        return {"params": (params, p_specs), "opt": (opt, o_specs),
                "batch": (batch, shd.batch_specs(batch, mesh))}, params
    qparams = _qparams(cfg.arch_id, axis_sizes(mesh).get("model", 1))
    shd.validate_quant_partition(qparams, mesh, mode="serve")
    args = {"params": (qparams, shd.param_specs(qparams, mesh, "serve"))}
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape)
        args["batch"] = (batch, shd.batch_specs(batch, mesh))
        return args, qparams
    inputs = input_specs(cfg, shape)           # token (b,) and pos ()
    args["batch"] = (inputs, shd.batch_specs(inputs, mesh))
    cache = cache_specs(cfg, shape)
    args["cache"] = (cache, shd.cache_specs(cache, mesh, shape.global_batch))
    return args, qparams


def cell_roofline(cfg: ModelConfig, shape: ShapeSpec, args: dict, model_flops: float) -> dict:
    """The roofline of one cell's step recorded on its meta arguments: the
    train step's loss and backward, prefill over the batch, or one decode
    step (at a (b,) position, as the engine decodes)."""
    from repro_torch.analysis.program import record_step, roofline_from_record
    from repro_torch.train.loop import make_loss_fn, value_and_grad

    model = build(cfg)
    params, batch = args["params"][0], args["batch"][0]
    if shape.kind == "train":
        rec, _ = record_step(value_and_grad, (make_loss_fn(model), params, batch),
                             weights=params)
    elif shape.kind == "prefill":
        rec, _ = record_step(model.prefill, (params, batch, shape.seq_len), weights=params)
    else:
        cache, tok = args["cache"][0], batch["token"]
        pos = torch.zeros(tok.shape, dtype=torch.long, device="meta")
        rec, _ = record_step(model.decode, (params, tok, cache, pos), weights=params,
                             cache=cache)
    return roofline_from_record(rec, model_flops=model_flops).as_dict()


def least_time(cfg: ModelConfig, shape: ShapeSpec, flops: float, nbytes: int,
               chips: int) -> dict:
    rate = ("bf16" if cfg.compute_dtype == "bfloat16" else "f32") if shape.kind == "train" \
        else ("fp8" if cfg.quant_format == "fp8" else "int8")
    compute_s = flops / (chips * PEAK_OPS_PER_S[rate])
    memory_s = nbytes / HBM_BYTES_PER_S
    return {"chips": chips, "rate": rate, "compute_s": compute_s, "memory_s": memory_s,
            "least_s": max(compute_s, memory_s),
            "bound_by": "operations" if compute_s >= memory_s else "bytes"}


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             variant: str = "baseline") -> dict:
    cfg = load_config(arch)
    shape = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(str(n) for n in sizes.values()), "mesh_name": mesh_name,
                 "step": shape.step_name, "variant": variant}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec
    try:
        args, struct = cell_arguments(cfg, shape, mesh)
        per = {name: _bytes(tree, specs, mesh) for name, (tree, specs) in args.items()}
        total = sum(per.values())
        n_params = count_params(struct)
        mf = model_flops(cfg, shape, n_params)
        rec.update({
            "status": "ok",
            "num_params": n_params,
            "model_flops": mf,
            "memory": {"argument_bytes": total,
                       **{f"{name}_bytes": per.get(name, 0)
                          for name in ("params", "opt", "batch", "cache")}},
            "fits": total <= DEVICE_BYTES,
            "device_bytes": DEVICE_BYTES,
            "least": least_time(cfg, shape, mf, total, math.prod(sizes.values())),
        })
        if mesh_name == "host":
            rec["roofline"] = cell_roofline(cfg, shape, args, mf)
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def _meshes(which: str, device) -> list[tuple[str, object]]:
    out = []
    if which in ("single", "both"):
        out.append(("single", make_production_mesh(multi_pod=False, device=device)))
    if which in ("multi", "both"):
        out.append(("multi", make_production_mesh(multi_pod=True, device=device)))
    if which == "host":
        out.append(("host", make_host_mesh(device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="per-cell dry-run from shapes")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both", "host"])
    ap.add_argument("--device", default="cuda",
                    help="the host mesh's device type: cuda (default) or cpu")
    ap.add_argument("--out", default=RESULTS_PATH)
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--variant", default="baseline",
                    help="label for this run; non-baseline keys get suffixed")
    ap.add_argument("--set", action="append", default=[], metavar="FLAG=VAL",
                    help="perf flag overrides, e.g. --set int8_kv_cache=1")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = int(v) if v.isdigit() else v
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    owned = ensure_process_group(args.device) if args.mesh == "host" else False
    try:
        meshes = _meshes(args.mesh, args.device)
        results = load_results(args.out)
        with perf_flags.overrides(**overrides):
            for arch in archs:
                for shape in shapes:
                    for name, mesh in meshes:
                        key = f"{arch}|{shape}|{name}"
                        if args.variant != "baseline":
                            key += f"|{args.variant}"
                        if key in results and results[key]["status"] == "ok" and not args.force:
                            print(f"[cached] {key}")
                            continue
                        rec = run_cell(arch, shape, mesh, name, variant=args.variant)
                        results[key] = rec
                        save_results(args.out, results)
                        extra = ""
                        if rec["status"] == "ok":
                            lt = rec["least"]
                            extra = (f" params {rec['num_params'] / 1e9:.3f}B args/dev "
                                     f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB"
                                     f"{'' if rec['fits'] else ' (does not fit)'} least "
                                     f"{lt['least_s']:.4g} s ({lt['bound_by']})")
                        elif rec["status"] == "error":
                            extra = " " + rec["error"][:200]
                        print(f"[{rec['status']}] {key}{extra}", flush=True)
    finally:
        if owned:
            dist.destroy_process_group()

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
