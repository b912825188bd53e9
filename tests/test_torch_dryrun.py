"""The port's shape-only dry-run (``repro_torch/launch/dryrun.py``) against
the reference's: on every cell of arch x SHAPES x {16 x 16, 2 x 16 x 16},
``num_params`` and ``model_flops`` equal to the reference's, and the bytes
a device equal to the sum of ``NamedSharding.shard_shape`` bytes over the
reference's ``build_cell`` arguments on ``make_production_mesh`` (512 fake
host devices in a subprocess; nothing compiled); then the CLI on one cell,
the host cell and the report."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from _torch_dist import REPO_ROOT, last_json, run_jax, subprocess_env
from repro.models.registry import ARCH_IDS
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_production_mesh

REF_CELLS = """
import math
from jax.sharding import NamedSharding
from repro.configs.base import SHAPES
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.models.registry import ARCH_IDS, load_config
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = load_config(arch)
        for name, shape in SHAPES.items():
            key = f"{arch}|{name}|{'multi' if multi else 'single'}"
            if dryrun.cell_skip_reason(cfg, shape):
                out[key] = None
                continue
            _, args, in_sh, _, _, struct = dryrun.build_cell(cfg, shape, mesh)
            leaves = jax.tree.leaves(args)
            shs = jax.tree.leaves(in_sh, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert len(leaves) == len(shs), key
            nbytes = sum(math.prod(s.shard_shape(tuple(x.shape))) * x.dtype.itemsize
                         for x, s in zip(leaves, shs))
            n = dryrun.count_params(struct)
            out[key] = {"num_params": n, "model_flops": dryrun.model_flops(cfg, shape, n),
                        "argument_bytes": nbytes}
print(json.dumps(out))
"""

_REF: dict = {}


def _ref_cells() -> dict:
    if not _REF:
        _REF.update(last_json(run_jax(REF_CELLS, 512, timeout=600)))
    return _REF


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_equal_reference_build_cell(arch):
    ref = _ref_cells()
    meshes = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}
    for shape in SHAPES:
        for name, mesh in meshes.items():
            key = f"{arch}|{shape}|{name}"
            rec = dryrun.run_cell(arch, shape, mesh, name)
            want = ref[key]
            if want is None:
                assert rec["status"] == "skipped", key
                continue
            assert rec["status"] == "ok", (key, rec.get("error"))
            assert rec["num_params"] == want["num_params"], key
            assert rec["model_flops"] == want["model_flops"], key
            assert rec["memory"]["argument_bytes"] == want["argument_bytes"], key
            assert sum(v for k, v in rec["memory"].items() if k != "argument_bytes") == \
                rec["memory"]["argument_bytes"], key
            lt = rec["least"]
            assert lt["chips"] == (256 if name == "single" else 512)
            assert lt["least_s"] == max(lt["compute_s"], lt["memory_s"]) > 0


def test_cli_one_cell_and_report(tmp_path):
    out = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--shape", "prefill_32k", "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT, env=subprocess_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(out.read_text())["internlm2-1.8b|prefill_32k|single"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["least"]["chips"] == 256
    assert rec["fits"] and "roofline" not in rec and "collectives" not in rec
    table = report.dryrun_table(json.loads(out.read_text()))
    assert "internlm2-1.8b x prefill_32k | 16x16 | prefill_step | ok" in table


def test_host_cell_on_the_cpu(tmp_path, capsys):
    """The make_host_mesh() cell in one process: 1 x 1. TinyLlama's
    decode_32k cache (128 x 32,768 x 22 layers x 2 x 4 heads x 64 x 2 B,
    94.5 GB) does not fit one 80 GB card; its train_4k arguments (bf16
    params, f32 m and v, the batch) are 12 B a parameter less the bf16's 2
    plus the batch, and fit."""
    out = tmp_path / "host.json"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--mesh", "host", "--device", "cpu",
                        "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    dec, tr = res["tinyllama-1.1b|decode_32k|host"], res["tinyllama-1.1b|train_4k|host"]
    assert dec["mesh"] == "1x1" and dec["least"]["chips"] == 1
    assert dec["memory"]["cache_bytes"] == 128 * 32768 * 22 * 2 * 4 * 64 * 2
    assert not dec["fits"] and tr["fits"]
    n = tr["num_params"]
    assert tr["memory"]["params_bytes"] == 2 * n and tr["memory"]["opt_bytes"] == 8 * n + 4
    assert tr["memory"]["batch_bytes"] == 2 * 256 * 4096 * 4
    assert res["tinyllama-1.1b|long_500k|host"]["status"] == "skipped"
    assert "does not fit" in capsys.readouterr().out
    # the perf flags reach the cache's shapes: an int8 KV cache (kvt rows of
    # int8 and an f32 scale a row) halves it, and the cell then fits
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "host",
                        "--device", "cpu", "--set", "int8_kv_cache=1", "--variant", "kv8",
                        "--out", str(out)]) == 0
    kv8 = json.loads(out.read_text())["tinyllama-1.1b|decode_32k|host|kv8"]
    rows = 22 * 128 * 4 * 32768
    assert kv8["memory"]["cache_bytes"] == 2 * (rows * 64 + rows * 4) and kv8["fits"]


def test_host_cell_default_device_needs_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "tinyllama-1.1b", "--mesh", "host", "--out",
                     os.path.join(tmp_path, "x.json")])
