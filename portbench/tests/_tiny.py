"""Tiny sizes of the benchmark's configurations and mixes, for CPU tests."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = {c["name"]: c for c in SPEC["configs"]}


# a configuration that no cell runs yet, kept to test the harness's MLA and
# MoE paths (counts, weights, reference) at tiny sizes
TEST_CONFIGS = {"deepseek-v2-lite-16b-w8a8": Path(__file__).parent / "deepseek-v2-lite-16b-w8a8.json"}


def config(name: str) -> dict:
    path = ROOT / CONFIGS[name]["file"] if name in CONFIGS else TEST_CONFIGS[name]
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    return {w["name"]: w for w in SPEC["workloads"]}[name]


def mix(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())


def tiny_shape(shape: dict) -> dict:
    """The port's ``ModelConfig.reduced()`` cut, as a ``port`` group."""
    s = dict(shape, num_layers=2, d_model=128, num_heads=4,
             num_kv_heads=min(shape["num_kv_heads"], 2), head_dim=32, d_ff=256,
             vocab_size=512, group_size=32, param_dtype="float32", compute_dtype="float32")
    if shape.get("moe"):
        s["moe"] = dict(num_experts=4, top_k=2, d_expert=64, num_shared=1)
    if shape.get("mla"):
        s["mla"] = dict(kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=16, qk_rope_dim=16,
                        v_head_dim=16)
    return s


def tiny_mix(m: dict) -> dict:
    """A few short requests of the mix's entry and mode."""
    m = dict(m, requests=4, per_call=min(m["per_call"], 4), cache_len=96,
             trace={"offset_s": 0.0, "slice_s": 0.1})
    m["prompt"] = dict(m["prompt"], min=4, max=32, median=12)
    one = m["output"]["max"] == 1
    m["output"] = dict(m["output"], min=1 if one else 3, max=1 if one else 16)
    if "slots" in m:
        m["slots"] = min(m["slots"], 2)
    return m


def tiny_run(cell_name: str, seed: int = 4_000_000_007, *, config_name: str | None = None,
             traffic: str | None = None, **kw) -> dict:
    """One CPU run of the cell at tiny sizes: everything a chip run does but
    the look for a chip. ``config_name`` and ``traffic`` replace the cell's."""
    from portbench import run

    c = cell(cell_name)
    shape = tiny_shape(config(config_name or c["config"])["port"])
    return run.run_cell(cell_name, seed, 0.2, False, device="cpu", shape=shape,
                        mix=tiny_mix(mix(traffic or c["traffic"])), **kw)
