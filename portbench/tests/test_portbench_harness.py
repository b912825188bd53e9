"""The harness on the CPU: what it imports, how cells resolve, the traffic,
the reference against the port at tiny sizes, the metrics' ``moves``, and
``correct`` coming out false under each fault a cell can have."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import traffic as tf
from portbench.tests._tiny import CELLS, ROOT, SPEC, TEST_CONFIGS, cell, config, mix, tiny_run

PB = ROOT / "portbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def _py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax_module():
    """A whole tiny run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or repro (compared whole: repro_torch is the port)."""
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from portbench.tests._tiny import tiny_run\n"
            "from portbench import run\n"
            "out = tiny_run('internlm2-paged-serve')\n"
            "assert 'repro_torch' in sys.modules\n"
            "print(repr(run.forbidden_modules()))")
    assert _py(code) == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, "repro.core")
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert "repro" not in run.forbidden_modules()


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_harness_sources_import_no_jax():
    for path in PB.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & JAX_NAMES, (path, tops & JAX_NAMES)


def test_reference_imports_nothing_of_the_program():
    for path in [*sorted((PB / "reference").glob("*.py")), PB / "weights.py"]:
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & (JAX_NAMES | {"repro_torch"}), (path, tops)
    code = ("import sys; sys.path[:0] = ['.']\n"
            "import portbench.reference.model, portbench.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib'}))")
    assert _py(code) == "[]"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    from portbench import run

    c = run.load_cell(name)
    w = cell(name)
    assert (PB / "configs" / f"{w['config']}.json").exists()
    assert c["config"]["name"] == w["config"]
    assert c["mix"]["entry"] in ("generate", "serve_ragged")
    assert c["limits"] and set(c["limits"]) <= {"max_logit_gap", "mean_logit_gap"}
    assert all(v > 0 for v in c["limits"].values())
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(run.reader(m["name"])), m["name"]
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


def test_run_py_names_no_cell_or_config():
    text = (PB / "run.py").read_text() + (PB / "drive.py").read_text()
    for w in SPEC["workloads"]:
        assert w["name"] not in text and w["config"] not in text and w["traffic"] not in text


def test_configs_hold_the_port_fields():
    """The published keys and the port's fields say the same."""
    files = [(ROOT / c["file"], c["reduced"]) for c in SPEC["configs"]]
    files += [(path, None) for path in TEST_CONFIGS.values()]
    for path, reduced in files:
        f = json.loads(path.read_text())
        p = f["port"]
        assert reduced is None or f["reduced"] == reduced
        assert (f["hidden_size"], f["num_hidden_layers"], f["num_attention_heads"],
                f["vocab_size"]) == (p["d_model"], p["num_layers"], p["num_heads"],
                                     p["vocab_size"])
        assert f["rms_norm_eps"] == p["norm_eps"] and f["rope_theta"] == p["rope_theta"]
        assert f["quant"]["group_size"] == p["group_size"]
        if p.get("moe"):
            assert (f["n_routed_experts"], f["num_experts_per_tok"], f["moe_intermediate_size"],
                    f["n_shared_experts"]) == tuple(p["moe"][k] for k in (
                        "num_experts", "top_k", "d_expert", "num_shared"))
            assert (f["kv_lora_rank"], f["qk_nope_head_dim"], f["qk_rope_head_dim"],
                    f["v_head_dim"]) == tuple(p["mla"][k] for k in (
                        "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim"))
        else:
            assert (f["num_key_value_heads"], f["intermediate_size"]) == (
                p["num_kv_heads"], p["d_ff"])


@pytest.mark.parametrize("name", CELLS)
def test_traffic_same_for_a_seed_different_across_seeds(name):
    m = mix(cell(name)["traffic"])
    a = tf.requests(m, 3_000_000_011, 1000)
    b = tf.requests(m, 3_000_000_011, 1000)
    c = tf.requests(m, 3_000_000_012, 1000)
    assert a == b
    assert [r.tokens for r in a] != [r.tokens for r in c]
    # every seed does the same work, in the same order
    assert [(len(r.tokens), r.max_new) for r in a] == [(len(r.tokens), r.max_new) for r in c]
    assert all(r.max_new >= 1 and len(r.tokens) >= 1 for r in a)
    assert sum(len(x) for x in tf.calls(m, a)) == m["requests"]


@pytest.mark.parametrize("name", CELLS)
def test_metrics_move_one_reported_end_to_end_metric(name):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        cells = m.get("workloads", CELLS)
        if name in cells:
            mv = e2e[m["moves"]]
            assert name in mv.get("workloads", CELLS), (m["name"], name)


@pytest.mark.parametrize("name,over", [
    ("internlm2-paged-serve", {}),
    ("internlm2-paged-serve", {"traffic": "chat-b1"}),
    ("internlm2-paged-serve", {"config_name": "deepseek-v2-lite-16b-w8a8",
                               "traffic": "moe-serve"}),
])
def test_reference_agrees_with_the_port_tiny(name, over):
    """The dense configuration through the paged server and generate, and the
    MLA/MoE test configuration through the continuous server, at tiny sizes
    on the CPU: every served token within a small logit gap of the
    reference's best."""
    out = tiny_run(name, limits={"max_logit_gap": 0.25}, **over)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["checks"]["tokens_compared"]["value"] > 0


# -- faults: correct has to come out false ---------------------------------

def _cache_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: no KV or latent row is
    written."""
    from repro_torch.models import attention

    monkeypatch.setattr(attention, "_commit_bt", lambda cache, rows, pos: cache)
    monkeypatch.setattr(attention, "commit_layers_paged", lambda pages, *a: pages)


def _half_batch(monkeypatch):
    """Half of the decode batch left out: its rows take the other half's
    logits."""
    from repro_torch.models import transformer

    def halve(fn):
        def step(*a, **k):
            logits, cache = fn(*a, **k)
            h = logits.shape[0] // 2
            if h:
                logits = logits.clone()
                logits[h:] = logits[:h].mean(dim=0, keepdim=True)
            return logits, cache
        return step

    monkeypatch.setattr(transformer, "lm_decode", halve(transformer.lm_decode))
    monkeypatch.setattr(transformer, "lm_decode_paged", halve(transformer.lm_decode_paged))


def _token_altered(monkeypatch):
    """Every token altered where the sampler produces it."""
    import torch

    from repro_torch.serving import sampling

    vocab = 512

    def greedy(logits, gumbel=None):
        return (torch.argmax(logits, dim=-1) + 1) % vocab

    monkeypatch.setattr(sampling, "greedy", greedy)


FAULTS = {"state_unchanged": _cache_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}
# the faults each cell can have: a one-token answer reads no cache; a batch
# of one has no half to leave out; every cell runs on one chip, so there is
# no exchange between chips to leave out
CELL_FAULTS = {
    "internlm2-paged-serve": ["state_unchanged", "half_batch", "token_altered"],
    "internlm2-longdoc-ttft": ["token_altered"],
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in CELL_FAULTS[c]])
def test_fault_makes_correct_false(name, fault, monkeypatch):
    sound = tiny_run(name)
    assert sound["correct"], sound["checks"]
    FAULTS[fault](monkeypatch)
    broken = tiny_run(name)
    assert not broken["correct"], broken["checks"]


def test_every_cell_has_its_faults_listed():
    assert set(CELL_FAULTS) == set(CELLS)


def test_trace_run_reports_per_layer_metrics_only():
    """A traced run (no card here, so the slice records nothing): the
    per-layer metrics that read counters and the host clock are there, those
    that read the trace are left out, and no end-to-end metric is."""
    from portbench import run
    from portbench.tests._tiny import tiny_mix, tiny_shape

    name = "internlm2-paged-serve"
    c = cell(name)
    out = run.run_cell(name, 4_000_000_009, 0.2, True, device="cpu",
                       shape=tiny_shape(config(c["config"])["port"]),
                       mix=tiny_mix(mix(c["traffic"])))
    assert out["correct"], out["checks"]
    names = set(out["metrics"])
    assert {"slot_occupancy_pct.tok", "window_captures.tok", "capture_s.setup",
            "step_mfu_pct.tok"} <= names
    assert not names & {"tok_s", "setup_s", "device_idle_pct.tok", "gqmm_roofline_pct.tok"}
    assert out["metrics"]["window_captures.tok"]["value"] == 0
    assert list(out)[-1] == "checks"


def test_trace_reduction_on_planted_events():
    from portbench import trace as tr

    sl = tr.Slice()
    base = 10_000_000_000
    sl.host = {"time": (base, base + 1_000_000_000), "monotonic": (1, 2),
               "perf_counter": (5_000_000_000, 6_000_000_000)}
    sl.events = [("void gqmm_small_kernel<1>(int)", base + 100_000_000, base + 300_000_000),
                 ("void at::native::elementwise_kernel<2>(int)", base + 200_000_000,
                  base + 400_000_000),
                 ("Memcpy DtoH (Device -> Pinned)", base + 900_000_000, base + 950_000_000)]
    spans = [("serve_ragged", 5_000_000_000, 5_800_000_000)]
    red = tr.reduce(sl, spans)
    assert red["clock"] == "time"
    assert red["busy_s"] == pytest.approx(0.35)
    assert red["gqmm_s"] == pytest.approx(0.2)
    assert red["window_s"] == pytest.approx(1.0)
    assert red["device_ops"][0] == ["gqmm_small_kernel", pytest.approx(0.2)]
    assert [g[0] for g in red["idle_gaps"]] == ["serve_ragged", "serve_ragged", "between calls"]
    assert red["idle_gaps"][0][1] == pytest.approx(0.5)


def test_trace_difference_leaves_the_decode_steps():
    from portbench import counts
    from portbench import trace as tr

    prefill = {"busy_s": 1.0, "window_s": 1.2, "gqmm_s": 0.5, "tokens": 32,
               "work": counts.Work(10.0, 4.0, 2.0), "gqmm_work": counts.Work(6.0, 4.0, 0.0)}
    whole = {"busy_s": 1.9, "window_s": 2.4, "gqmm_s": 0.8, "tokens": 2400,
             "work": counts.Work(30.0, 5.0, 3.0), "gqmm_work": counts.Work(20.0, 5.0, 0.0)}
    d = tr.difference(whole, prefill)
    assert d["busy_s"] == pytest.approx(0.9) and d["window_s"] == pytest.approx(1.2)
    assert d["gqmm_s"] == pytest.approx(0.3) and d["tokens"] == 2368
    assert (d["work"].nbytes, d["work"].int8_ops, d["work"].bf16_ops) == (20.0, 1.0, 1.0)
    assert (d["gqmm_work"].nbytes, d["gqmm_work"].int8_ops) == (14.0, 1.0)
