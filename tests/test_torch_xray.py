"""The port's compiled-program contracts on the CPU: xray's four audits
(``repro_torch.analysis.xray``) over the step records of
``repro_torch.analysis.program``, and that record's roofline (~25 s on one
worker; the catalog, built once, ~12 s of it).

The catalog covers every adapter program of a short serve and full-size
TinyLlama decode at every quant preset on meta tensors; the port's tree
passes all four audits, each bytes row within ``BYTES_RTOL`` (its headroom
printed); one planted defect for each audit is flagged (a cache rebuilt
with ``torch.cat``, a weight dequantized outside an entry point, a bogus
``nbytes``, an ``all_reduce`` on a one-rank gloo group, a lost layer); the
CLI's ``--select 'xray-*'`` is clean on the tree and fails on a planted
catalog. Against the JAX package: each quantized leaf's ``nbytes()``
equals the reference's, from ``jax.eval_shape`` of its
``quantize_params`` (no reference catalog is built)."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro.core.policy import quantize_params as ref_quantize_params  # noqa: E402
from repro.core.quant import QuantizedTensor as RefQuantizedTensor  # noqa: E402
from repro.models.registry import build as ref_build  # noqa: E402
from repro.models.registry import load_config as ref_load_config  # noqa: E402
from repro_torch.analysis import xray  # noqa: E402
from repro_torch.analysis.__main__ import main as cli_main  # noqa: E402
from repro_torch.analysis.program import record_step, roofline_from_record  # noqa: E402
from repro_torch.core.policy import leaf_class, quantize_params  # noqa: E402
from repro_torch.core.quant import QuantizedTensor, dequantize_unchecked  # noqa: E402
from repro_torch.core.tree import tree_items, tree_map  # noqa: E402
from repro_torch.kernels import bounds  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.registry import build, load_config, param_struct  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHECKERS = (xray.XrayDonationChecker, xray.XrayDequantChecker, xray.XrayBytesChecker,
            xray.XrayCollectiveChecker)


@pytest.fixture(scope="module")
def catalog():
    return xray.catalog()


@pytest.fixture(scope="module")
def full():
    """Full-size TinyLlama, its meta parameter tree quantized int8."""
    cfg = load_config(xray.BYTES_ARCH)
    pstruct = param_struct(cfg)
    return cfg, pstruct, quantize_params(pstruct, cfg.group_size, formats="int8")


@pytest.fixture(scope="module")
def reduced():
    """Reduced TinyLlama on the CPU with int8 weights."""
    cfg = load_config(xray.BYTES_ARCH).reduced()
    model = build(cfg)
    params = quantize_params(model.init(seed=0, device="cpu"), cfg.group_size, formats="int8")
    return model, params


def _findings(progs, checker=None):
    checkers = [checker] if checker else CHECKERS
    return [f.message for c in checkers for f in c(lambda: progs).check_project(str(ROOT))]


def test_catalog_covers_every_adapter_program(catalog):
    names = {p.name for p in catalog}
    for fmt in xray.BYTES_PRESETS + tuple(f"int8+kv_{k}" for k in xray.KV_QUANT_PRESETS):
        assert f"{xray.BYTES_ARCH}/decode[{fmt}]" in names
    for arch, kind, spec in xray.SERVING_ARCHS:
        kinds = {p.kind for p in catalog if p.name.startswith(f"{arch}/{kind}/")}
        assert kinds == ({"decode", "prefill", "verify"} if spec else {"decode", "prefill"}), \
            (arch, kind, kinds)
        # both admission groups' prefill programs (each inserts its rows)
        assert sum(p.kind == "prefill" for p in catalog
                   if p.name.startswith(f"{arch}/{kind}/")) == 2
    for p in catalog:
        assert p.record.nodes and p.path.startswith("src/repro_torch/")
        if p.kind in ("decode", "verify"):
            assert p.record.cache_storages, p.name


def test_port_tree_passes_all_four_audits(catalog):
    assert _findings(catalog) == []


@pytest.mark.parametrize("fmt", xray.BYTES_PRESETS + tuple(
    f"int8+kv_{k}" for k in xray.KV_QUANT_PRESETS))
def test_bytes_rows_within_rtol(catalog, fmt):
    prog = next(p for p in catalog if p.name == f"{xray.BYTES_ARCH}/decode[{fmt}]")
    headroom = xray.bytes_headroom(prog)
    print(f"{prog.name}: recorded {prog.record.hbm_bytes() / 1e6:.3f} MB, model "
          f"{prog.expected_bytes / 1e6:.3f} MB, headroom {headroom:+.2%} of ±"
          f"{xray.BYTES_RTOL:.0%}")
    assert abs(headroom) <= xray.BYTES_RTOL
    # every projection read once at its storage bytes, 4 L + 1 of them
    projs = prog.record.projections()
    assert len(projs) == prog.expected_projections == 4 * prog.num_layers + 1 == 89
    assert not prog.record.collectives()


def test_planted_cache_rebuild_is_flagged(reduced):
    model, params = reduced

    def rebuilding(p, tok, cache, pos):
        work = {k: v.clone() for k, v in cache.items()}
        logits, _ = model.decode(p, tok, work, pos)
        return logits, {k: torch.cat([v[:, :, :1], v[:, :, 1:]], dim=2) for k, v in work.items()}

    prog = xray.decode_program(model, params, fmt="int8", device="cpu", step=rebuilding)
    found = _findings([prog], xray.XrayDonationChecker)
    assert any("never written in place" in f for f in found)
    assert any("aten.cat" in f and "full rebuild" in f for f in found)
    clean = xray.decode_program(model, params, fmt="int8", device="cpu")
    assert _findings([clean], xray.XrayDonationChecker) == []


def test_planted_dequantized_weight_is_flagged(full):
    cfg, _, qparams = full
    model = build(cfg)

    def dequantizing(p, tok, cache, pos):
        dequantize_unchecked(p["layers"]["mlp"]["w2"][0])    # outside any entry point
        return model.decode(p, tok, cache, pos)

    prog = xray.decode_program(model, qparams, fmt="int8", step=dequantizing)
    found = _findings([prog], xray.XrayDequantChecker)
    # the dequantized groups (2048, 22, 256) f32: 46.1 MB
    assert len(found) == 1 and "[2048, 22, 256] float32" in found[0], found


def test_planted_bogus_nbytes_is_flagged(full, monkeypatch):
    cfg, _, qparams = full
    # a registry whose nbytes says every format stores twice what it does
    honest = QuantizedTensor.nbytes
    monkeypatch.setattr(QuantizedTensor, "nbytes", lambda self: 2 * honest(self))
    prog = xray.decode_program(build(cfg), qparams, fmt="int8")
    found = _findings([prog], xray.XrayBytesChecker)
    assert len(found) == 1 and "registry nbytes model" in found[0], found


def test_planted_all_reduce_is_flagged(reduced, tmp_path):
    model, params = reduced
    store = dist.FileStore(os.fspath(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        def reducing(p, tok, cache, pos):
            logits, rows = model.decode(p, tok, cache, pos)
            dist.all_reduce(logits)
            return logits, rows

        prog = xray.decode_program(model, params, fmt="int8", device="cpu", step=reducing)
    finally:
        dist.destroy_process_group()
    found = _findings([prog], xray.XrayCollectiveChecker)
    assert len(found) == 1 and "c10d.allreduce_" in found[0], found


def test_planted_lost_layer_is_flagged(full):
    cfg, pstruct, _ = full
    lost = dataclasses.replace(cfg, num_layers=cfg.num_layers - 1)
    qparams = quantize_params({**pstruct, "layers": tree_map(lambda t: t[:-1],
                                                             pstruct["layers"])},
                              cfg.group_size, formats="int8")
    prog = xray.decode_program(build(lost), qparams, fmt="int8", expect_layers=cfg.num_layers)
    found = _findings([prog], xray.XrayCollectiveChecker)
    assert len(found) == 1 and "85 projection entry points" in found[0] and "89" in found[0]


def test_cli_xray_glob_clean_on_tree_and_fails_on_planted(catalog, reduced, monkeypatch, capsys):
    assert cli_main(["--root", str(ROOT), "--select", "xray-*"]) == 0
    assert "4 checker(s)" in capsys.readouterr().err
    model, params = reduced

    def rebuilding(p, tok, cache, pos):
        return model.decode(p, tok, {k: v.clone() for k, v in cache.items()}, pos)

    planted = xray.decode_program(model, params, fmt="int8", device="cpu", step=rebuilding)
    monkeypatch.setattr(xray, "catalog", lambda: (*catalog, planted))
    assert cli_main(["--root", str(ROOT), "--select", "xray-*"]) == 1
    assert "xray-donation" in capsys.readouterr().out


def test_catalog_failure_is_a_finding():
    def broken():
        raise RuntimeError("no model")

    found = list(xray.XrayBytesChecker(broken).check_project(str(ROOT)))
    assert len(found) == 1 and "catalog failed to build" in found[0].message


@pytest.mark.parametrize("fmt", xray.BYTES_PRESETS)
def test_nbytes_equal_reference(fmt):
    """Each quantized leaf's nbytes() equals the reference's for the same
    config and preset (the reference's from jax.eval_shape)."""
    cfg = load_config(xray.BYTES_ARCH)
    port = {p: leaf.nbytes() for p, leaf in tree_items(
        quantize_params(param_struct(cfg), cfg.group_size, formats=fmt))
        if isinstance(leaf, QuantizedTensor)}
    rcfg = ref_load_config(xray.BYTES_ARCH)
    rstruct = jax.eval_shape(ref_build(rcfg).init, jax.random.PRNGKey(0))
    rq = jax.eval_shape(lambda p: ref_quantize_params(p, rcfg.group_size, formats=fmt), rstruct)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf.nbytes()
           for path, leaf in jax.tree_util.tree_leaves_with_path(
               rq, is_leaf=lambda x: isinstance(x, RefQuantizedTensor))
           if isinstance(leaf, RefQuantizedTensor)}
    assert port == ref and len(port) == 6


@pytest.mark.parametrize("fmt", ("int8", "int4", "int3", "fp8"))
def test_registry_weight_bytes_against_decode_step_bound(full, fmt):
    """For a uniform preset the registry's projection bytes are exactly the
    weight terms of ``bounds.decode_step`` (m n bits / 8 + 4 m n / GS a
    projection); the two differ by what the bound adds (each projection's
    int8 activations and scales in, its f32 outputs out) and what it leaves
    out (the embedding's row and the float leaves)."""
    cfg, pstruct, _ = full
    qparams = quantize_params(pstruct, cfg.group_size, formats=fmt)
    proj = sum(leaf.nbytes() for p, leaf in tree_items(qparams)
               if isinstance(leaf, QuantizedTensor) and leaf_class(p) != "embed")
    weights = sum(c * (m * n * bounds.WEIGHT_BITS[fmt] // 8 + 4 * m * n
                       // bounds.group_size(cfg, n))
                  for m, n, c in bounds.decode_projections(cfg))
    assert proj == weights
    acts = sum(c * (n + 4 * n // bounds.group_size(cfg, n) + 4 * m)
               for m, n, c in bounds.decode_projections(cfg))
    assert bounds.decode_step(cfg, fmt, 1).nbytes == weights + acts


def test_record_reads_writes_from_the_schema():
    cache = torch.zeros(4, 3)
    rows = torch.ones(3)

    def step(c, r):
        c[1].copy_(r)                     # an in-place write through a view
        return torch.cat([c, c]), c.view(12)

    rec, _ = record_step(step, (cache, rows), cache={"c": cache})
    assert rec.written_storages() == set(rec.cache_storages)
    outs = [(n.name, [r.shape for r in n.outputs]) for n in rec.glue()]
    # views and in-place results are no new buffers; cat's output is
    assert ("aten.cat.default", [(8, 3)]) in outs
    assert all(not o for name, o in outs if name.startswith(("aten.view", "aten.select",
                                                              "aten.copy_")))


def test_roofline_of_a_decode_row(catalog):
    prog = next(p for p in catalog if p.name == f"{xray.BYTES_ARCH}/decode[int8]")
    rl = roofline_from_record(prog.record)
    d = rl.as_dict()
    assert d["dominant"] == "memory" and d["mfu"] == 0.0 and d["collective_s"] == 0.0
    assert d["step_s"] == pytest.approx(prog.record.hbm_bytes() / bounds.HBM_BYTES_PER_S)
    cfg = load_config(xray.BYTES_ARCH)
    assert rl.ops["int8"] == bounds.decode_step(cfg, "int8", 1).ops
    assert np.isclose(d["compute_s"], rl.ops["int8"] / bounds.PEAK_OPS_PER_S["int8"])


def test_dryrun_host_cell_has_a_roofline(tmp_path):
    out = tmp_path / "host.json"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "host",
                        "--device", "cpu", "--out", str(out)]) == 0
    rl = json.loads(out.read_text())["tinyllama-1.1b|decode_32k|host"]["roofline"]
    assert rl["dominant"] == "memory" and rl["mfu"] == 0.0 and rl["chips"] == 1
    cfg = load_config("tinyllama-1.1b")
    # 128 rows through the 89 projections at the int8 rate
    assert rl["ops_by_rate"]["int8"] == bounds.decode_step(cfg, "int8", 128).ops
    # the step reads the whole 94.5 GB cache at least once
    assert rl["hbm_bytes_per_device"] >= 128 * 32768 * 22 * 2 * 4 * 64 * 2
