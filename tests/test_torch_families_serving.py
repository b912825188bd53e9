"""The families beside TinyLlama (internlm2-1.8b, deepseek-coder-33b,
pixtral-12b, gemma2-2b, and gemma2 with caps that bend its values; dbrx-132b,
minicpm3-4b and deepseek-v2-lite-16b) on the port's serving paths, against
the reference on their reduced configs with numpy-made weights (random norm
weights, ``tests/test_torch_families.py``):

- ``generate``, contiguous and paged, f32 and int8 weights: greedy tokens
  equal to the reference's; speculative (k = 4, the n-gram drafter) equal
  to vanilla decode's, and on the contiguous path to the reference's
  speculative run with its ``spec_stats``; pixtral with its patch
  embeddings; the MoE and MLA families' contiguous generate with f32, int8
  and mixed3 weights (the MLA families have no paged or speculative path);
- ``serve_ragged``: ``tests/test_torch_families_ragged.py``;
- the serve CLI on each reduced family, ragged (and speculative where the
  family verifies);
- the capability flags of every ported arch against ``tests/arch_matrix.py``
  and the reference's, and ``kernels/bounds.table`` for every ported config.

Every variant runs on gemma2, fewer on its tight-cap case and one on each
plain GQA family (``tests/_torch_families.py`` says why). gemma2's
reduced window (64) is cut to 16 here in both packages, so that
these short prompts and their decode reach past it and the local layers
mask keys on every serving path (``tests/test_torch_families.py`` runs the
model code past the window of 64 itself).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import arch_matrix  # noqa: E402
from _torch_families import first_difference, traced  # noqa: E402
from _torch_families import ARCHS, MOE_MLA, serving_engines  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.kernels import bounds  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402

PROMPT = 24
CACHE_LEN = 48


def _batch(cfg, b=2, s=PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (b, s))}
    if cfg.frontend == "patch_embed":
        out["patch_embeds"] = rng.normal(
            size=(b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("case,paged,quantize", [
    *(("gemma2-2b", p, q) for p in (False, True) for q in (False, True)),
    ("gemma2-2b-tight", False, True), ("gemma2-2b-tight", True, False),
    ("internlm2-1.8b", False, True), ("deepseek-coder-33b", True, True),
    ("pixtral-12b", False, False), ("dbrx-132b", False, True), ("dbrx-132b", True, False)])
def test_generate_greedy_and_spec_match_reference(case, paged, quantize):
    """24-token prompts and 12 new tokens: gemma2's decode passes its
    window of 16."""
    jeng, teng = serving_engines(case, quantize, CACHE_LEN)
    batch = _batch(teng.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    want = jeng.generate(jbatch, 12, paged=paged)
    van = teng.generate(tbatch, 12, paged=paged)
    np.testing.assert_array_equal(van.tokens.numpy(), np.asarray(want.tokens))
    got = teng.generate(tbatch, 12, paged=paged, spec_k=4)
    np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())
    if not paged:
        jspec = jeng.generate(jbatch, 12, spec_k=4)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(jspec.tokens))
        assert got.spec_stats == jspec.spec_stats


def test_generate_with_patch_embeds_matches_reference():
    """pixtral's patch embeddings through the captured prefill's own buffer:
    greedy tokens and final logits equal the reference's; without them the
    prompt's first positions are its token embeddings, another program."""
    jeng, teng = serving_engines("pixtral-12b", False, CACHE_LEN)
    batch = _batch(teng.cfg, s=20)
    want = jeng.generate({k: jnp.asarray(v) for k, v in batch.items()}, 6)
    got = teng.generate({k: torch.as_tensor(v) for k, v in batch.items()}, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    ref = np.asarray(want.logits_last)
    np.testing.assert_allclose(got.logits_last.numpy(), ref, atol=1e-4, rtol=0)
    plain = teng.generate({"tokens": torch.as_tensor(batch["tokens"])}, 6)
    assert not torch.equal(plain.logits_last, got.logits_last)
    assert len(teng.graphs.programs) == 4     # prefill and decode, each signature


@pytest.mark.parametrize("arch,setting", [
    *((a, q) for a in MOE_MLA for q in (False, True)),
    ("minicpm3-4b", "mixed3"), ("deepseek-v2-lite-16b", "mixed3")])
def test_generate_greedy_matches_reference_moe_mla(arch, setting):
    """The MoE and MLA families' greedy generate (contiguous cache) with f32
    and int8 weights, and the MLA ones with mixed3 (int3 attention and FFN,
    deepseek-v2-lite's experts included; dbrx's int3 parting from the
    reference at a .5 tie is ROADMAP Queue C's record):
    tokens equal to the reference's, or, with quantized weights, parted
    only by a tie: along the reference's tokens the first decision the two
    packages make differently is an int8 rounding on a .5 boundary or a
    router near tie (``tests/_torch_families.first_difference``)."""
    jeng, teng = serving_engines(arch, setting, CACHE_LEN)
    batch = _batch(teng.cfg)
    want = np.asarray(jeng.generate({k: jnp.asarray(v) for k, v in batch.items()}, 12).tokens)
    got = teng.generate({k: torch.as_tensor(v) for k, v in batch.items()}, 12).tokens.numpy()
    if not np.array_equal(got, want):
        assert setting, (got, want)
        first = first_difference(jeng, teng, batch["tokens"], want)
        assert traced(first["kind"], first["values"]), first


@pytest.mark.parametrize("arch", ARCHS + MOE_MLA)
def test_serve_cli_runs_each_family_on_cpu(arch, capsys):
    """The ragged CLI, speculative where the family verifies (the MLA ones
    serve continuously, with no paged pool)."""
    mla = registry.load_config(arch).mla is not None
    out = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "6",
                      "--steps", "3", "--device", "cpu", "--ragged", "--slots", "2"]
                     + ([] if mla else ["--spec-k", "2"]))
    text = capsys.readouterr().out
    assert f"arch: {arch}" in text and ("ragged (continuous" if mla else "ragged (paged") in text
    assert len(out) == 2 and all(r.tokens.shape == (3,) for r in out)


@pytest.mark.parametrize("arch", registry.PORTED_ARCHS)
def test_capability_flags_match_arch_matrix_and_reference(arch):
    model = registry.build(registry.load_config(arch).reduced())
    jmodel = jreg.build(jreg.load_config(arch).reduced())
    assert model.supports_lengths is jmodel.supports_lengths is (arch in arch_matrix.RAGGED_ARCHS)
    assert model.supports_paged is jmodel.supports_paged is (arch in arch_matrix.PAGED_ARCHS)
    assert model.supports_spec is jmodel.supports_spec is (arch in arch_matrix.SPEC_ARCHS)
    # "kv" for the length-aware decoder LMs, "state" for the recurrent ones,
    # "none" for the encoder-decoder (neither list)
    assert model.cache_kind == jmodel.cache_kind == (
        "state" if arch in arch_matrix.SLOT_STATE_ARCHS
        else "kv" if arch in arch_matrix.RAGGED_ARCHS else "none")
    for hook in ("init_paged_cache", "decode_paged", "verify", "commit_verify",
                 "verify_paged", "commit_verify_paged", "insert_slots", "gather_slots"):
        # the MLA families declare no paged or verify hook, the encoder-decoder
        # none at all, as in the reference
        assert callable(getattr(model, hook)) is callable(getattr(jmodel, hook)), hook
        assert callable(getattr(model, hook)) or getattr(model, hook) is None, hook
    slots = model.cache_kind != "none"
    assert callable(model.insert_slots) is callable(model.gather_slots) is slots
    # the GQA decoder_lm families have the paged pool; MLA and recurrent ones not
    assert callable(model.decode_paged) is model.supports_paged is (
        model.cfg.model_type == "decoder_lm" and model.cfg.mla is None)


@pytest.mark.parametrize("arch", registry.PORTED_ARCHS)
def test_bounds_table_runs_for_every_ported_config(arch, capsys):
    cfg = registry.load_config(arch)
    rows = bounds.table(cfg)
    assert rows and all(b.seconds > 0 for _, _, b in rows)
    per_pass = bounds.projection_pass(cfg, "int8", 1)
    # every FFN application's weights, at least: zamba2's one shared FFN
    # runs once a group of shared_attn_every layers
    ffns = cfg.num_layers // (cfg.shared_attn_every or 1)
    assert per_pass.nbytes > ffns * cfg.d_model * cfg.d_ff * 3
    bounds.main(["--arch", arch])
    assert capsys.readouterr().out.startswith(f"{arch}:")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-2b", "minicpm3-4b",
                                  "deepseek-v2-lite-16b", "rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_family_golden_file_matches_chip_smoke(arch):
    """golden_<arch>.json holds what chip_smoke.py's family golden reads: its
    settings, the prompt, the reference's tokens for f32 and int8 weights,
    and the port's plain CPU run, which reproduced every one of them, or
    (the MLA, recurrent and encoder-decoder int8 runs) lost tokens only behind a
    traced tie: the
    first int8 rounding in which the packages differ along the reference's
    tokens lies on a .5 boundary in both, and every replayed step the port
    would choose otherwise is within TIE_MARGIN of max|logit|."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert arch in cs.FAMILY_GOLDEN["archs"]
    golden = json.loads(cs.family_golden_file(arch).read_text())
    settings = cs.family_golden_settings(arch)
    for k, v in settings.items():
        assert golden[k] == v, k
    cfg = cs.family_golden_config(arch)
    assert golden["arch"] == arch and golden["d_model"] == cfg.d_model
    # 2 layers; zamba2 7, so that its shared block runs once; seamless 2 + 2
    assert cfg.num_layers == settings["num_layers"] == (7 if arch == "zamba2-7b" else 2)
    assert cfg.encoder_layers == (2 if arch == "seamless-m4t-large-v2" else 0)
    assert cfg.d_model == registry.load_config(arch).d_model
    assert golden["prompt"] == cs.family_golden_prompt(cfg.vocab_size).tolist()
    total = cs.FAMILY_GOLDEN["batch"] * cs.FAMILY_GOLDEN["max_new_tokens"]
    for setting in cs.FAMILY_GOLDEN["settings"]:
        toks = np.asarray(golden["tokens"][setting])
        assert toks.shape == (cs.FAMILY_GOLDEN["batch"], cs.FAMILY_GOLDEN["max_new_tokens"])
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        if golden["port_cpu_equal"][setting] == total:
            assert golden["port_cpu_replay_differs"][setting] == []
            continue
        # the CPU runs that lose int8 tokens at a traced tie: the MLA, the
        # recurrent families' and the encoder-decoder's
        assert setting == "int8" and arch in ("minicpm3-4b", "deepseek-v2-lite-16b",
                                              "rwkv6-7b", "zamba2-7b",
                                              "seamless-m4t-large-v2"), setting
        first = golden["port_cpu_first_difference"][setting]
        assert traced(first["kind"], [tuple(v) for v in first["values"]]), first
        assert golden["port_cpu_replay_differs"][setting]
        assert all(d["margin"] <= cs.TIE_MARGIN for d in golden["port_cpu_replay_differs"][setting])
    assert len(golden["weights_checksum"]) == 64
    assert golden["made_by"] == f"tests/make_torch_golden.py --arch {arch}"
