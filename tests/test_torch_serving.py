"""Port serving against the reference: greedy tokens from
``InferenceEngine.generate`` must be IDENTICAL for reduced TinyLlama, float
and int8, uniform and ragged; plus the serve CLI on the CPU, the CUDA-only
defaults of the entry points, and the golden file ``chip_smoke.py`` reads."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.sampling import greedy, make_sampler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _engines(quantize, eos_id=None, cache_len=40):
    cfg = load_config("tinyllama-1.1b").reduced()
    tree = bridge.init_params_numpy(cfg, seed=11)
    jeng = JEngine(jbuild(jload("tinyllama-1.1b").reduced()), numpy_to_jax(tree),
                   cache_len=cache_len, quantize=quantize, eos_id=eos_id)
    teng = InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=cache_len, quantize=quantize, eos_id=eos_id,
                           device="cpu")
    return cfg, jeng, teng


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_generate_tokens_identical_to_reference(quantize, ragged):
    cfg, jeng, teng = _engines(quantize)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 12))
    kw = {"lengths": np.array([12, 3, 8])} if ragged else {}
    jr = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 16, **kw)
    tr = teng.generate({"tokens": torch.as_tensor(toks)}, 16, **kw)
    assert tr.tokens.device.type == "cpu" and tr.steps == 16
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    ref = np.asarray(jr.logits_last)
    tol = 2e-3 * np.abs(ref).max() if quantize else 1e-4
    np.testing.assert_allclose(tr.logits_last.numpy(), ref, atol=tol, rtol=0)


def test_generate_with_eos_matches_reference():
    cfg, jeng0, _ = _engines(True)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 8))
    free = np.asarray(jeng0.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10).tokens)
    eos = int(free[0, 3])          # a token row 0 emits mid-stream
    _, jeng, teng = _engines(True, eos_id=eos)
    jr = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10)
    tr = teng.generate({"tokens": torch.as_tensor(toks)}, 10)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    assert (tr.tokens[0, 3:] == eos).all()


def test_generate_validates_cache_length():
    _, _, teng = _engines(False, cache_len=20)
    with pytest.raises(ValueError, match="KV cache overflow"):
        teng.generate({"tokens": torch.zeros((1, 12), dtype=torch.long)}, 9)
    with pytest.raises(ValueError, match="max_new_tokens"):
        teng.generate({"tokens": torch.zeros((1, 4), dtype=torch.long)}, 0)


def test_greedy_sampler():
    logits = torch.tensor([[0.0, 2.0, 2.0], [3.0, 1.0, 0.0]])
    assert greedy(logits).tolist() == [1, 0]          # first max on ties
    assert make_sampler("greedy") is greedy
    # top_p is ported: a sampler of logits and the reference's Gumbel draw;
    # greedy takes no kwargs, as in the reference
    top = make_sampler("top_p", p=1e-6)
    assert top(logits, gumbel=torch.zeros_like(logits)).tolist() == [2, 0]   # argmax, last on ties
    with pytest.raises(ValueError, match="greedy sampler takes no kwargs"):
        make_sampler("greedy", p=0.9)
    with pytest.raises(ValueError):
        make_sampler("beam")


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
                      "--prompt-len", "6", "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "quantized bytes fraction" in out
    assert tuple(res.tokens.shape) == (2, 4)


def test_serve_cli_no_quantize_and_bad_arch(capsys):
    serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "1",
                "--prompt-len", "4", "--steps", "2", "--device", "cpu", "--no-quantize"])
    assert "quantized bytes fraction: 0.000" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "llama-9000", "--device", "cpu"])


def test_entry_points_require_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_lm(cfg)
    params = transformer.init_lm(cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(build(cfg), params, cache_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params_from_numpy({"w": np.ones(3, np.float32)})
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced"])
    assert "CUDA is not available" in capsys.readouterr().err


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_file_matches_chip_smoke():
    cs = _chip_smoke()
    golden = json.loads(cs.GOLDEN_FILE.read_text())
    for k, v in cs.GOLDEN.items():
        assert golden[k] == v, k
    cfg = cs.golden_config()
    assert golden["d_model"] == cfg.d_model == load_config("tinyllama-1.1b").d_model
    assert golden["prompt"] == cs.golden_prompt(cfg.vocab_size).tolist()
    assert np.asarray(golden["tokens"]).shape == (cs.GOLDEN["batch"],
                                                   cs.GOLDEN["max_new_tokens"])
    assert len(golden["weights_checksum"]) == 64 and golden["made_by"] == \
        "tests/make_torch_golden.py"
    # the ragged trace served by serve_ragged(mode="paged"), per KV pool type
    ragged = golden["ragged"]
    for k, v in cs.GOLDEN_RAGGED.items():
        assert ragged[k] == v, k
    assert ragged["prompts"] == cs.golden_ragged_prompts(cfg.vocab_size)
    assert [len(p) for p in ragged["prompts"]] == cs.GOLDEN_RAGGED["prompt_lens"]
    for kv in cs.GOLDEN_RAGGED["kv"]:
        assert [len(t) for t in ragged["tokens"][kv]] == cs.GOLDEN_RAGGED["budgets"]
        assert ragged["lengths"][kv] == cs.GOLDEN_RAGGED["budgets"]    # no eos_id
        assert all(0 <= t < cfg.vocab_size for row in ragged["tokens"][kv] for t in row)
        assert 0 < ragged["peak_blocks"][kv] <= cs.GOLDEN_RAGGED["slots"] * -(
            -cs.GOLDEN_RAGGED["cache_len"] // cs.GOLDEN_RAGGED["block_size"])
    # generate under every other weight setting, and how many tokens the
    # port's plain path reproduced on the CPU (chip_smoke shows it beside
    # the card's count)
    total = cs.GOLDEN["batch"] * cs.GOLDEN["max_new_tokens"]
    assert list(golden["formats"]) == cs.GOLDEN["weight_formats"] == list(cs.FORMAT_SETTINGS)
    for fmt, toks in golden["formats"].items():
        assert np.asarray(toks).shape == (cs.GOLDEN["batch"], cs.GOLDEN["max_new_tokens"])
        assert all(0 <= t < cfg.vocab_size for row in toks for t in row)
    cpu = golden["port_cpu_equal"]
    assert set(cpu["generate"]) == {"int8", *cs.FORMAT_SETTINGS}
    assert all(0 <= n <= total for n in cpu["generate"].values())
    assert cpu["generate"]["int8"] == total         # the int8 golden run is required exact
    assert set(cpu["ragged"]) == set(cs.GOLDEN_RAGGED["kv"])
    assert cpu["ragged"]["float"] == sum(cs.GOLDEN_RAGGED["budgets"])
