"""Write the golden tokens that ``chip_smoke.py`` holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py [--deep-only]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py --arch ID

With ``--arch`` (one of ``chip_smoke.FAMILY_GOLDEN["archs"]``: internlm2-1.8b,
gemma2-2b, minicpm3-4b, deepseek-v2-lite-16b, rwkv6-7b, zamba2-7b,
seamless-m4t-large-v2) it writes that family's golden instead,
``src/repro_torch/golden_<arch>.json``: the config at full width, depth cut
to ``chip_smoke.family_golden_settings``'s layer count (2; zamba2 7: one
shared-block application and a tail layer; seamless 2 + 2, with frames
from ``chip_smoke.family_golden_extra``; about 4 GB of f32 weights a
package each, seamless 2.6 GB), f32 params and
compute, weights from ``init_params_numpy``; the reference's greedy
``generate`` tokens on the golden prompt with f32 weights and with int8
weights, and how many of them the port's plain path reproduces on the CPU,
each setting replayed on the reference's tokens too (the steps where the
port chooses another token, with the margin), and where the CPU run is not
exact the first int8 rounding (or MoE router choice) in which the two
packages differ along the reference's tokens (``port_cpu_first_difference``,
``tests/_torch_families.first_difference``). A few GB and a minute or two a
family (gemma2's 256,000 x 2304 tied embedding is the largest leaf);
deepseek-v2-lite-16b's 2 x 64 experts make ~8 GB of f32 weights a package.
dbrx-132b has no golden: 2 layers at full width are ~6.5 G weights, ~26 GB
of f32 in each package.

Builds TinyLlama at full width (depth cut to ``chip_smoke.GOLDEN``'s layer
count, f32 params and compute) with ``repro_torch.bridge.init_params_numpy``,
then runs the REFERENCE package on the CPU: ``quantize_params`` (int8, via
``InferenceEngine(quantize=True)``), greedy ``InferenceEngine.generate``,
``serve_ragged(mode="paged")`` over the ragged trace ``chip_smoke.GOLDEN_RAGGED``
with a float, int8 and fp8 KV pool, ``generate`` once more with each
weight setting of ``chip_smoke.GOLDEN["weight_formats"]`` (int4, int3, fp8,
mixed, mixed3), and int8 ``generate`` under the perf-variant flags
``chip_smoke.GOLDEN["flags"]`` (blockwise prefill, deferred decode, kvt
cache). The tokens, lengths and pool high-water marks, the prompts,
a hash of the weights and the library versions go to
``src/repro_torch/golden_tinyllama.json``, together with how many of those
tokens the PORT's plain path reproduces on the CPU (``port_cpu_equal``).
``chip_smoke.py`` rebuilds the same weights on the card and requires the
port's tokens to be identical for int8 ``generate`` and the float pool; for
the other settings, and for the flags where the CPU run was not exact, it
requires every replayed reference token to be the card's greedy choice or a
near tie of it, and shows the free-running count beside the CPU's.

The deep section (``chip_smoke.GOLDEN_DEEP``) repeats the golden prompt on
the same weights drawn at TinyLlama's full depth of 22 layers: the
reference's greedy tokens with f32 weights and with int8 weights, the
port's plain CPU agreement with each, and the steps at which the port's CPU
run, replayed on the reference's tokens, chooses another token (with the
margin as a fraction of max|logit|): the ties that
``tests/test_torch_deep_tie.py`` traces to a .5 activation tie. It takes
about 4 minutes and 15 GB on an 8-core CPU; ``--deep-only`` recomputes just
that section and keeps the rest of the file.

A helper, not a test (pytest does not collect it); it imports both packages.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_families import first_difference  # noqa: E402
from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.models.registry import build, load_config  # noqa: E402
from repro.serving.batching import Request, serve_ragged  # noqa: E402
from repro.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.models.registry import build as tbuild  # noqa: E402
from repro_torch.serving.batching import Request as TRequest  # noqa: E402
from repro_torch.serving.batching import serve_ragged as tserve_ragged  # noqa: E402
from repro_torch.serving.engine import InferenceEngine as TEngine  # noqa: E402


def _equal(a, b) -> int:
    return sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))


def deep_section(prompt: np.ndarray) -> dict:
    """The 22-layer golden: reference tokens with f32 and int8 weights, and
    the port's plain CPU run against them (free-running and replayed)."""
    g, gd = chip_smoke.GOLDEN, chip_smoke.GOLDEN_DEEP
    cfg_port = chip_smoke.golden_config(gd["num_layers"])
    cfg = dataclasses.replace(load_config(g["arch"]), num_layers=gd["num_layers"],
                              param_dtype=g["dtype"], compute_dtype=g["dtype"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_port), "config drift"
    tree = init_params_numpy(cfg_port, g["seed"])
    out = dict(gd, tokens={}, port_cpu_equal={}, port_cpu_replay_differs={},
               weights_checksum=chip_smoke.weights_checksum(tree))
    cache_len = g["prompt_len"] + g["max_new_tokens"]
    jparams = numpy_to_jax(tree)
    tparams = params_from_numpy(tree, "cpu")
    del tree
    for setting in gd["settings"]:
        quantize = g["quantize"] if setting == "int8" else False
        eng = InferenceEngine(build(cfg), jparams, quantize=quantize, cache_len=cache_len)
        want = np.asarray(eng.generate({"tokens": jnp.asarray(prompt, jnp.int32)},
                                       g["max_new_tokens"]).tokens).tolist()
        del eng
        te = TEngine(tbuild(cfg_port), tparams, quantize=quantize, cache_len=cache_len,
                     device="cpu")
        got = te.generate({"tokens": torch.as_tensor(prompt)}, g["max_new_tokens"]).tokens.tolist()
        out["tokens"][setting] = want
        out["port_cpu_equal"][setting] = _equal(got, want)
        out["port_cpu_replay_differs"][setting] = chip_smoke.replay_choices(te, prompt,
                                                                            np.asarray(want))
        del te
        print(f"deep golden, {setting}: the port's plain CPU run matches "
              f"{out['port_cpu_equal'][setting]} of the reference's tokens; replayed, it "
              f"differs at {out['port_cpu_replay_differs'][setting]}", flush=True)
    return out


def family_golden(arch: str) -> None:
    fg = chip_smoke.family_golden_settings(arch)
    cfg_port = chip_smoke.family_golden_config(arch)
    cfg = dataclasses.replace(load_config(arch), num_layers=fg["num_layers"],
                              encoder_layers=fg.get("encoder_layers", 0),
                              param_dtype=fg["dtype"], compute_dtype=fg["dtype"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_port), "config drift"
    tree = init_params_numpy(cfg_port, fg["seed"])
    prompt = chip_smoke.family_golden_prompt(cfg.vocab_size)
    extra = chip_smoke.family_golden_extra(cfg_port)      # the encoder-decoder's frames
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.as_tensor(v) for k, v in extra.items()}
    cache_len = fg["prompt_len"] + fg["max_new_tokens"]
    tparams = params_from_numpy(tree, "cpu")
    out = dict(fg, arch=arch, d_model=cfg.d_model, prompt=prompt.tolist(), tokens={},
               port_cpu_equal={}, port_cpu_replay_differs={}, port_cpu_first_difference={})
    for setting in fg["settings"]:
        quantize = setting if setting != "float32" else False
        eng = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=quantize,
                              cache_len=cache_len)
        want = np.asarray(eng.generate({"tokens": jnp.asarray(prompt, jnp.int32), **jextra},
                                       fg["max_new_tokens"]).tokens)
        te = TEngine(tbuild(cfg_port), tparams, quantize=quantize, cache_len=cache_len,
                     device="cpu")
        got = te.generate({"tokens": torch.as_tensor(prompt), **textra},
                          fg["max_new_tokens"]).tokens
        out["tokens"][setting] = want.tolist()
        out["port_cpu_equal"][setting] = _equal(got.tolist(), want.tolist())
        # the steps where the port's CPU run, fed the reference's tokens,
        # chooses another token (with the margin), and where it is not
        # exact, the first rounding or router choice behind it
        out["port_cpu_replay_differs"][setting] = chip_smoke.replay_choices(te, prompt, want,
                                                                            textra)
        if out["port_cpu_equal"][setting] != want.size:
            out["port_cpu_first_difference"][setting] = first_difference(eng, te, prompt, want,
                                                                         extra)
            print(f"{arch} {setting}: first difference "
                  f"{out['port_cpu_first_difference'][setting]}", flush=True)
        del eng
        print(f"{arch} {setting}: the port's plain CPU run reproduces "
              f"{out['port_cpu_equal'][setting]}/{want.size} tokens; replayed, it differs at "
              f"{out['port_cpu_replay_differs'][setting]}", flush=True)
        del te
    out.update({"weights_checksum": chip_smoke.weights_checksum(tree),
                "numpy": np.__version__, "jax": jax.__version__,
                "made_by": "tests/make_torch_golden.py --arch " + arch})
    path = chip_smoke.family_golden_file(arch)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path.relative_to(ROOT)}")


def main() -> None:
    if "--arch" in sys.argv[1:]:
        arch = sys.argv[sys.argv.index("--arch") + 1]
        if arch != chip_smoke.GOLDEN["arch"]:
            family_golden(arch)
            return
    if "--deep-only" in sys.argv[1:]:
        out = json.loads(chip_smoke.GOLDEN_FILE.read_text())
        out["deep"] = deep_section(np.asarray(out["prompt"]))
        chip_smoke.GOLDEN_FILE.write_text(json.dumps(out, indent=1) + "\n")
        print(f"wrote the deep section of {chip_smoke.GOLDEN_FILE.relative_to(ROOT)}")
        return
    g = chip_smoke.GOLDEN
    cfg_port = chip_smoke.golden_config()
    cfg = dataclasses.replace(load_config(g["arch"]), num_layers=g["num_layers"],
                              param_dtype=g["dtype"], compute_dtype=g["dtype"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_port), "config drift"
    tree = init_params_numpy(cfg_port, g["seed"])
    prompt = chip_smoke.golden_prompt(cfg.vocab_size)
    engine = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=g["quantize"],
                             cache_len=g["prompt_len"] + g["max_new_tokens"])
    res = engine.generate({"tokens": jnp.asarray(prompt, jnp.int32)}, g["max_new_tokens"])

    # the ragged trace through serve_ragged(mode="paged"), one KV pool type each
    gr = chip_smoke.GOLDEN_RAGGED
    prompts = chip_smoke.golden_ragged_prompts(cfg.vocab_size)
    ragged = dict(gr, prompts=prompts, tokens={}, lengths={}, peak_blocks={})
    for kv in gr["kv"]:
        eng = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=g["quantize"],
                              cache_len=gr["cache_len"], kv_quant=None if kv == "float" else kv)
        reqs = [Request(i, p, max_new=n) for i, (p, n) in enumerate(zip(prompts, gr["budgets"]))]
        got = serve_ragged(eng, reqs, gr["max_new_tokens"], mode="paged", slots=gr["slots"],
                           chunk=gr["chunk"], block_size=gr["block_size"])
        ragged["tokens"][kv] = [np.asarray(r.tokens).tolist() for r in got]
        ragged["lengths"][kv] = [r.length for r in got]
        # the one scheduler serve_ragged built and cached on the engine
        (sched,) = eng._paged_schedulers.values()
        ragged["peak_blocks"][kv] = sched.last_peak_blocks

    cache_len = g["prompt_len"] + g["max_new_tokens"]
    formats = {}
    for fmt in g["weight_formats"]:
        eng = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=fmt, cache_len=cache_len)
        res_f = eng.generate({"tokens": jnp.asarray(prompt, jnp.int32)}, g["max_new_tokens"])
        formats[fmt] = np.asarray(res_f.tokens).tolist()

    with both_flags(**g["flags"]):
        eng = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=g["quantize"],
                              cache_len=cache_len)
        flags_tokens = np.asarray(eng.generate({"tokens": jnp.asarray(prompt, jnp.int32)},
                                               g["max_new_tokens"]).tokens).tolist()

    # the port's plain path on the CPU over the same weights: how many of the
    # reference's tokens it reproduces (chip_smoke shows it beside the
    # card's count)
    tparams = params_from_numpy(tree, "cpu")

    def port_generate(quantize):
        te = TEngine(tbuild(cfg_port), tparams, quantize=quantize, cache_len=cache_len,
                     device="cpu")
        return te.generate({"tokens": torch.as_tensor(prompt)}, g["max_new_tokens"]).tokens.tolist()

    port_cpu = {"generate": {"int8": _equal(port_generate(g["quantize"]),
                                               np.asarray(res.tokens).tolist())},
                "ragged": {}}
    for fmt in g["weight_formats"]:
        port_cpu["generate"][fmt] = _equal(port_generate(fmt), formats[fmt])
    with both_flags(**g["flags"]):
        port_cpu["generate_flags"] = _equal(port_generate(g["quantize"]), flags_tokens)
    for kv in gr["kv"]:
        te = TEngine(tbuild(cfg_port), tparams, quantize=g["quantize"], cache_len=gr["cache_len"],
                     kv_quant=None if kv == "float" else kv, device="cpu")
        reqs = [TRequest(i, p, max_new=n) for i, (p, n) in enumerate(zip(prompts, gr["budgets"]))]
        got = tserve_ragged(te, reqs, gr["max_new_tokens"], mode="paged", slots=gr["slots"],
                            chunk=gr["chunk"], block_size=gr["block_size"])
        port_cpu["ragged"][kv] = _equal([np.asarray(r.tokens).tolist() for r in got],
                                        ragged["tokens"][kv])

    out = dict(g)
    out.update({
        "d_model": cfg.d_model,
        "prompt": prompt.tolist(),
        "tokens": np.asarray(res.tokens).tolist(),
        "ragged": ragged,
        "formats": formats,
        "flags_tokens": flags_tokens,
        "port_cpu_equal": port_cpu,
        "deep": deep_section(prompt),
        "weights_checksum": chip_smoke.weights_checksum(tree),
        "numpy": np.__version__,
        "jax": jax.__version__,
        "made_by": "tests/make_torch_golden.py",
    })
    chip_smoke.GOLDEN_FILE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {chip_smoke.GOLDEN_FILE.relative_to(ROOT)}: tokens {out['tokens']}; "
          f"the port's plain path on the CPU reproduces {port_cpu}")


if __name__ == "__main__":
    main()
