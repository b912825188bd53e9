"""Write the golden tokens that ``chip_smoke.py`` holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_torch_golden.py

Builds TinyLlama at full width (depth cut to ``chip_smoke.GOLDEN``'s layer
count, f32 params and compute) with ``repro_torch.bridge.init_params_numpy``,
then runs the REFERENCE package on the CPU: ``quantize_params`` (int8, via
``InferenceEngine(quantize=True)``), greedy ``InferenceEngine.generate``, and
``serve_ragged(mode="paged")`` over the ragged trace ``chip_smoke.GOLDEN_RAGGED``
with a float, int8 and fp8 KV pool. The tokens, lengths and pool high-water
marks, the prompts, a hash of the weights and the library versions go to
``src/repro_torch/golden_tinyllama.json``. ``chip_smoke.py`` rebuilds the
same weights on the card and requires the port's tokens to be identical
(the float pool's; the quantized pools' agreement is shown).

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

from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.models.registry import build, load_config  # noqa: E402
from repro.serving.batching import Request, serve_ragged  # noqa: E402
from repro.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.bridge import init_params_numpy  # noqa: E402


def main() -> None:
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

    out = dict(g)
    out.update({
        "d_model": cfg.d_model,
        "prompt": prompt.tolist(),
        "tokens": np.asarray(res.tokens).tolist(),
        "ragged": ragged,
        "weights_checksum": chip_smoke.weights_checksum(tree),
        "numpy": np.__version__,
        "jax": jax.__version__,
        "made_by": "tests/make_torch_golden.py",
    })
    chip_smoke.GOLDEN_FILE.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {chip_smoke.GOLDEN_FILE.relative_to(ROOT)}: tokens {out['tokens']}")


if __name__ == "__main__":
    main()
