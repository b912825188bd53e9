"""Trace where the port's golden prefill first leaves the reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/trace_torch_golden.py [FORMAT] [--flags]

Builds the golden configuration (``chip_smoke.GOLDEN``: TinyLlama at full
width, 2 layers, f32), quantizes it with the REFERENCE in ``FORMAT`` (a
format or preset, default int8), hands those weights to the port, runs both
packages' prefill on the golden prompt on the CPU, and prints, for every
quantized projection in call order and every batch row: the largest
difference of the float input, the number of int8 activation values the two
packages round differently, and the largest output difference; then the
first few of those rounding flips with each package's x and x / S. With
``--flags`` both prefills run under the perf-variant flags of
``chip_smoke.GOLDEN["flags"]`` (blockwise attention: the reference's
``_mha_blockwise`` against the port's flash attention). A helper (pytest
does not collect it); it imports both packages.
"""

from __future__ import annotations

import dataclasses
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

from _torch_helpers import both_flags, jax_to_numpy, numpy_to_jax  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.registry import build, load_config  # noqa: E402
from repro.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build as tbuild  # noqa: E402


def _capture():
    """Patch both packages' quantized_matmul to record (x, xq, xs, out)."""
    ref, port = [], []
    jqmm, tqmm = jops.quantized_matmul, ops.quantized_matmul

    def ref_fn(x, w, *, impl="auto"):
        out = jqmm(x, w, impl=impl)
        q = jops.quantize_activation(x, group_size=w.group_size)
        jax.debug.callback(lambda *a: ref.append([np.asarray(t) for t in a]),
                           x, q.qvalues, q.scales, out, ordered=True)
        return out

    def port_fn(x, w, *, impl=None):
        out = tqmm(x, w, impl=impl)
        q = ops.quantize_activation(x, group_size=w.group_size)
        port.append([t.numpy().copy() for t in (x, q.qvalues, q.scales, out)])
        return out

    jops.quantized_matmul, ops.quantized_matmul = ref_fn, port_fn
    return ref, port


def main(fmt: str = "int8", with_flags: bool = False) -> None:
    g = chip_smoke.GOLDEN
    cfg_port = chip_smoke.golden_config()
    cfg = dataclasses.replace(load_config(g["arch"]), num_layers=g["num_layers"],
                              param_dtype=g["dtype"], compute_dtype=g["dtype"])
    tree = init_params_numpy(cfg_port, g["seed"])
    prompt = chip_smoke.golden_prompt(cfg.vocab_size)
    cache_len = g["prompt_len"] + g["max_new_tokens"]
    engine = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=fmt, cache_len=cache_len)
    del tree
    ref, port = _capture()
    with both_flags(**(g["flags"] if with_flags else {})):
        jl, _ = jax.jit(lambda p, t: engine.model.prefill(p, {"tokens": t}, cache_len))(
            engine.params, jnp.asarray(prompt, jnp.int32))
        with torch.inference_mode():
            tl, _ = tbuild(cfg_port).prefill(
                params_from_numpy(jax_to_numpy(engine.params), "cpu"),
                {"tokens": torch.as_tensor(prompt)}, cache_len)
    names = ["wqkv", "wo", "w13", "w2"] * cfg.num_layers + ["classifier"]
    for i, ((x0, q0, s0, o0), (x1, q1, s1, o1)) in enumerate(zip(ref, port)):
        for r in range(x0.shape[0]):
            flips = np.argwhere(q0[r] != q1[r])
            print(f"call {i} layer {i // 4} {names[i]:10s} row {r}: max|dx| "
                  f"{np.abs(x0[r] - x1[r]).max():.3e} (max|x| {np.abs(x0[r]).max():.3e}), "
                  f"{len(flips)} int8 flips, max|dout| {np.abs(o0[r] - o1[r]).max():.3e}")
            gs = x0.shape[-1] // s0.shape[-1]
            for j in flips[:3]:
                j = tuple(int(k) for k in j)
                grp = (*j[:-1], j[-1] // gs)
                print(f"    flip at {j}: reference x={x0[r][j]!r} x/S="
                      f"{x0[r][j] / s0[r][grp]!r} -> {q0[r][j]}; port x={x1[r][j]!r} x/S="
                      f"{x1[r][j] / s1[r][grp]!r} -> {q1[r][j]}")
    print("last-position logits, max|diff| per row:",
          np.abs(np.asarray(jl) - tl.numpy()).max(-1), "max|logit|", np.abs(np.asarray(jl)).max())


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--flags"]
    main(*args[:1], with_flags="--flags" in sys.argv[1:])
