"""Trace where the port's golden run first leaves the reference's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/trace_torch_golden.py [FORMAT] [--flags] \
        [--layers N] [--steps K] [--dump PATH]

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

``--layers N`` builds the golden model N layers deep instead (22 is
TinyLlama's full depth: a few minutes and ~12 GB on the CPU). ``--steps K``
then also traces K greedy decode steps: both packages are fed the
reference's own greedy token at every step (so a divergence cannot
compound through the token stream), each step prints the calls whose int8
activations differ (with the first flips' x / S) and, per row, whether
the two packages' greedy tokens agree and the port's margin between its
top logit and the reference's token, as a fraction of max|logit|. The
first call, in prefill-then-step order, with a flip whose float input
agrees to f32 rounding is where the two runs part. ``--dump PATH`` also
writes the reference's side of every traced call (x, its int8 values and
scales) and the tokens fed to an ``.npz`` file, which
``tests/trace_torch_card.py --against PATH`` holds the card's run to.
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


def _report_calls(ref, port, names, label: str, verbose: bool) -> int:
    """Print the captured calls (every one if verbose, else those whose int8
    activations differ); returns the number of calls with a flip."""
    nflip = 0
    for i, ((x0, q0, s0, o0), (x1, q1, s1, o1)) in enumerate(zip(ref, port)):
        x0, q0, s0, o0, x1, q1, s1, o1 = (a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a[None]
                                          for a in (x0, q0, s0, o0, x1, q1, s1, o1))
        for r in range(x0.shape[0]):
            flips = np.argwhere(q0[r] != q1[r])
            nflip += bool(len(flips))
            if not (verbose or len(flips)):
                continue
            print(f"{label} call {i} layer {i // 4} {names[i % len(names)]:10s} row {r}: "
                  f"max|dx| {np.abs(x0[r] - x1[r]).max():.3e} (max|x| "
                  f"{np.abs(x0[r]).max():.3e}), {len(flips)} int8 flips, max|dout| "
                  f"{np.abs(o0[r] - o1[r]).max():.3e}")
            gs = x0.shape[-1] // s0.shape[-1]
            for j in flips[:3]:
                j = int(j[0])
                print(f"    flip at column {j}: reference x={x0[r][j]!r} x/S="
                      f"{x0[r][j] / s0[r][j // gs]!r} -> {q0[r][j]}; port x={x1[r][j]!r} x/S="
                      f"{x1[r][j] / s1[r][j // gs]!r} -> {q1[r][j]}")
    return nflip


def main(fmt: str = "int8", with_flags: bool = False, layers: int | None = None,
         steps: int = 0, dump: str | None = None) -> None:
    g = chip_smoke.GOLDEN
    nl = layers or g["num_layers"]
    cfg_port = dataclasses.replace(chip_smoke.golden_config(), num_layers=nl)
    cfg = dataclasses.replace(load_config(g["arch"]), num_layers=nl,
                              param_dtype=g["dtype"], compute_dtype=g["dtype"])
    tree = init_params_numpy(cfg_port, g["seed"])
    prompt = chip_smoke.golden_prompt(cfg.vocab_size)
    cache_len = g["prompt_len"] + g["max_new_tokens"]
    engine = InferenceEngine(build(cfg), numpy_to_jax(tree), quantize=fmt, cache_len=cache_len)
    del tree
    ref, port = _capture()
    tparams = params_from_numpy(jax_to_numpy(engine.params), "cpu")
    tmodel = tbuild(cfg_port)
    names = ["wqkv", "wo", "w13", "w2"] * cfg.num_layers + ["classifier"]
    with both_flags(**(g["flags"] if with_flags else {})):
        jl, jcache = jax.jit(lambda p, t: engine.model.prefill(p, {"tokens": t}, cache_len))(
            engine.params, jnp.asarray(prompt, jnp.int32))
        with torch.inference_mode():
            tl, tcache = tmodel.prefill(tparams, {"tokens": torch.as_tensor(prompt)}, cache_len)
        saved, fed = {}, []

        def keep(step):
            for i, (x, q, sc, _) in enumerate(ref):
                saved.update({f"s{step}_c{i}_x": x, f"s{step}_c{i}_q": q, f"s{step}_c{i}_s": sc})

        keep(0)
        nflip = _report_calls(ref, port, names, "prefill", verbose=steps == 0)
        print("last-position logits, max|diff| per row:",
              np.abs(np.asarray(jl) - tl.numpy()).max(-1), "max|logit|",
              np.abs(np.asarray(jl)).max(), f"; {nflip} (call, row) pairs with int8 flips")
        jdecode = jax.jit(engine.model.decode)
        for step in range(steps):
            jlog, tlog = np.asarray(jl), tl.numpy()
            want = jlog.argmax(-1)              # the reference's greedy token, fed to both
            gap = (tlog.max(-1) - tlog[np.arange(len(want)), want]) / np.abs(tlog).max()
            print(f"step {step}: reference tokens {want.tolist()}, port "
                  f"{tlog.argmax(-1).tolist()}, port margin to the reference's token "
                  f"{gap.tolist()} of max|logit|, max|dlogit| {np.abs(jlog - tlog).max():.3e}")
            fed.append(want)
            if step + 1 == steps:
                break
            ref.clear()
            port.clear()
            pos = g["prompt_len"] + step
            jl, jcache = jdecode(engine.params, jnp.asarray(want, jnp.int32), jcache,
                                 jnp.int32(pos))
            with torch.inference_mode():
                tl, tcache = tmodel.decode(tparams, torch.as_tensor(want), tcache, pos)
            keep(step + 1)
            nflip = _report_calls(ref, port, names, f"step {step + 1}", verbose=False)
            print(f"step {step + 1}: {nflip} (call, row) pairs with int8 flips")
    if dump:
        np.savez(dump, tokens=np.stack(fed, 1) if fed else np.zeros((len(prompt), 0)),
                 steps=np.int64(len(fed)), calls=np.int64(len(names)), **saved)
        print(f"wrote {dump}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("fmt", nargs="?", default="int8")
    ap.add_argument("--flags", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--dump", default=None)
    a = ap.parse_args()
    main(a.fmt, with_flags=a.flags, layers=a.layers, steps=a.steps, dump=a.dump)
