"""Why the port's int8 run of the 22-layer golden leaves the reference's.

The deep golden (``chip_smoke.GOLDEN_DEEP``: TinyLlama at full width and
depth, the golden prompt, f32) gives the reference's tokens with f32 and
int8 weights. The port's plain CPU path reproduces all 32 f32 tokens but
28 of 32 int8 ones: batch row 0 leaves at its 13th token (decode step 12),
where the port's top logit beats the reference's token by 7.0e-4 of
max|logit|. ``python tests/trace_torch_golden.py int8 --layers 22 --steps
16`` traces it, feeding both packages the reference's tokens: row 0's first
difference is in the prefill, at layer 1's ``wqkv`` input, position 11,
column 1095, where the two packages' float inputs agree to f32 rounding and
x / S sits within a few ulp of 14.5 (14.49999 in the reference, 14.5000105
in the port), so the activation quantizer rounds it to 14 in one and 15 in
the other. The same kind of tie as the 2-layer golden's
(``tests/test_torch_activation_flip.py``), one layer deeper.

The test rebuilds that input from the 22-layer weights: layer 0 as drawn
for a 22-layer model (the draws are stacked per leaf, so layer 0 of a
22-layer draw is not layer 0 of a 2-layer one), then layer 1's attention
norm (ones). Drawing the stream up to layer 0's w2 takes ~25 s.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import jax_to_numpy, numpy_to_jax  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ROW, POS, COLUMN, HALF = 0, 11, 1095, 14.5     # batch row, position, column, x / S


def _deep_layer0(cfg, seed):
    """Embedding and layer-0 weights of ``bridge.init_params_numpy`` for
    ``cfg`` (22 layers), drawn from the same stream one layer at a time:
    a leaf's other layers are drawn and dropped."""
    rng = np.random.RandomState(seed)
    d, L = cfg.d_model, cfg.num_layers

    def normal(shape, scale):
        return rng.standard_normal(shape).astype(np.float32) * np.float32(scale)

    embed = normal((cfg.vocab_padded, d), 0.02)
    layer0 = {}
    for name, (out_dim, in_dim) in (("wqkv", (cfg.q_dim + 2 * cfg.kv_dim, d)),
                                    ("wo", (d, cfg.q_dim)), ("w13", (2 * cfg.d_ff, d)),
                                    ("w2", (d, cfg.d_ff))):
        layer0[name] = normal((out_dim, in_dim), in_dim ** -0.5)
        for _ in range(L - 1 if name != "w2" else 0):   # w2 is the last leaf needed
            normal((out_dim, in_dim), in_dim ** -0.5)
    return embed, layer0


def _two_layer_tree(cfg22):
    """A 2-layer tree whose layer 0 is the 22-layer model's and whose layer 1
    repeats it (only layer 1's attention norm, ones, reaches the traced
    input); the classifier reuses the embedding's shape and values."""
    embed, l0 = _deep_layer0(cfg22, chip_smoke.GOLDEN["seed"])
    d = cfg22.d_model
    two = lambda a: np.stack([a, a])  # noqa: E731
    return {"embed": embed,
            "layers": {"att_norm": np.ones((2, d), np.float32),
                       "attn": {"wqkv": two(l0["wqkv"]), "wo": two(l0["wo"])},
                       "ffn_norm": np.ones((2, d), np.float32),
                       "mlp": {"w13": two(l0["w13"]), "w2": two(l0["w2"])}},
            "final_norm": np.ones((d,), np.float32),
            "classifier": embed}


def test_deep_golden_int8_divergence_is_an_activation_tie(monkeypatch):
    g = chip_smoke.GOLDEN
    cfg22 = chip_smoke.golden_config(chip_smoke.GOLDEN_DEEP["num_layers"])
    cfg2 = chip_smoke.golden_config(2)
    jcfg2 = dataclasses.replace(jload(g["arch"]), num_layers=2, param_dtype=g["dtype"],
                                compute_dtype=g["dtype"])
    tree = _two_layer_tree(cfg22)
    prompt = chip_smoke.golden_prompt(cfg2.vocab_size)
    cache_len = g["prompt_len"] + g["max_new_tokens"]
    engine = InferenceEngine(jbuild(jcfg2), numpy_to_jax(tree), quantize=g["quantize"],
                             cache_len=cache_len)
    del tree
    seen = {"ref": [], "port": []}
    jqmm, tqmm = jops.quantized_matmul, ops.quantized_matmul

    def ref_capture(x, w, *, impl="auto"):
        jax.debug.callback(lambda a: seen["ref"].append(np.asarray(a)), x, ordered=True)
        return jqmm(x, w, impl=impl)

    def port_capture(x, w, *, impl=None):
        seen["port"].append(x.numpy().copy())
        return tqmm(x, w, impl=impl)

    monkeypatch.setattr(jops, "quantized_matmul", ref_capture)
    monkeypatch.setattr(ops, "quantized_matmul", port_capture)
    # a fresh jit: the patched quantized_matmul is read while tracing
    jax.jit(lambda p, t: engine.model.prefill(p, {"tokens": t}, cache_len)[0])(
        engine.params, jnp.asarray(prompt, jnp.int32)).block_until_ready()
    with torch.inference_mode():
        build(cfg2).prefill(params_from_numpy(jax_to_numpy(engine.params), "cpu"),
                            {"tokens": torch.as_tensor(prompt)}, cache_len)
    gs = cfg2.group_size

    def q8(x):
        qr = jquant.quantize_activation(jnp.asarray(x), gs)
        return np.asarray(qr.qvalues), np.asarray(qr.scales)

    # calls 0-3 are layer 0's wqkv, wo, w13, w2: batch row 0 rounds every
    # activation alike there
    for xr, xp in zip(seen["ref"][:4], seen["port"][:4]):
        assert np.array_equal(q8(xr[ROW])[0], quant.quantize_activation(
            torch.from_numpy(xp[ROW]), gs).qvalues.numpy())
    # call 4, layer 1's wqkv input: floats equal to f32 rounding, one flip
    xr, xp = seen["ref"][4][ROW], seen["port"][4][ROW]
    assert xr.shape == xp.shape == (g["prompt_len"], cfg2.d_model)
    assert np.abs(xr - xp).max() <= 4 * np.finfo(np.float32).eps * np.abs(xr).max()
    (qr, sr), pq = q8(xr), quant.quantize_activation(torch.from_numpy(xp), gs)
    qp, sp = pq.qvalues.numpy(), pq.scales.numpy()
    assert [tuple(int(i) for i in f) for f in np.argwhere(qr != qp)] == [(POS, COLUMN)]
    ratios = (xr[POS, COLUMN] / sr[POS, COLUMN // gs], xp[POS, COLUMN] / sp[POS, COLUMN // gs])
    assert all(abs(r - HALF) < 2e-5 for r in ratios)
    assert (ratios[0] - HALF) * (ratios[1] - HALF) < 0      # on either side of the tie


def test_deep_golden_records_only_that_tie():
    """The golden file's deep section: f32 replays exactly on the CPU; int8
    loses the reference's token only at row 0's decode step 12, a near tie
    (far inside TIE_MARGIN) that follows the activation tie above. The
    card's deep check allows a replay difference only at these steps."""
    deep = json.loads(chip_smoke.GOLDEN_FILE.read_text())["deep"]
    assert deep["num_layers"] == 22 and deep["port_cpu_equal"] == {"float32": 32, "int8": 28}
    assert deep["port_cpu_replay_differs"]["float32"] == []
    (off,) = deep["port_cpu_replay_differs"]["int8"]
    assert (off["step"], off["row"]) == (12, ROW) and 0 < off["margin"] < 1e-3
    assert off["margin"] < chip_smoke.TIE_MARGIN
