"""Where the port's f32 golden run first leaves the reference's.

With int8 weights, the reference's own quantized weights handed to the
port, and f32 everywhere, the golden configuration (``chip_smoke.GOLDEN``:
TinyLlama at full width, 2 layers, the golden prompt) first differs from
the reference in an int8 activation, not in a float tensor: the input of
layer 0's ``wo`` (the attention output) agrees to f32 rounding, but at
batch row 1, position 11 it sits within a few ulp of a .5 boundary of the
activation quantizer at columns 1025 (x / S = 22.499985 in the reference,
22.500011 in the port) and 1890 (-2.499993 and -2.5000052), so the two
packages round it to different integers. The last position's logits see
position 11 only through layer 1's attention, which is why a 1-layer model
agrees to 9.5e-7 and the 2-layer one does not.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.common import rmsnorm as jrmsnorm  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro_torch.bridge import init_params_numpy  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import rmsnorm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FLIPS = [(1, 11, 1025), (1, 11, 1890)]   # (batch row, position, column)


def _wo_inputs(monkeypatch):
    """Layer 0's attention output (wo's input) in both packages, from the
    golden weights quantized by the reference."""
    g = chip_smoke.GOLDEN
    cfg_port = chip_smoke.golden_config()
    cfg = dataclasses.replace(jload(g["arch"]), num_layers=g["num_layers"],
                              param_dtype=g["dtype"], compute_dtype=g["dtype"])
    tree = init_params_numpy(cfg_port, g["seed"])
    prompt = chip_smoke.golden_prompt(cfg.vocab_size)
    gs = cfg.group_size
    emb = tree["embed"][prompt]        # group quantization is per row: gather first
    attn0 = {k: v[0] for k, v in tree["layers"]["attn"].items()}
    norm = tree["layers"]["att_norm"][0]
    del tree
    jw = {k: jquant.quantize_groupwise(jnp.asarray(v), gs) for k, v in attn0.items()}
    x = jquant.quantize_groupwise(jnp.asarray(emb), gs).dequantize()
    s = prompt.shape[1]

    seen = {}

    def ref_capture(xin, w, *, impl="auto"):
        jax.debug.callback(lambda a: seen.setdefault("ref", []).append(np.asarray(a)), xin)
        return jops_qmm(xin, w, impl=impl)

    def port_capture(xin, w, *, impl=None):
        seen.setdefault("port", []).append(xin.numpy().copy())
        return port_qmm(xin, w, impl=impl)

    jops_qmm, port_qmm = jops.quantized_matmul, ops.quantized_matmul
    monkeypatch.setattr(jops, "quantized_matmul", ref_capture)
    monkeypatch.setattr(ops, "quantized_matmul", port_capture)
    # a fresh jit: the patched quantized_matmul is read while tracing
    jax.jit(lambda e, p: jattn.gqa_prefill(p, jrmsnorm(e, jnp.asarray(norm), cfg.norm_eps),
                                            cfg, s)[0])(x, jw).block_until_ready()
    tw = {k: QuantizedTensor(torch.from_numpy(np.array(v.qvalues)),
                             torch.from_numpy(np.array(v.scales)), gs) for k, v in jw.items()}
    with torch.inference_mode():
        attention.gqa_prefill(tw, rmsnorm(torch.from_numpy(np.array(x)), torch.from_numpy(norm),
                                          cfg.norm_eps), cfg_port, s)
    # calls in order: wqkv, then wo
    return seen["ref"][1], seen["port"][1], gs


def test_golden_run_first_differs_at_an_activation_rounding_tie(monkeypatch):
    xr, xp, gs = _wo_inputs(monkeypatch)
    assert xr.shape == xp.shape == (2, 16, 2048)
    # the float inputs agree to f32 rounding (a few ulp of max|x|)
    assert np.abs(xr - xp).max() <= 4 * np.finfo(np.float32).eps * np.abs(xr).max()
    qr = jquant.quantize_activation(jnp.asarray(xr), gs)
    qp = quant.quantize_activation(torch.from_numpy(xp), gs)
    flips = np.argwhere(np.asarray(qr.qvalues) != qp.qvalues.numpy())
    assert [tuple(int(i) for i in f) for f in flips] == FLIPS
    for b, t, c in FLIPS:
        ratios = (xr[b, t, c] / np.asarray(qr.scales)[b, t, c // gs],
                  xp[b, t, c] / qp.scales.numpy()[b, t, c // gs])
        # both within a few ulp of the same .5 boundary, on either side of it
        half = np.floor(ratios[0]) + 0.5
        assert all(abs(r - half) < 2e-5 for r in ratios)
        assert (ratios[0] - half) * (ratios[1] - half) < 0
