"""The port's tensor-parallel PTQ policy and quant's last two functions
against the reference: every leaf's group size (``leaf_group_size``, and
what ``quantize_params`` makes of it) at tp 1, 2, 4, 8 and 16 on the 11
configs; ``choose_group_size`` on each config's quantized dims; and
``quantization_error_stats`` in every format on seeded inputs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.core import quant as jquant
from repro.core.treepath import path_str
from repro.models import registry as jreg
from repro_torch.core import policy, quant
from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.tree import tensor_items
from repro_torch.models import registry

TPS = (1, 2, 4, 8, 16)

_STRUCTS: dict = {}


def _struct(cfg) -> dict:
    """``registry.param_struct`` once a config (dbrx's and deepseek's trees
    take seconds on fake tensors)."""
    if cfg.arch_id not in _STRUCTS:
        _STRUCTS[cfg.arch_id] = registry.param_struct(cfg)
    return _STRUCTS[cfg.arch_id]


def _ref_leaves(arch: str):
    cfg = jreg.load_config(arch)
    return cfg, jax.eval_shape(jreg.build(cfg).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_leaf_group_size_equals_reference_at_every_tp(arch):
    """leaf_group_size on every leaf of the full-size tree, and the format,
    group size and storage shape ``quantize_params`` gives each leaf (on
    meta tensors; the reference on abstract arrays), at every tp."""
    jcfg, jparams = _ref_leaves(arch)
    cfg = registry.load_config(arch)
    meta = _struct(cfg)
    jflat = {path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = dict(tensor_items(meta))
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in jflat.items()}
    for tp in TPS:
        for path, leaf in flat.items():
            p = path.lower()
            assert policy.leaf_group_size(p, leaf, cfg.group_size, tp) == \
                jpolicy.leaf_group_size(p, jflat[path], jcfg.group_size, tp), (tp, path)
        jq = jax.eval_shape(lambda t: jpolicy.quantize_params(
            t, jcfg.group_size, tp=tp, formats=jcfg.quant_format), jparams)
        jqflat = {path_str(p): x for p, x in jax.tree_util.tree_flatten_with_path(
            jq, is_leaf=lambda x: isinstance(x, jquant.QuantizedTensor))[0]}
        got = dict(tensor_items(policy.quantize_params(meta, cfg.group_size, tp=tp,
                                                        formats=cfg.quant_format), quant=True))
        assert set(got) == set(jqflat), tp
        for path, leaf in got.items():
            want = jqflat[path]
            if isinstance(want, jquant.QuantizedTensor):
                assert isinstance(leaf, QuantizedTensor), (tp, path)
                assert (leaf.fmt, leaf.group_size) == (want.fmt, want.group_size), (tp, path)
                assert tuple(leaf.qvalues.shape) == tuple(want.qvalues.shape), (tp, path)
                assert tuple(leaf.scales.shape) == tuple(want.scales.shape), (tp, path)
            else:
                assert not isinstance(leaf, QuantizedTensor), (tp, path)


def test_tp_changes_only_row_parallel_group_sizes():
    """tp 1 is today's tree; at tp 16 a row-parallel leaf's groups shrink
    to fit n/16 and a leaf tp does not divide stays float, as the
    reference's."""
    cfg = registry.load_config("internlm2-1.8b")
    meta = _struct(cfg)
    one = dict(tensor_items(policy.quantize_params(meta, cfg.group_size), quant=True))
    tp1 = dict(tensor_items(policy.quantize_params(meta, cfg.group_size, tp=1), quant=True))

    def kinds(tree):
        return {k: (v.fmt, v.group_size) if isinstance(v, QuantizedTensor) else None
                for k, v in tree.items()}

    assert kinds(one) == kinds(tp1)
    leaf = torch.empty((4, 96), device="meta")
    assert policy.leaf_group_size("layers/attn/wo", leaf, 256, 16) is None
    assert jpolicy.leaf_group_size("layers/attn/wo", jnp.zeros((4, 96)), 256, 16) is None
    assert policy.leaf_group_size("layers/attn/wo", torch.empty((4, 2048), device="meta"),
                                  256, 16) == 128
    assert policy.leaf_group_size("layers/mlp/experts/w2", torch.empty((4, 2048),
                                                                       device="meta"), 256, 16) \
        == 256
    assert policy._row_parallel("layers/mlp/w2") and not policy._row_parallel("layers/mlp/w13")
    assert policy.ROW_PARALLEL_KEYS == jpolicy.ROW_PARALLEL_KEYS


def test_tp_one_quantizes_bit_identically():
    rng = np.random.default_rng(3)
    params = {"layers": {"attn": {"wo": torch.as_tensor(
        rng.normal(size=(2, 64, 512)).astype(np.float32))}},
        "embed": torch.as_tensor(rng.normal(size=(96, 256)).astype(np.float32))}
    a = dict(tensor_items(policy.quantize_params(params, 256)))
    b = dict(tensor_items(policy.quantize_params(params, 256, tp=1)))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    c = dict(tensor_items(policy.quantize_params(params, 256, tp=4), quant=True))
    assert c["layers/attn/wo"].group_size == 128 and c["embed"].group_size == 256


def _quantized_dims(cfg) -> list[int]:
    """Each quantized leaf's contraction dim in the config's int8 tree."""
    q = policy.quantize_params(_struct(cfg), cfg.group_size)
    return sorted({leaf.logical_shape[-1] for _, leaf in tensor_items(q, quant=True)
                   if isinstance(leaf, QuantizedTensor)})


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_choose_group_size_equals_reference(arch):
    cfg = registry.load_config(arch)
    dims = _quantized_dims(cfg)
    for preferred, min_gs in ((256, 32), (128, 32), (256, 16), (64, 64)):
        try:
            want = jquant.choose_group_size(dims, preferred, min_gs)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                quant.choose_group_size(dims, preferred, min_gs)
            assert str(got.value) == str(e)
            continue
        assert quant.choose_group_size(dims, preferred, min_gs) == want
    assert quant.choose_group_size(dims) == jquant.choose_group_size(dims)


def test_choose_group_size_raises_as_reference():
    with pytest.raises(ValueError, match=r"no group size in \[32, 256\] divides all of"):
        quant.choose_group_size([1408, 48])
    with pytest.raises(ValueError) as want:
        jquant.choose_group_size([1408, 48])
    with pytest.raises(ValueError) as got:
        quant.choose_group_size([1408, 48])
    assert str(got.value) == str(want.value)
    assert quant.choose_group_size([1408, 2048]) == 128


# The port's statistics within STATS_RTOL of the float64 statistics of the
# same error tensor (PyTorch's cascade sums in f32; measured <= 1.0e-7),
# and within REF_RTOL of the reference's, whose f32 std of the relative
# error (heavy-tailed: |r| near 0 divides) is off the float64 value by up to
# 2.3e-6 on these inputs (its reduction order); the max and min are exact.
STATS_RTOL = 1e-6
REF_RTOL = 5e-6


def _exact_stats(r: torch.Tensor, gs: int, fmt: str) -> dict[str, float]:
    qt = quant.quantize(r, gs, fmt)
    r64 = r.to(torch.float32).double()
    err = (qt.dequantize().double() - r64).abs()
    rel = err / torch.where(r64.abs() > 0, r64.abs(), 1.0)
    return {"mean": err.mean().item(), "std": err.std(correction=0).item(),
            "rel_mean_pct": 100 * rel.mean().item(),
            "rel_std_pct": 100 * rel.std(correction=0).item()}


def _hold(got: dict, want: dict, exact: dict) -> None:
    assert list(got) == list(want)
    assert got["max"] == want["max"] and got["min"] == want["min"]
    for k, v in exact.items():
        assert got[k] == pytest.approx(v, rel=STATS_RTOL), (k, got[k], v)
        assert got[k] == pytest.approx(want[k], rel=REF_RTOL), (k, got[k], want[k])


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "fp8"])
@pytest.mark.parametrize("gs", [32, 128, 256])
def test_quantization_error_stats_equal_reference(fmt, gs):
    rng = np.random.default_rng(gs)
    for shape in ((64, 1024), (3, 8, 512)):
        r = (rng.standard_t(4, size=shape) * 0.05).astype(np.float32)
        r[0, :gs] = 0.0                                   # an all-zero group
        t = torch.as_tensor(r)
        _hold(quant.quantization_error_stats(t, gs, fmt),
              jquant.quantization_error_stats(jnp.asarray(r), gs, fmt), _exact_stats(t, gs, fmt))


def test_quantization_error_stats_bf16_input():
    r = np.random.default_rng(7).normal(size=(16, 512)).astype(np.float32)
    t = torch.as_tensor(r).to(torch.bfloat16)
    _hold(quant.quantization_error_stats(t, 256, "int8"),
          jquant.quantization_error_stats(jnp.asarray(r, dtype=jnp.bfloat16), 256, "int8"),
          _exact_stats(t, 256, "int8"))
