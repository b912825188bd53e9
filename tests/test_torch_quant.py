"""Port quantization, PTQ policy and parameter bridge against the reference.

Quantization must be bit-exact: the same int8 values and the same f32
scales, for f32 and bf16 inputs, all-zero groups and exact .5 ties.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import jax_to_numpy, numpy_to_jax  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import policy, quant  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.tree import tree_map_with_path  # noqa: E402


def _inputs(shape, gs, seed):
    """Normal values with planted all-zero groups and exact .5 ties (a group
    whose absmax 127.5 gives S == 1.0, so r / S lands on k + 0.5)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=3.0, size=shape).astype(np.float32)
    flat = x.reshape(-1, gs)
    flat[0] = 0.0
    if flat.shape[0] > 1:
        flat[1] = 0.0
        flat[1, 0] = 127.5
        flat[1, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5]
    return x


def _pair(x, dtype):
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        assert np.array_equal(np.asarray(jx.astype(jnp.float32)), tx.float().numpy())
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,gs", [((8, 64), 16), ((6, 128), 32), ((3, 512), 256),
                                      ((2, 3, 256), 32)])
def test_quantize_groupwise_bit_exact(dtype, shape, gs):
    jx, tx = _pair(_inputs(shape, gs, seed=gs + len(shape)), dtype)
    ref = jquant.quantize_groupwise(jx, gs)
    got = quant.quantize_groupwise(tx, gs)
    assert got.qvalues.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.qvalues.numpy(), np.asarray(ref.qvalues))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert got.shape == tuple(ref.shape) and got.group_size == gs and got.fmt == "int8"


def test_ties_round_half_to_even():
    x = _inputs((2, 32), 32, seed=0)
    q = quant.quantize_groupwise(torch.from_numpy(x), 32)
    assert q.scales[1].item() == 1.0
    assert q.qvalues[1, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]
    assert q.scales[0].item() == 0.0 and not q.qvalues[0].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_bit_exact(dtype):
    jx, tx = _pair(_inputs((2, 5, 128), 32, seed=3), dtype)
    ref = jquant.quantize_activation(jx, 32)
    got = quant.quantize_activation(tx, 32)
    np.testing.assert_array_equal(got.qvalues.numpy(), np.asarray(ref.qvalues))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_matches_reference(dtype):
    x = _inputs((4, 128), 32, seed=5)
    ref = jquant.quantize_groupwise(jnp.asarray(x), 32).dequantize(
        jnp.float32 if dtype is torch.float32 else jnp.bfloat16)
    got = quant.quantize_groupwise(torch.from_numpy(x), 32).dequantize(dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_indivisible_and_unported_formats_raise():
    with pytest.raises(ValueError, match="divisible"):
        quant.quantize_groupwise(torch.ones(4, 48), 32)
    with pytest.raises(ValueError, match="unknown quant format 'int2'"):
        quant.quantize(torch.ones(4, 64), 32, fmt="int2")


@pytest.mark.parametrize("path", [
    "embed", "classifier", "layers/attn/wqkv", "layers/attn/wo", "layers/mlp/w13",
    "layers/mlp/w2", "layers/att_norm", "final_norm", "layers/attn/scales",
    "layers/experts/w2", "layers/mamba/in_proj"])
def test_policy_helpers_match_reference(path):
    leaf = np.zeros((2, 96, 5632), np.float32)
    assert policy.leaf_class(path) == jpolicy.leaf_class(path)
    assert policy.should_quantize(path, torch.from_numpy(leaf), 16) == \
        jpolicy.should_quantize(path, jnp.asarray(leaf), 16)
    for preferred in (16, 64, 256):
        assert policy.leaf_group_size(path, leaf, preferred) == \
            jpolicy.leaf_group_size(path, leaf, preferred)


def _reduced_tinyllama():
    cfg = jload("tinyllama-1.1b").reduced()
    return cfg, jbuild(cfg).init(jax.random.PRNGKey(0))


def test_quantize_params_same_leaves_and_values():
    cfg, jparams = _reduced_tinyllama()
    ref = jax_to_numpy(jpolicy.quantize_params(jparams, cfg.group_size))
    got = policy.quantize_params(params_from_numpy(jax_to_numpy(jparams), "cpu"),
                                 cfg.group_size)

    def check(path, leaf):
        want = ref
        for k in path.split("/"):
            want = want[k]
        if isinstance(leaf, QuantizedTensor):
            assert isinstance(want, dict), f"{path}: port quantized, reference did not"
            assert leaf.group_size == want["group_size"], path
            np.testing.assert_array_equal(leaf.qvalues.numpy(), want["qvalues"])
            np.testing.assert_array_equal(leaf.scales.numpy(), want["scales"])
        else:
            assert not isinstance(want, dict), f"{path}: reference quantized, port did not"
            np.testing.assert_array_equal(leaf.numpy(), want)

    tree_map_with_path(check, got)
    qgot = policy.quantize_params(params_from_numpy(jax_to_numpy(jparams), "cpu"),
                                  cfg.group_size)
    assert policy.quantized_fraction(qgot) == pytest.approx(
        jpolicy.quantized_fraction(numpy_to_jax(ref)), rel=1e-12)


def test_quantize_params_stacked_layers_along_last_axis():
    cfg, jparams = _reduced_tinyllama()
    got = policy.quantize_params(params_from_numpy(jax_to_numpy(jparams), "cpu"),
                                 cfg.group_size)
    w13 = got["layers"]["mlp"]["w13"]
    assert w13.qvalues.shape == (cfg.num_layers, 2 * cfg.d_ff, cfg.d_model)
    assert w13.scales.shape == (cfg.num_layers, 2 * cfg.d_ff, cfg.d_model // cfg.group_size)
    one = w13[1]
    assert one.shape == (2 * cfg.d_ff, cfg.d_model) and one.qvalues.is_contiguous()


def test_quantize_params_unported_formats_raise():
    with pytest.raises(ValueError, match="unknown quant format 'int2'"):
        policy.quantize_params({"w": torch.ones(4, 64)}, 32, formats="int2")
    with pytest.raises(ValueError, match="unknown quant format 'int2'"):
        policy.quantize_params({"w": torch.ones(4, 64)}, 32, formats={"attn": "int2"})


def test_bridge_bf16_crosses_bit_exact():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32))
    xb = np.asarray(x.astype(jnp.bfloat16))
    t = params_from_numpy({"w": xb}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), xb.view(np.int16))


def test_bridge_quantized_and_plain_leaves():
    q = jquant.quantize_groupwise(jnp.asarray(_inputs((4, 64), 32, 1)), 32)
    tree = {"a": {"qvalues": np.asarray(q.qvalues), "scales": np.asarray(q.scales),
                  "group_size": 32, "fmt": "int8"},
            "n": np.ones((3,), np.float32), "i": np.arange(3)}
    out = params_from_numpy(tree, "cpu")
    assert isinstance(out["a"], QuantizedTensor) and out["a"].group_size == 32
    assert out["a"].qvalues.dtype == torch.int8 and out["a"].scales.dtype == torch.float32
    assert out["n"].dtype == torch.float32 and out["i"].dtype == torch.int64


def test_init_params_numpy_has_reference_layout():
    cfg = jload("tinyllama-1.1b").reduced()
    ref = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                 jbuild(cfg).init(jax.random.PRNGKey(0)))
    from repro_torch.models.registry import load_config

    mine = init_params_numpy(load_config("tinyllama-1.1b").reduced(), 0)
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), mine) == ref
    again = init_params_numpy(dataclasses.replace(
        load_config("tinyllama-1.1b").reduced()), 0)
    np.testing.assert_array_equal(again["classifier"], mine["classifier"])
