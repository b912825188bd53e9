"""The port's MoE FFN (``models/mlp.py``) and the MoE/MLA parameter trees
against the reference on the reduced dbrx-132b (4 experts top-2) and
deepseek-v2-lite-16b (4 experts top-2, 1 shared) configs, with weights from
``bridge.init_params_numpy``:

- ``moe_forward`` at f32 (atol 1e-4) and int8 weights (2e-3 * max|y|), its
  router's top-k expert sets equal to the reference's, or else the first
  decision that differs a traced tie (``tests/_torch_families.hold``: a
  router near tie within ROUTER_TIE, or an int8 .5 tie);
- the expert loop's quantization: the shared input once for every
  expert's w13, each SwiGLU output once for its w2; the router's column
  mode (a verify chunk's) equal to the decode steps' rows bit for bit;
- the weight policy on the three full configs (shapes only, on JAX's
  abstract arrays and PyTorch's meta tensors): every leaf's format and
  group size equal to the reference's in every weight setting, the router
  and the MLA norms float;
- ``init_params_numpy`` and ``init_lm`` against the reference's
  ``init_lm`` tree (keys, shapes, dtypes).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_families import Held, hold, tree_of  # noqa: E402
from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.core.quant import QuantizedTensor as JQT  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import qlinear  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import mlp, registry, transformer  # noqa: E402
from repro_torch.core.tree import tree_index  # noqa: E402

MOE_ARCHS = ("dbrx-132b", "deepseek-v2-lite-16b")
NEW_ARCHS = ("dbrx-132b", "deepseek-v2-lite-16b", "minicpm3-4b")
SETTINGS = ("int8", "int4", "int3", "fp8", "mixed", "mixed3")


def _layer_mlp(arch: str, quantized: bool, layer: int = 1):
    """Both packages' MoE parameters of one layer (the reduced config's
    numpy draw with random norm weights), quantized with int8 or not."""
    cfg, jcfg = registry.load_config(arch).reduced(), jreg.load_config(arch).reduced()
    tree = tree_of(arch)
    jp, tp = numpy_to_jax(tree), bridge.params_from_numpy(tree, "cpu")
    if quantized:
        jp, tp = jquantize_params(jp, jcfg.group_size), quantize_params(tp, cfg.group_size)
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["mlp"])
    return cfg, jcfg, tree_index(tp["layers"]["mlp"], layer), jl


def _x(cfg, b=3, s=20, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, quantized):
    """(3, 20) rows of unit-normal activations through one layer's MoE: the
    output within the stated tolerance, under the router tie rule."""
    cfg, jcfg, tp, jp = _layer_mlp(arch, quantized)
    x = _x(cfg)

    def run(held):
        want = jmlp.moe_forward(jp, jnp.asarray(x), jcfg)
        with torch.inference_mode():
            got = mlp.moe_forward(tp, torch.as_tensor(x), cfg)
        held.logits(got, want, "moe")

    hold(run, quantized, top_k=cfg.moe.top_k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_top_k_sets_and_combine_match_reference(arch):
    """The router's top-k expert sets equal the reference's on every row
    (a miss only at a traced near tie), and the combine weights, softmax
    renormalised over k in descending order, agree within f32 rounding."""
    cfg, jcfg, tp, jp = _layer_mlp(arch, False)
    x = _x(cfg, seed=1)
    k = cfg.moe.top_k
    jprobs = jax.nn.softmax(jnp.einsum("bsd,ed->bse", jnp.asarray(x), jp["router_w"]), -1)
    jtop, jidx = jax.lax.top_k(jprobs, k)
    with torch.inference_mode():
        probs = torch.softmax(mlp._router_logits(torch.as_tensor(x), tp["router_w"]), -1)
    tidx = torch.topk(probs, k).indices.numpy()
    jidx, jtop = np.asarray(jidx), np.asarray(jtop)
    srt = -np.sort(-np.asarray(jprobs), axis=-1)
    for r in zip(*np.nonzero((np.sort(jidx, -1) != np.sort(tidx, -1)).any(-1))):
        gap = (srt[r][k - 1] - srt[r][k]) / srt[r][k - 1]
        assert gap <= 1e-6, (r, gap)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-5, atol=1e-7)
    want = jtop / jtop.sum(-1, keepdims=True)
    np.testing.assert_allclose(torch.topk(probs, k).values.numpy()
                               / torch.topk(probs, k).values.sum(-1, keepdim=True).numpy(),
                               want, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_quantizes_each_input_once(arch, monkeypatch):
    """int8 weights: one activation quantization for every expert's w13
    (the shared input), one for each expert's w2, two for the shared
    expert; two GQMMs an expert and two for the shared expert."""
    cfg, _, tp, _ = _layer_mlp(arch, True)
    quants, gqmms = [], []
    qa, gq = ops.quantize_activation, ops.gqmm
    monkeypatch.setattr(ops, "quantize_activation",
                        lambda x, group_size: quants.append(tuple(x.shape)) or qa(x, group_size))
    monkeypatch.setattr(ops, "gqmm", lambda *a, **kw: gqmms.append(1) or gq(*a, **kw))
    with torch.inference_mode():
        mlp.moe_forward(tp, torch.as_tensor(_x(cfg, b=2, s=3)), cfg)
    e, shared = cfg.moe.num_experts, 2 * bool(cfg.moe.num_shared)
    assert len(gqmms) == 2 * e + shared
    assert len(quants) == 1 + e + shared
    assert quants[0] == (2, 3, cfg.d_model)
    assert quants[1:1 + e] == [(2, 3, cfg.moe.d_expert)] * e
    assert qlinear.quantize_input(tp["experts"]["w13"], torch.zeros(cfg.d_model)) is not None
    assert qlinear.quantize_input(torch.zeros(2, 2), torch.zeros(2)) is None


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_by_column_rows_equal_decode_rows(arch):
    """A verify chunk's MoE (router logits per column) gives each column
    the output of the (b, 1, d) decode step's MoE, bit for bit."""
    cfg, _, tp, _ = _layer_mlp(arch, True)
    x = torch.as_tensor(_x(cfg, b=2, s=4, seed=2))
    with torch.inference_mode():
        chunk = mlp.moe_forward(tp, x, cfg, by_column=True)
        for j in range(4):
            assert torch.equal(chunk[:, j:j + 1], mlp.moe_forward(tp, x[:, j:j + 1], cfg))


# ---------------------------------------------------------------------------
# parameter trees and the weight policy
# ---------------------------------------------------------------------------

def _abstract_ref(arch: str):
    """The reference's ``init_lm`` tree of the full-width config as abstract
    arrays, at 2 layers (the depth decides no format or group size)."""
    cfg = dataclasses.replace(jreg.load_config(arch), num_layers=2)
    return jax.eval_shape(lambda k: jtf.init_lm(k, cfg), jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_policy_formats_and_group_sizes_match_reference_full_size(arch):
    """Every leaf of the full config's tree gets the reference's format and
    group size (or stays float) in every weight setting: the experts the
    ffn class, the router and the MLA norms float, GS by the leaf's own n
    (deepseek's expert w2: n 1408, 11 groups of 128; minicpm3's wukv: n 256,
    one group). Shapes only, at 2 layers: the reference on abstract arrays,
    the port on meta tensors."""
    cfg = registry.load_config(arch)
    ref = _abstract_ref(arch)
    meta = jax.tree.map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"), ref)
    for setting in SETTINGS:
        jq = _flat(jax.eval_shape(lambda p: jquantize_params(p, cfg.group_size, formats=setting),
                                  ref))
        tq = _flat(quantize_params(meta, cfg.group_size, formats=setting))
        assert set(jq) == set(tq), setting
        for path, leaf in tq.items():
            want = jq[path]
            if isinstance(want, JQT):
                assert isinstance(leaf, QuantizedTensor), (setting, path)
                assert (leaf.fmt, leaf.group_size) == (want.fmt, want.group_size), (setting, path)
                assert tuple(leaf.qvalues.shape) == tuple(want.qvalues.shape), (setting, path)
                assert tuple(leaf.scales.shape) == tuple(want.scales.shape), (setting, path)
            else:
                assert not isinstance(leaf, QuantizedTensor), (setting, path)
        assert any(isinstance(v, JQT) for v in jq.values())
    q8 = quantize_params(meta, cfg.group_size)["layers"]
    for name in ("router_w",):
        if cfg.moe:
            assert not isinstance(q8["mlp"][name], QuantizedTensor)
    for name in ("kv_norm", "q_norm"):
        if cfg.mla and name in q8["attn"]:
            assert not isinstance(q8["attn"][name], QuantizedTensor)
    if arch == "deepseek-v2-lite-16b":
        assert q8["mlp"]["experts"]["w2"].group_size == 128
        assert q8["mlp"]["experts"]["w2"].scales.shape[-1] == 11
    if arch == "minicpm3-4b":
        assert q8["attn"]["wukv"].scales.shape[-1] == 1


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_trees_match_reference_layout(arch):
    """``init_params_numpy`` and the port's ``init_lm`` draw the reference's
    ``init_lm`` tree on the reduced config: the same keys, shapes and
    dtypes (the router f32 whatever the parameter dtype)."""
    cfg = registry.load_config(arch).reduced()
    ref = jax.eval_shape(lambda k: jtf.init_lm(k, jreg.load_config(arch).reduced()),
                         jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in _flat(ref).items()}
    tree = bridge.init_params_numpy(cfg, seed=1)
    assert {k: (v.shape, v.dtype.name) for k, v in _flat(tree).items()} == want
    params = transformer.init_lm(cfg, "cpu", seed=1)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat(params).items()} == want
    bf16 = transformer.init_lm(dataclasses.replace(cfg, param_dtype="bfloat16"), "cpu")
    if cfg.moe:
        assert bf16["layers"]["mlp"]["router_w"].dtype == torch.float32
        assert bf16["layers"]["mlp"]["experts"]["w13"].dtype == torch.bfloat16


def test_held_records_router_choices():
    """The tie rule's recorder sees the router of both packages: one record
    a MoE layer, in the same order as the int8 roundings."""
    from _torch_families import first_flips, recorded

    cfg, jcfg, tp, jp = _layer_mlp("deepseek-v2-lite-16b", True)
    x = _x(cfg, b=2, s=5)
    with recorded() as (ref, port):
        jax.block_until_ready(jmlp.moe_forward(jp, jnp.asarray(x), jcfg))
        with torch.inference_mode():
            mlp.moe_forward(tp, torch.as_tensor(x), cfg)
    assert [r[0] for r in ref] == [r[0] for r in port]
    assert [r[0] for r in port].count("router") == 1 and port[0][0] == "router"
    kind, flips = first_flips(ref, port, cfg.moe.top_k)
    assert kind in ("", "int8") and Held(True).misses == []
