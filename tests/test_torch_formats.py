"""Sub-int8 and fp8 weights in the port against the reference: the int4,
int3 and fp8 formats, the mixed/mixed3 presets, the bridge, the plain
GQMV/GQMM versions, and the model end to end at the reduced config (GS 32).

Quantization and packing must be bit-exact (values, scales, zero groups,
.5 ties, fp8 values near +-448). The plain int4/int3 kernels' group sums
are exact integers, so they may differ from the reference's XLA oracle and
Pallas kernel only by the order of the f32 sum across groups (rtol 1e-6).
fp8 group dots are f32 sums in another order: rtol 5e-4, atol 1e-4, the
reference's own tolerance for its fp8 Pallas kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import jax_to_numpy, numpy_to_jax  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import qlinear as jqlinear  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import gqmv as jpallas  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.batching import serve_ragged as jserve_ragged  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import policy, qlinear, quant  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.tree import tree_map_with_path  # noqa: E402
from repro_torch.kernels import gqmv as kern  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.batching import Request, serve_ragged  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

FORMATS = ("int4", "int3", "fp8")
SETTINGS = ("int4", "int3", "fp8", "mixed", "mixed3")
QMAX = {"int4": 7, "int3": 3}
FP8_TOL = {"rtol": 5e-4, "atol": 1e-4}
# logits against the reference, as a fraction of max|logit|: f32 rounding,
# except under uniform int3, whose packed embedding table puts RMSNorm
# outputs on exact .5 ties of the int8 activation quantizer (see
# test_int3_embedding_puts_first_activations_on_ties); there the two
# packages' last-bit RMSNorm differences flip roundings
LOGIT_TOL = {"int3": 5e-2}


def _inputs(shape, gs, fmt, seed):
    """Normal values with planted all-zero groups, exact .5 ties of r / S,
    and (fp8) values whose r / S lands next to +-448 and on e4m3 ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=3.0, size=shape).astype(np.float32)
    flat = x.reshape(-1, gs)
    flat[0] = 0.0
    if fmt in QMAX:
        # absmax (2 qmax + 1) / 2 gives S == 1.0, so r / S == r
        q = QMAX[fmt]
        flat[1] = 0.0
        flat[1, :8] = [q + 0.5, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -(q - 0.5)]
    elif fmt == "fp8":
        # absmax 448 gives S == 1.0: values at, next to and between e4m3 steps
        flat[1] = 0.0
        flat[1, :10] = [448.0, -448.0, 447.9, 440.0, 424.0, -432.0, 1.0625, 0.0068359375,
                        -0.001953125, 17.0]
        flat[2] = flat[2] * 1e-3                         # a group of tiny magnitudes
    return x


def _pair(x, dtype):
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


def _bits(a) -> np.ndarray:
    """The stored bytes of a numpy/ml_dtypes or torch array, as uint8."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


# ---------------------------------------------------------------------------
# formats: registry, packing, quantization
# ---------------------------------------------------------------------------

def test_registry_matches_reference():
    assert quant.available_formats() == jquant.available_formats()
    for name in quant.available_formats():
        mine, theirs = quant.get_format(name), jquant.get_format(name)
        for field in ("bits", "pack", "pack_storage", "qmax", "kernel"):
            assert getattr(mine, field) == getattr(theirs, field), (name, field)
        assert str(mine.storage_dtype).split(".")[-1] == jnp.dtype(theirs.storage_dtype).name
        assert mine.kernel in ops.KERNEL_HOOKS
    with pytest.raises(ValueError, match="already registered"):
        quant.register_format(quant.get_format("int4"))


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64)])
def test_pack_unpack_int4_bit_exact(shape):
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, size=shape).astype(np.int8)
    packed = quant.pack_int4(torch.from_numpy(q))
    want = np.asarray(jquant.pack_int4(jnp.asarray(q)))
    assert packed.dtype == torch.int8 and packed.shape[-1] == shape[-1] // 2
    np.testing.assert_array_equal(packed.numpy(), want)
    # the low nibble holds the even element
    np.testing.assert_array_equal(packed.numpy()[..., 0].astype(np.int32) & 0xF,
                                  q[..., 0].astype(np.int32) & 0xF)
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), q)
    every = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    np.testing.assert_array_equal(quant.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jquant.unpack_int4(jnp.asarray(every))))


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64)])
def test_pack_unpack_int3_bit_exact(shape):
    rng = np.random.default_rng(1)
    q = rng.integers(-3, 4, size=shape).astype(np.int8)
    packed = quant.pack_int3(torch.from_numpy(q))
    want = np.asarray(jquant.pack_int3(jnp.asarray(q)))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == shape[-1] // 8 * 3
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(quant.unpack_int3(packed).numpy(), q)
    every = np.arange(256, dtype=np.uint8).reshape(4, 64)[:, :63]
    np.testing.assert_array_equal(quant.unpack_int3(torch.from_numpy(every)).numpy(),
                                  np.asarray(jquant.unpack_int3(jnp.asarray(every))))
    with pytest.raises(ValueError, match="divisible by 8"):
        quant.pack_int3(torch.zeros(2, 12, dtype=torch.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape,gs", [((8, 64), 16), ((6, 128), 32), ((3, 512), 256),
                                      ((2, 3, 256), 32)])
def test_quantize_bit_exact(fmt, dtype, shape, gs):
    jx, tx = _pair(_inputs(shape, gs, fmt, seed=gs + len(shape)), dtype)
    ref_q = jquant.quantize(jx, gs, fmt)
    got = quant.quantize(tx, gs, fmt)
    assert got.fmt == fmt and got.group_size == gs
    assert got.qvalues.dtype == quant.get_format(fmt).storage_dtype
    assert got.storage_shape == tuple(ref_q.storage_shape)
    assert got.shape == got.logical_shape == tuple(ref_q.shape) == shape
    np.testing.assert_array_equal(_bits(got.qvalues), _bits(ref_q.qvalues))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref_q.scales))
    assert got.nbytes() == ref_q.nbytes()
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(ref_q.dequantize()))


def test_int_formats_ties_and_zero_groups():
    for fmt, q in QMAX.items():
        got = quant.quantize(torch.from_numpy(_inputs((2, 32), 32, fmt, seed=0)), 32, fmt)
        vals = quant.get_format(fmt).unpack_values(got.qvalues)
        assert got.scales[1].item() == 1.0
        # round half to even, then clip to +-qmax
        assert vals[1, :8].tolist() == [q, 0, 2, 2, 0, -2, -2, -(q - 1) if q % 2 else -q]
        assert got.scales[0].item() == 0.0 and not vals[0].any()


def test_fp8_near_max_and_ties():
    x = _inputs((3, 32), 32, "fp8", seed=0)
    got = quant.quantize(torch.from_numpy(x), 32, "fp8")
    assert got.scales[1].item() == 1.0 and got.scales[0].item() == 0.0
    vals = got.qvalues[1, :10].float().tolist()
    # e4m3 steps of 32 above 256: 447.9 and 440 -> 448; 424 -> 416; -432 is
    # the 416/448 tie -> -448 (the even mantissa)
    assert vals[:6] == [448.0, -448.0, 448.0, 448.0, 416.0, -448.0]
    assert torch.isfinite(got.qvalues.float()).all()


def test_quantized_tensor_shapes_and_slicing():
    w = quant.quantize(torch.randn(3, 40, 64), 32, "int3")
    assert w.storage_shape == (3, 40, 24) and w.shape == (3, 40, 64)
    one = w[1]
    assert one.shape == (40, 64) and one.storage_shape == (40, 24) and one.fmt == "int3"
    assert w.format is quant.get_format("int3")


def test_unregistered_format_raises():
    with pytest.raises(ValueError, match="unknown quant format 'int2'"):
        quant.quantize(torch.ones(4, 64), 32, fmt="int2")
    with pytest.raises(ValueError, match="unknown quant format"):
        policy.resolve_format_map("int2")
    with pytest.raises(ValueError, match="unknown layer classes"):
        policy.resolve_format_map({"attention": "int4"})
    with pytest.raises(TypeError, match="format/policy name"):
        policy.resolve_format_map(4)


# ---------------------------------------------------------------------------
# policy and bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("formats", ["int8", "int4", "mixed", "mixed3",
                                     {"attn": "fp8", "ffn": None},
                                     {"embed": "int3", "classifier": "int4"}])
def test_resolve_format_map_matches_reference(formats):
    assert policy.resolve_format_map(formats) == jpolicy.resolve_format_map(formats)


def _reduced_tinyllama():
    cfg = jload("tinyllama-1.1b").reduced()
    return cfg, jbuild(cfg).init(jax.random.PRNGKey(0))


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("formats", SETTINGS)
def test_quantize_params_matches_reference(formats):
    cfg, jparams = _reduced_tinyllama()
    jq = jpolicy.quantize_params(jparams, cfg.group_size, formats=formats)
    want = jax_to_numpy(jq)
    got = policy.quantize_params(params_from_numpy(jax_to_numpy(jparams), "cpu"),
                                 cfg.group_size, formats=formats)

    def check(path, leaf):
        ref_leaf = _get(want, path)
        if isinstance(leaf, QuantizedTensor):
            assert isinstance(ref_leaf, dict), f"{path}: port quantized, reference did not"
            assert (leaf.fmt, leaf.group_size) == (ref_leaf["fmt"], ref_leaf["group_size"])
            np.testing.assert_array_equal(_bits(leaf.qvalues), _bits(ref_leaf["qvalues"]))
            np.testing.assert_array_equal(leaf.scales.numpy(), ref_leaf["scales"])
            assert leaf.nbytes() == _get(jq, path).nbytes()
        else:
            assert not isinstance(ref_leaf, dict), f"{path}: reference quantized, port did not"
            np.testing.assert_array_equal(leaf.numpy(), ref_leaf)

    tree_map_with_path(check, got)
    assert policy.quantized_fraction(got) == pytest.approx(
        jpolicy.quantized_fraction(jq), rel=1e-12)
    assert policy.format_breakdown(got) == jpolicy.format_breakdown(jq)


def test_quantize_params_packed_fallback_to_int8(monkeypatch):
    """A packed format whose pack factor does not divide a leaf's group size
    stores that leaf as int8, never float (the reference's rule; no
    registered format reaches it, so a wide-pack format is registered here)."""
    import dataclasses

    wide = dataclasses.replace(quant.get_format("int4"), name="wide", pack=32)
    monkeypatch.setitem(quant._FORMATS, "wide", wide)
    leaf = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 48)).astype(np.float32))
    got = policy.quantize_params({"attn": {"wo": leaf}}, 256, formats={"attn": "wide"})
    w = got["attn"]["wo"]
    assert (w.fmt, w.group_size) == ("int8", 16)      # 48 = 3 groups of 16; 16 % 32 != 0
    np.testing.assert_array_equal(w.qvalues.numpy(), quant.quantize_groupwise(leaf, 16).qvalues)


@pytest.mark.parametrize("fmt", FORMATS)
def test_bridge_carries_packed_and_fp8_leaves(fmt):
    jw = jquant.quantize(jnp.asarray(_inputs((6, 64), 32, fmt, seed=2)), 32, fmt)
    tree = {"w": {"qvalues": np.asarray(jw.qvalues), "scales": np.asarray(jw.scales),
                  "group_size": 32, "fmt": fmt}}
    got = params_from_numpy(tree, "cpu")["w"]
    assert got.fmt == fmt and got.qvalues.dtype == quant.get_format(fmt).storage_dtype
    np.testing.assert_array_equal(_bits(got.qvalues), _bits(jw.qvalues))
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(jw.dequantize()))
    back = numpy_to_jax({"w": tree["w"]})["w"]
    np.testing.assert_array_equal(_bits(back.qvalues), _bits(jw.qvalues))


def test_bridge_rejects_wrong_storage_and_unknown_format():
    tree = {"qvalues": np.zeros((2, 32), np.int8), "scales": np.zeros((2, 1), np.float32),
            "group_size": 32}
    with pytest.raises(TypeError, match="int3 qvalues must be stored as torch.uint8"):
        params_from_numpy({"w": dict(tree, fmt="int3")}, "cpu")
    with pytest.raises(ValueError, match="unknown quant format"):
        params_from_numpy({"w": dict(tree, fmt="int2")}, "cpu")


# ---------------------------------------------------------------------------
# plain kernels against the reference's oracles and Pallas kernels
# ---------------------------------------------------------------------------

def _mk(fmt, m, n, gs, b, seed):
    """Reference-quantized weights in ``fmt``, int8 activations, and their
    port copies."""
    rng = np.random.default_rng(seed)
    w = jquant.quantize(jnp.asarray(rng.normal(size=(m, n)).astype(np.float32)), gs, fmt)
    shape = (n,) if b is None else (b, n)
    x = jquant.quantize_activation(jnp.asarray(rng.normal(size=shape).astype(np.float32)), gs)
    j = (w.qvalues, w.scales, x.qvalues, x.scales)
    t = params_from_numpy({"q": jax_to_numpy(w)}, "cpu")["q"]
    return j, (t.qvalues, t.scales, torch.from_numpy(np.array(x.qvalues)),
               torch.from_numpy(np.array(x.scales)))


def _tol(fmt, oracle):
    if fmt == "fp8":
        return FP8_TOL
    return {"rtol": 1e-6, "atol": 1e-6 * np.abs(oracle).max()}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("gs", [16, 32, 256])
@pytest.mark.parametrize("b", [None, 1, 3, 8])
def test_plain_kernels_match_oracle_and_pallas(fmt, gs, b):
    m, n = 64, 512
    j, t = _mk(fmt, m, n, gs, b, seed=gs * 10 + (b or 0))
    name = "gqmv" if b is None else "gqmm"
    got = getattr(ref, f"{name}_{fmt}_ref")(*t, group_size=gs).numpy()
    oracle = np.asarray(getattr(jref, f"{name}_{fmt}_ref")(*j, group_size=gs))
    pallas = np.asarray(getattr(jpallas, f"{name}_{fmt}_pallas")(*j, group_size=gs,
                                                                  interpret=True))
    assert got.shape == oracle.shape == ((m,) if b is None else (b, m))
    np.testing.assert_allclose(got, oracle, **_tol(fmt, oracle))
    np.testing.assert_allclose(got, pallas, **_tol(fmt, oracle))


@pytest.mark.parametrize("fmt", ["int4", "int3"])
def test_plain_int_group_sums_are_exact(fmt):
    gs, m, n, b = 32, 16, 256, 3
    j, t = _mk(fmt, m, n, gs, b, seed=5)
    vals = quant.get_format(fmt).unpack_values(t[0])
    sums = ref._group_sums_mm(vals, t[2], gs).numpy()
    exact = np.einsum("mgk,bgk->bmg",
                      np.asarray(jquant.get_format(fmt).unpack_values(j[0]))
                      .astype(np.int64).reshape(m, n // gs, gs),
                      np.asarray(j[2]).astype(np.int64).reshape(b, n // gs, gs))
    np.testing.assert_array_equal(sums.astype(np.int64), exact)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_quantized_matmul_dispatch_matches_reference(fmt, lead):
    rng = np.random.default_rng(len(lead))
    wf = rng.normal(size=(96, 256)).astype(np.float32)
    xf = rng.normal(size=(*lead, 256)).astype(np.float32)
    jw = jquant.quantize(jnp.asarray(wf), 64, fmt)
    w = params_from_numpy({"w": jax_to_numpy(jw)}, "cpu")["w"]
    want = np.asarray(jops.quantized_matmul(jnp.asarray(xf), jw, impl="xla"))
    before = dict(kern.LAUNCHES)
    got = ops.quantized_matmul(torch.from_numpy(xf), w)
    assert kern.LAUNCHES == before            # the CPU runs the plain version
    assert tuple(got.shape) == (*lead, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(fmt, want))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ops.quantized_matmul(torch.from_numpy(xf), w, impl="cuda")
    assert kern.LAUNCHES == before


def test_kernel_hooks_cover_every_format_and_reject_unknown():
    assert set(ops.KERNEL_HOOKS) == {quant.get_format(f).kernel
                                     for f in quant.available_formats()}
    _, t = _mk("int4", 32, 64, 32, 2, seed=0)
    with pytest.raises(ValueError, match="unknown kernel hook"):
        ops.gqmm(*t, group_size=32, kernel="gqmv_int2")
    assert set(kern.LAUNCHES) == {f"{k}_{f}" for f in ("int8", "int4", "int3", "fp8")
                                  for k in ("gqmv", "gqmm")}


@pytest.mark.parametrize("fmt", FORMATS)
def test_wrappers_reject_cpu_tensors_and_bad_format(fmt):
    _, t = _mk(fmt, 32, 64, 32, 2, seed=3)
    before = dict(kern.LAUNCHES)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kern.gqmm_cuda(*t, group_size=32, fmt=fmt)
    _, t1 = _mk(fmt, 32, 64, 32, None, seed=3)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kern.gqmv_cuda(*t1, group_size=32, fmt=fmt)
    with pytest.raises(ValueError, match="unknown weight format"):
        kern.gqmm_cuda(*t, group_size=32, fmt="int2")
    assert kern.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt", FORMATS)
def test_embedding_lookup_on_packed_tables(fmt, dtype):
    rng = np.random.default_rng(6)
    table = rng.normal(size=(64, 128)).astype(np.float32)
    ids = np.array([[3, 0, 63], [7, 7, 1]])
    jdt = jnp.float32 if dtype is torch.float32 else jnp.bfloat16
    jw = jquant.quantize(jnp.asarray(table), 32, fmt)
    w = params_from_numpy({"w": jax_to_numpy(jw)}, "cpu")["w"]
    got = qlinear.embedding_lookup(w, torch.from_numpy(ids), dtype)
    want = jqlinear.embedding_lookup(jw, jnp.asarray(ids), jdt)
    assert got.shape == (2, 3, 128) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the model end to end at the reduced config
# ---------------------------------------------------------------------------

def _engines(formats, cache_len, **kw):
    cfg, jparams = _reduced_tinyllama()
    jeng = JEngine(jbuild(cfg), jparams, quantize=formats, cache_len=cache_len, **kw)
    tcfg = load_config("tinyllama-1.1b").reduced()
    teng = InferenceEngine(build(tcfg), params_from_numpy(jax_to_numpy(jparams), "cpu"),
                           quantize=formats, cache_len=cache_len, device="cpu", **kw)
    return cfg, jeng, teng


def _prompt(cfg, b=2, s=8, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s))


@pytest.mark.parametrize("formats", SETTINGS)
def test_prefill_and_decode_logits_match_reference(formats):
    cfg, jeng, teng = _engines(formats, 16)
    toks = _prompt(cfg)
    jl, jc = jeng.prefill({"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = teng.prefill({"tokens": torch.as_tensor(toks)})
    tol = LOGIT_TOL.get(formats, 1e-5)
    scale = np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=tol * scale)
    nxt = np.asarray(jl).argmax(-1)
    assert np.array_equal(tl.numpy().argmax(-1), nxt)
    jd, _ = jeng.decode_step(jnp.asarray(nxt, jnp.int32), jc, toks.shape[1])
    td, _ = teng.decode_step(torch.as_tensor(nxt), tc, toks.shape[1])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=tol * scale)


def test_int3_embedding_puts_first_activations_on_ties():
    """Uniform int3 stores the embedding table as q * S with q in [-3, 3], so
    after RMSNorm every element with |q| = 1 sits at x / S_x = 255 / 6 =
    42.5 exactly (up to rounding) in the first projection's int8 activation
    quantizer. The two packages' RMSNorm outputs agree to f32 rounding, and
    every int8 value they disagree on is one of those ties."""
    from repro.models.common import rmsnorm as jrmsnorm
    from repro_torch.models.common import rmsnorm

    cfg, jparams = _reduced_tinyllama()
    gs = cfg.group_size
    jq = jpolicy.quantize_params(jparams, gs, formats="int3")
    tq = policy.quantize_params(params_from_numpy(jax_to_numpy(jparams), "cpu"), gs,
                                formats="int3")
    toks = _prompt(cfg)
    jh = np.asarray(jrmsnorm(jqlinear.embedding_lookup(jq["embed"], jnp.asarray(toks)),
                             jq["layers"]["att_norm"][0], cfg.norm_eps))
    th = rmsnorm(qlinear.embedding_lookup(tq["embed"], torch.as_tensor(toks)),
                 tq["layers"]["att_norm"][0], cfg.norm_eps).numpy()
    assert np.abs(jh - th).max() <= 4 * np.finfo(np.float32).eps * np.abs(jh).max()
    jx = jquant.quantize_activation(jnp.asarray(jh), gs)
    tx = quant.quantize_activation(torch.from_numpy(th), gs)
    flips = np.asarray(jx.qvalues) != tx.qvalues.numpy()
    ratio = jh.reshape(*jh.shape[:-1], -1, gs) / np.asarray(jx.scales)[..., None]
    ratio = ratio.reshape(jh.shape)
    on_tie = np.abs(np.abs(ratio) - 42.5) < 1e-4
    assert flips.any() and on_tie[flips].all()
    assert on_tie.mean() > 0.1          # a systematic tie, not a chance one


@pytest.mark.parametrize("formats", SETTINGS)
def test_generate_tokens_match_reference(formats):
    cfg, jeng, teng = _engines(formats, 24)
    toks = _prompt(cfg, seed=4)
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 12).tokens)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, 12)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert teng.quantized_fraction == pytest.approx(jeng.quantized_fraction, rel=1e-12)


@pytest.mark.parametrize("formats", SETTINGS)
def test_paged_serve_ragged_tokens_match_reference(formats):
    cfg, jeng, teng = _engines(formats, 32)
    rng = np.random.default_rng(5)
    lens, budgets = [5, 12, 3, 9], [6, 3, 8, 5]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]
    kw = dict(mode="paged", slots=2, chunk=3, block_size=4)
    want = jserve_ragged(jeng, [JRequest(i, p, max_new=k) for i, (p, k)
                                in enumerate(zip(prompts, budgets))], 8, **kw)
    got = serve_ragged(teng, [Request(i, p, max_new=k) for i, (p, k)
                              in enumerate(zip(prompts, budgets))], 8, **kw)
    for r, s in zip(got, want):
        assert r.id == s.id and r.length == s.length
        np.testing.assert_array_equal(np.asarray(r.tokens), np.asarray(s.tokens))


@pytest.mark.parametrize("fmt", ["int4", "int3", "mixed3"])
def test_mlp_split_reads_the_logical_width(fmt):
    """Packed w2 reports its logical d_ff, so the fused w13 output splits in
    half of 2*d_ff, not of its packed byte width."""
    cfg, _, teng = _engines(fmt, 8)
    w2 = teng.params["layers"]["mlp"]["w2"]
    assert w2.shape[-1] == cfg.d_ff and w2.storage_shape[-1] < cfg.d_ff


@pytest.mark.parametrize("fmt", ["int4", "mixed3"])
def test_serve_cli_quantize_format(fmt, capsys):
    res = serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--steps", "3", "--quantize-format", fmt])
    out = capsys.readouterr().out
    assert res.tokens.shape == (2, 3)
    packed = "int4" if fmt == "int4" else "int3"
    assert f"{packed}: " in out and "float: " in out
    assert ("int8: " in out) == (fmt == "mixed3")


def test_serve_cli_rejects_unknown_format(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                    "--quantize-format", "int2"])
    assert "unknown quant format" in capsys.readouterr().err
