"""Port model code against the reference on reduced TinyLlama: the building
blocks, then prefill and decode logits and caches for float weights
(atol 1e-4) and int8 weights (atol 2e-3 * max|logit|: an f32 reordering can
flip one activation's int8 rounding, which moves a logit by one quantum)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.models import attention, common, transformer  # noqa: E402
from repro_torch.models.registry import load_config  # noqa: E402

CACHE_LEN = 24


def _setup(quantized: bool):
    cfg, jcfg = load_config("tinyllama-1.1b").reduced(), jload("tinyllama-1.1b").reduced()
    tree = init_params_numpy(cfg, seed=3)
    jparams = numpy_to_jax(tree)
    if quantized:
        jparams = jquantize_params(jparams, jcfg.group_size)
    # the port quantizes its own copy; test_torch_quant holds the two bit-exact
    params = params_from_numpy(tree, "cpu")
    if quantized:
        params = quantize_params(params, cfg.group_size)
    return cfg, jcfg, params, jparams


def _tol(quantized, ref):
    return 2e-3 * np.abs(ref).max() if quantized else 1e-4


def _tokens(cfg, b=3, s=10, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_and_cache(quantized, ragged):
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg)
    lengths = np.array([10, 4, 7]) if ragged else None
    jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN,
                            lengths=None if lengths is None else jnp.asarray(lengths))
    with torch.inference_mode():
        tl, tc = transformer.lm_prefill(
            params, torch.as_tensor(toks), cfg, CACHE_LEN,
            lengths=None if lengths is None else torch.as_tensor(lengths))
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-3, rtol=0)
    if ragged:    # pad rows of the cache are zero on both sides
        assert not tc["k"][:, 1, 4:].any() and not tc["v"][:, 2, 7:].any()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_decode_logits_and_cache(quantized, vector_pos):
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg, seed=1)
    lengths = np.array([10, 6, 8])
    jl = jnp.asarray(lengths) if vector_pos else None
    tlen = torch.as_tensor(lengths) if vector_pos else None
    _, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN, lengths=jl)
    with torch.inference_mode():
        _, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN,
                                       lengths=tlen)
    tok = np.array([5, 17, 300])
    jpos, tpos = (jl, tlen) if vector_pos else (10, 10)
    for step in range(3):
        jlog, jc = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, jpos, jcfg)
        with torch.inference_mode():
            tlog, tc = transformer.lm_decode(params, torch.as_tensor(tok), tc, tpos, cfg)
        ref = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
        tok = ref.argmax(-1)
        jpos, tpos = jpos + 1, tpos + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-3, rtol=0)


def test_rmsnorm_rope_and_masks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert common.rmsnorm(xb, torch.from_numpy(w)).dtype == torch.bfloat16
    pos = np.array([[0, 3, 7, 100, 4000]] * 2)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-4, atol=1e-4)
    for window in (None, 3):
        np.testing.assert_array_equal(common.causal_mask(6, window).numpy(),
                                      np.asarray(jcommon.causal_mask(6, window)))
        np.testing.assert_array_equal(common.decode_mask(8, 5, window).numpy(),
                                      np.asarray(jcommon.decode_mask(8, 5, window)))
    np.testing.assert_array_equal(common.decode_mask(8, 5).numpy(),
                                  np.asarray(jcommon.decode_mask(8, 5)))
    vp = np.array([2, 7])
    np.testing.assert_array_equal(common.decode_mask(8, torch.as_tensor(vp)).numpy(),
                                  np.asarray(jcommon.decode_mask(8, jnp.asarray(vp))))
    np.testing.assert_array_equal(common.length_mask(torch.as_tensor(vp), 8).numpy(),
                                  np.asarray(jcommon.length_mask(jnp.asarray(vp), 8)))


@pytest.mark.parametrize("window,use_window", [(None, None), (3, None), (3, True), (3, False)])
def test_flag_masks_match_reference(window, use_window):
    tu = None if use_window is None else torch.tensor(use_window)
    ju = None if use_window is None else jnp.asarray(use_window)
    np.testing.assert_array_equal(attention._flag_mask(6, window, tu, "cpu").numpy(),
                                  np.asarray(jattn._flag_mask(6, window, ju)))
    for tpos, jpos in ((5, 5), (torch.tensor([2, 7]), jnp.asarray([2, 7]))):
        np.testing.assert_array_equal(
            attention._flag_decode_mask(8, tpos, window, tu, "cpu").numpy(),
            np.asarray(jattn._flag_decode_mask(8, jpos, window, ju)))


def test_init_lm_layout_and_generator():
    cfg = load_config("tinyllama-1.1b").reduced()
    a = transformer.init_lm(cfg, "cpu", seed=1)
    b = transformer.init_lm(cfg, "cpu", seed=1)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), a)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jload("tinyllama-1.1b").reduced())
    ref = jax.tree_util.tree_map(lambda t: tuple(t.shape), jparams)
    assert shapes == ref
    assert torch.equal(a["layers"]["attn"]["wqkv"], b["layers"]["attn"]["wqkv"])
    assert a["embed"].dtype == cfg.pdtype()
    np.testing.assert_allclose(float(a["layers"]["mlp"]["w2"].std()), cfg.d_ff ** -0.5,
                               rtol=0.05)
