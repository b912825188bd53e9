"""The perf-variant flags (``repro_torch/core/flags.py``) against the
reference's on reduced TinyLlama, float and int8 weights made from one numpy
seed, each variant entered in both packages (``_torch_helpers.both_flags``).

Tolerances, as ``test_torch_model.py`` holds the default path: logits atol
1e-4 at f32 and 2e-3 * max|logit| with int8 weights (an f32 reordering can
flip one activation's int8 rounding, which moves a logit by one quantum);
caches atol 1e-3. The reduced config computes in f32, where the
reference's blockwise path and the port's flash attention (f32 inside)
differ only in summation order. ``Model.forward`` returns the logits of
every position, and with int8 weights a few positions of a 16-token batch
carry an int8 activation that the two packages' f32 orders round to either
side of a .5 tie (ROADMAP Queue C); the flip moves that position's logits,
and later ones through attention, by up to 1.2e-2 of max|logit| here, so
the int8 forward is held at ``TIE_TOL`` (chip_smoke.py's TIE_MARGIN, the
bound it states for one flip) and the f32 forward at 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.core import flags as jflags  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import flags  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.kernels import flash_attn as flash_kern  # noqa: E402
from repro_torch.kernels import gqmv as gqmm_kern  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.batching import Request, resolve_mode, serve_ragged  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CACHE_LEN = 24
TIE_TOL = 3e-2
SERVE_FLAGS = dict(blockwise_attention=True, deferred_decode_cache=True, kvt_cache_layout=True)


def _setup(quantized: bool):
    cfg, jcfg = load_config("tinyllama-1.1b").reduced(), jload("tinyllama-1.1b").reduced()
    tree = init_params_numpy(cfg, seed=3)
    jparams = numpy_to_jax(tree)
    params = params_from_numpy(tree, "cpu")
    if quantized:
        jparams = jquantize_params(jparams, jcfg.group_size)
        params = quantize_params(params, cfg.group_size)
    return cfg, jcfg, params, jparams


def _tol(quantized, ref):
    return 2e-3 * np.abs(ref).max() if quantized else 1e-4


def _tokens(cfg, b=3, s=10, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s))


def _close_cache(tc, jc):
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(jc[k], np.float32),
                                   atol=1e-3, rtol=0, err_msg=k)


def test_flags_match_reference_and_overrides_restore():
    assert flags.FLAGS == jflags.FLAGS
    assert flags.get("blockwise_attention") is False
    with flags.overrides(blockwise_attention=True, attention_chunk=8):
        assert flags.get("blockwise_attention") is True and flags.get("attention_chunk") == 8
        assert jflags.get("blockwise_attention") is False        # separate globals
    assert flags.FLAGS == jflags.FLAGS
    with pytest.raises(RuntimeError), flags.overrides(kvt_cache_layout=True):
        raise RuntimeError
    assert flags.get("kvt_cache_layout") is False
    with pytest.raises(KeyError), flags.overrides(no_such_flag=True):
        pass


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_blockwise_prefill_logits_and_cache(quantized, ragged):
    """Uniform and ragged prefill under blockwise_attention. The port's
    blockwise path masks causally only and ignores ``lengths`` (the flash
    kernel has no such argument): valid positions see only valid keys, pad
    K/V rows are zeroed before attention and caching, and the logits are
    taken at lengths - 1, so the logits and the whole cache equal the
    reference's. Only the hidden states at pad positions differ, and the
    caches hold none of them (their K/V rows are zero on both sides)."""
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg)
    lengths = np.array([10, 4, 7]) if ragged else None
    with both_flags(blockwise_attention=True, attention_chunk=4):
        jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN,
                                lengths=None if lengths is None else jnp.asarray(lengths))
        flash_kern.reset_launches()
        with torch.inference_mode():
            tl, tc = transformer.lm_prefill(
                params, torch.as_tensor(toks), cfg, CACHE_LEN,
                lengths=None if lengths is None else torch.as_tensor(lengths))
    assert flash_kern.LAUNCHES["flash_attn"] == 0          # the CPU runs the plain version
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
    _close_cache(tc, jc)
    if ragged:
        assert not tc["k"][:, 1, 4:].any() and not tc["v"][:, 2, 7:].any()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("blockwise", [False, True])
def test_model_forward_matches_reference(quantized, blockwise):
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg, b=2, s=16, seed=4)
    with both_flags(blockwise_attention=blockwise, attention_chunk=8):
        want = np.asarray(jbuild(jcfg).forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                                               remat=False))
        with torch.inference_mode():
            got = build(cfg).forward(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == want.shape == (2, 16, cfg.vocab_padded)
    tol = TIE_TOL * np.abs(want).max() if quantized else 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_blockwise_forward_equals_full_attention_forward():
    """The port's own two forward paths agree (as the reference's
    test_blockwise_attention_matches_baseline holds its own)."""
    cfg, _, params, _ = _setup(False)
    toks = torch.as_tensor(_tokens(cfg, b=2, s=32, seed=5))
    model = build(cfg)
    with torch.inference_mode():
        base = model.forward(params, {"tokens": toks}, remat=False)
        with flags.overrides(blockwise_attention=True, attention_chunk=8):
            opt = model.forward(params, {"tokens": toks}, remat=False)
    torch.testing.assert_close(opt, base, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["deferred_decode_cache", "kvt_cache_layout"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_flag_decode_steps_match_reference(variant, quantized, vector_pos):
    """One and three decode steps: logits at each step, and the cache (its
    layout and values) after the first and the third."""
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg, seed=1)
    lengths = np.array([10, 6, 8])
    jlen = jnp.asarray(lengths) if vector_pos else None
    tlen = torch.as_tensor(lengths) if vector_pos else None
    with both_flags(**{variant: True}):
        _, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN,
                               lengths=jlen)
        with torch.inference_mode():
            _, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN,
                                           lengths=tlen)
        kvt = variant == "kvt_cache_layout"
        want_shape = ((cfg.num_layers, 3, cfg.num_kv_heads, CACHE_LEN, cfg.resolved_head_dim)
                      if kvt else
                      (cfg.num_layers, 3, CACHE_LEN, cfg.num_kv_heads, cfg.resolved_head_dim))
        assert tuple(tc["k"].shape) == want_shape
        _close_cache(tc, jc)
        tok = np.array([5, 17, 300])
        jpos, tpos = (jlen, tlen) if vector_pos else (10, 10)
        for step in range(3):
            jlog, jc = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, jpos, jcfg)
            with torch.inference_mode():
                tlog, tc = transformer.lm_decode(params, torch.as_tensor(tok), tc, tpos, cfg)
            ref = np.asarray(jlog)
            np.testing.assert_allclose(tlog.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
            if step in (0, 2):
                _close_cache(tc, jc)
            tok = ref.argmax(-1)
            jpos, tpos = jpos + 1, tpos + 1


@pytest.mark.parametrize("variant", [dict(deferred_decode_cache=True),
                                     dict(kvt_cache_layout=True),
                                     dict(deferred_decode_cache=True, kvt_cache_layout=True)])
def test_deferred_decode_multi_step_equals_baseline(variant):
    """Three consecutive deferred steps == three baseline steps in the port:
    no layer reads its own uncommitted row (the reference's
    test_deferred_decode_multi_step)."""
    cfg, _, params, _ = _setup(False)
    toks = torch.as_tensor(_tokens(cfg, b=2, s=6, seed=2))
    with torch.inference_mode():
        _, base = transformer.lm_prefill(params, toks, cfg, 12)
        with flags.overrides(**variant):
            _, opt = transformer.lm_prefill(params, toks, cfg, 12)
        tok = torch.tensor([3, 9])
        for step in range(3):
            la, base = transformer.lm_decode(params, tok, base, 6 + step, cfg)
            with flags.overrides(**variant):
                lb, opt = transformer.lm_decode(params, tok, opt, 6 + step, cfg)
            torch.testing.assert_close(lb, la, atol=1e-4, rtol=0)
            tok = la.argmax(-1)
    k = opt["k"].movedim(3, 2) if variant.get("kvt_cache_layout") else opt["k"]
    torch.testing.assert_close(k, base["k"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_prefill_dequant_matches_reference(stage):
    """prefill_dequant dequantizes every int8 weight and runs a float
    product (no GQMM) while it is set, in prefill and in decode alike."""
    cfg, jcfg, params, jparams = _setup(True)
    toks = _tokens(cfg, seed=6)
    pre = both_flags(prefill_dequant=True) if stage == "prefill" else both_flags()
    with pre:
        jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN)
        gqmm_kern.reset_launches()
        with torch.inference_mode(), ops.impl_scope("plain"):
            tl, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN)
    ref = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), ref, atol=_tol(True, ref), rtol=0)
    tok = ref.argmax(-1)
    dec = both_flags(prefill_dequant=True) if stage == "decode" else both_flags()
    with dec:
        jlog, _ = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, 10, jcfg)
        with torch.inference_mode():
            tlog, _ = transformer.lm_decode(params, torch.as_tensor(tok), tc, 10, cfg)
    ref = np.asarray(jlog)
    np.testing.assert_allclose(tlog.numpy(), ref, atol=_tol(True, ref), rtol=0)


def test_prefill_dequant_runs_no_quantized_matmul(monkeypatch):
    cfg, _, params, _ = _setup(True)
    calls = []
    monkeypatch.setattr(ops, "quantized_matmul", lambda *a, **k: calls.append(1))
    with flags.overrides(prefill_dequant=True), torch.inference_mode():
        logits, cache = transformer.lm_prefill(params, torch.as_tensor(_tokens(cfg)), cfg,
                                               CACHE_LEN)
        transformer.lm_decode(params, logits.argmax(-1), cache, 10, cfg)
    assert calls == []


@pytest.mark.parametrize("quantized", [False, True])
def test_int8_kv_cache_flag_matches_reference_and_kv_quant(quantized):
    """The int8_kv_cache flag == cfg.kv_quant="int8" in the port, and both
    equal the reference under the flag (quantized rows bit-exact up to an
    f32 tie, logits at the stated tolerance)."""
    cfg, jcfg, params, jparams = _setup(quantized)
    toks = _tokens(cfg, seed=7)
    tok = np.array([5, 17, 300])
    with both_flags(int8_kv_cache=True):
        jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN)
        jlog, jc = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, 10, jcfg)
        with torch.inference_mode():
            tl, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN)
            tlog, tc = transformer.lm_decode(params, torch.as_tensor(tok), tc, 10, cfg)
    assert tc["k_q"].dtype == torch.int8 and set(tc) == {"k_q", "k_s", "v_q", "v_s"}
    for ref, got in ((jl, tl), (jlog, tlog)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
    _close_cache(tc, jc)
    cfg8 = cfg.__class__(**{**cfg.__dict__, "kv_quant": "int8"})
    with torch.inference_mode():
        _, tc8 = transformer.lm_prefill(params, torch.as_tensor(toks), cfg8, CACHE_LEN)
        tlog8, tc8 = transformer.lm_decode(params, torch.as_tensor(tok), tc8, 10, cfg8)
    torch.testing.assert_close(tlog8, tlog, atol=0, rtol=0)
    for k in tc:
        assert torch.equal(tc8[k], tc[k]), k


@pytest.mark.parametrize("quantized", [False, True])
def test_generate_tokens_identical_with_serving_flags(quantized):
    """Greedy tokens with blockwise prefill, deferred decode and the kvt
    layout all on: identical to the reference's, uniform and ragged."""
    cfg, jcfg, params, jparams = _setup(False)
    toks = _tokens(cfg, b=2, s=8, seed=8)
    lengths = np.array([8, 5])
    with both_flags(**SERVE_FLAGS):
        jeng = JEngine(jbuild(jcfg), jparams, cache_len=CACHE_LEN, quantize=quantized)
        teng = InferenceEngine(build(cfg), params, cache_len=CACHE_LEN, quantize=quantized,
                               device="cpu")
        for lens in (None, lengths):
            want = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 8,
                                 lengths=None if lens is None else jnp.asarray(lens))
            got = teng.generate({"tokens": torch.as_tensor(toks)}, 8,
                                lengths=None if lens is None else torch.as_tensor(lens))
            np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_serve_ragged_auto_is_contiguous_and_paged_refuses_under_kvt():
    cfg, _, params, _ = _setup(False)
    engine = InferenceEngine(build(cfg), params, cache_len=32, device="cpu")
    reqs = [Request(i, list(range(1, 4 + 3 * i)), max_new=3 + i) for i in range(4)]
    assert resolve_mode(engine, "auto") == "paged"
    plain = serve_ragged(engine, reqs, 8, mode="continuous", slots=2, chunk=2)
    for flag in ("kvt_cache_layout", "int8_kv_cache"):
        with flags.overrides(**{flag: True}):
            assert resolve_mode(engine, "auto") == "continuous"
            with pytest.raises(ValueError, match="base float KV layout"):
                serve_ragged(engine, reqs, 8, mode="paged", slots=2, chunk=2)
            with pytest.raises(ValueError, match="base float KV layout"):
                transformer.lm_decode_paged(params, torch.ones(2, dtype=torch.long), {},
                                            torch.zeros((2, 4), dtype=torch.int32), 3, cfg)
    with flags.overrides(kvt_cache_layout=True):
        out = serve_ragged(engine, reqs, 8, mode="auto", slots=2, chunk=2)
    for a, b in zip(out, plain):
        assert a.length == b.length and (np.asarray(a.tokens) == np.asarray(b.tokens)).all()


@pytest.mark.parametrize("vector_pos", [False, True])
def test_commit_helpers_match_reference(vector_pos):
    rng = np.random.default_rng(9)
    pos_np = np.array([3, 0, 5]) if vector_pos else 4
    jpos = jnp.asarray(pos_np) if vector_pos else pos_np
    tpos = torch.as_tensor(pos_np) if vector_pos else pos_np
    cases = [(jattn.commit_layers_bt, attention.commit_layers_bt, (2, 3, 6, 2, 4), (2, 3, 1, 2, 4)),
             (jattn.commit_layers_bkt, attention.commit_layers_bkt, (2, 3, 2, 6, 4),
              (2, 3, 2, 1, 4)),
             (jattn._commit_bkt, attention._commit_bkt, (3, 2, 6, 4), (3, 2, 1, 4))]
    for jfn, tfn, cshape, rshape in cases:
        cache = rng.normal(size=cshape).astype(np.float32)
        rows = rng.normal(size=rshape).astype(np.float32)
        want = np.asarray(jfn(jnp.asarray(cache), jnp.asarray(rows), jpos))
        tcache = torch.from_numpy(cache.copy())
        got = tfn(tcache, torch.from_numpy(rows), tpos)
        assert got is tcache                                    # in place
        np.testing.assert_array_equal(got.numpy(), want)
