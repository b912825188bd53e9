"""The port's paged and quantized KV caches against the reference on reduced
TinyLlama: ``_quantize_rows`` bit-exact for int8 and fp8, the ``BlockPool``
invariants, the quantized contiguous prefill/decode, ``contiguous_to_paged``
and ``lm_decode_paged`` logits (float, int8 and fp8 pools; f32 and int8
weights), and ``InferenceEngine.generate(paged=True)`` tokens.

Tolerances are the model tests': logits within 1e-4 for float weights and
2e-3 * max|logit| for int8 weights (an f32 reordering can flip one
activation's int8 rounding); quantized rows and scales bit-exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro.serving.paged import BlockPool as JBlockPool  # noqa: E402
from repro_torch.bridge import init_params_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.paged import BlockPool  # noqa: E402

BLOCK = 8


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn else t.numpy()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_rows_bit_exact(fmt):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 4, 7, 64)) * rng.uniform(0.01, 30, size=(3, 4, 7, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                                  # zero row: scale 0, values 0
    x[0, 0, 1, :5] = [1.0, -1.0, 0.5, 2.5, -2.5]      # ties and the absmax itself
    for dt in (np.float32, "bfloat16"):
        xt = torch.from_numpy(x) if dt is np.float32 else torch.from_numpy(x).bfloat16()
        xj = jnp.asarray(x) if dt is np.float32 else jnp.asarray(x).astype(jnp.bfloat16)
        tq, ts = attention._quantize_rows(xt, fmt)
        jq, js = jattn._quantize_rows(xj, fmt)
        assert tq.dtype == attention.KV_STORE_DTYPES[fmt] and ts.dtype == torch.float32
        np.testing.assert_array_equal(_bytes(tq), np.asarray(jq).view(np.uint8)
                                      if fmt == "fp8" else np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq[0, 0, 0].float().any() and ts[0, 0, 0] == 0


def test_block_pool_invariants_match_reference():
    for pool in (BlockPool(8, 4), JBlockPool(8, 4)):
        assert pool.free_blocks == 7                  # block 0 is the sink
        a = pool.alloc(3)
        assert a == [1, 2, 3] and pool.live_blocks == 3 and pool.peak_live == 3
        pool.free(a[:2])
        assert pool.free_blocks == 6 and pool.peak_live == 3
        assert pool.alloc(2) == [2, 1]                # LIFO reuse
        b = pool.alloc(4)
        assert pool.peak_live == 7 and 0 not in b
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(1)
        for bad in ([0], [8], [a[2], a[2]]):          # sink, out of range, double free
            with pytest.raises(ValueError, match="bad free"):
                pool.free(bad)
    with pytest.raises(ValueError, match=">= 2 blocks"):
        BlockPool(1, 4)


def _setup(quantized: bool, kv_quant):
    cfg = load_config("tinyllama-1.1b").reduced()
    jcfg = jload("tinyllama-1.1b").reduced()
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
        jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tree = init_params_numpy(cfg, seed=5)
    jparams = numpy_to_jax(tree)
    params = params_from_numpy(tree, "cpu")
    if quantized:
        jparams = jquantize_params(jparams, jcfg.group_size)
        params = quantize_params(params, cfg.group_size)
    return cfg, jcfg, params, jparams


def _tol(quantized, ref):
    return 2e-3 * np.abs(ref).max() if quantized else 1e-4


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
def test_decode_paged_logits_and_pool_match_reference(quantized, kv_quant):
    """Ragged prefill, the contiguous cache reshaped into a pool, then paged
    decode steps: logits and the committed pool rows match the reference."""
    cfg, jcfg, params, jparams = _setup(quantized, kv_quant)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 9))
    lens = np.array([9, 4, 6])
    jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, 16,
                            lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, 16,
                                        lengths=torch.as_tensor(lens))
    jpool, jtable = jtf.contiguous_to_paged(jc, BLOCK)
    tpool, ttable = transformer.contiguous_to_paged(tc, BLOCK)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(jtable))
    assert set(tpool) == set(jpool)
    # a non-identity table: the rows' blocks permuted inside the pool
    perm = np.array([4, 0, 5, 2, 1, 3])
    tpool = {k: v[:, np.argsort(perm)] for k, v in tpool.items()}
    jpool = {k: v[:, np.argsort(perm)] for k, v in jpool.items()}
    table = perm[np.asarray(jtable)]
    tok, pos = np.asarray(jl).argmax(-1), lens.copy()
    for _ in range(3):
        jlog, jpool = jtf.lm_decode_paged(jparams, jnp.asarray(tok, jnp.int32), jpool,
                                          jnp.asarray(table, jnp.int32),
                                          jnp.asarray(pos, jnp.int32), jcfg)
        with torch.inference_mode():
            tlog, tpool = transformer.lm_decode_paged(
                params, torch.as_tensor(tok), tpool, torch.as_tensor(table),
                torch.as_tensor(pos), cfg)
        ref = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), ref, atol=_tol(quantized, ref), rtol=0)
        tok, pos = ref.argmax(-1), pos + 1
    for k in tpool:
        if tpool[k].dtype == torch.float8_e4m3fn or tpool[k].dtype == torch.int8:
            # one quantum apart at most where an f32 reordering moved a value
            diff = np.abs(tpool[k].float().numpy() - np.asarray(jpool[k]).astype(np.float32))
            assert (diff <= np.abs(np.asarray(jpool[k]).astype(np.float32)) / 8 + 1).all()
        else:
            np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]), atol=1e-3,
                                       rtol=1e-3)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_contiguous_cache_matches_reference(kv_quant):
    """kvt-major quantized prefill cache and deferred quantized decode."""
    cfg, jcfg, params, jparams = _setup(True, kv_quant)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 7))
    lens = np.array([7, 3])
    jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, 12,
                            lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, 12,
                                        lengths=torch.as_tensor(lens))
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    np.testing.assert_array_equal(tc["k_s"][:, 1, :, 3:].numpy(), 0)    # pad rows
    tok, pos = np.asarray(jl).argmax(-1), lens.copy()
    for vector in (True, False):
        jp = jnp.asarray(pos) if vector else int(pos[0])
        tp = torch.as_tensor(pos) if vector else int(pos[0])
        jlog, jc = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, jp, jcfg)
        with torch.inference_mode():
            tlog, tc = transformer.lm_decode(params, torch.as_tensor(tok), tc, tp, cfg)
        ref = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), ref, atol=_tol(True, ref), rtol=0)
        tok, pos = ref.argmax(-1), pos + 1
    np.testing.assert_allclose(tc["k_s"].numpy(), np.asarray(jc["k_s"]), rtol=1e-3, atol=1e-6)


def test_insert_gather_slots_roundtrip():
    cfg = load_config("tinyllama-1.1b").reduced()
    for kvq in (None, "fp8"):
        c = dataclasses.replace(cfg, kv_quant=kvq)
        cache = transformer.lm_init_cache(c, 4, 8, torch.float32, "cpu")
        rows = {k: torch.ones_like(v[:, :2]) if v.dtype != torch.float8_e4m3fn
                else torch.ones(v[:, :2].shape).to(v.dtype) for k, v in cache.items()}
        slots = torch.tensor([3, 1])
        transformer.lm_insert_slots(cache, rows, slots)
        back = transformer.lm_gather_slots(cache, slots)
        for k in cache:
            assert torch.equal(back[k].float(), rows[k].float())
            assert not cache[k][:, [0, 2]].float().any()


def test_commit_layers_paged_clamps_and_writes_in_place():
    pages = torch.zeros((2, 5, 4, 1, 2))
    rows = torch.arange(8.0).reshape(2, 2, 1, 2)
    table = torch.tensor([[3, 1], [2, 0]])
    pos = torch.tensor([5, 13])                     # 13 // 4 = 3: clamped to block index 1
    out = attention.commit_layers_paged(pages, rows, table, pos)
    assert out is pages
    assert torch.equal(pages[:, 1, 1], rows[:, 0]) and torch.equal(pages[:, 0, 1], rows[:, 1])
    assert pages.count_nonzero() == rows.count_nonzero()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_generate_paged_identical_to_reference(kv_quant):
    cfg = load_config("tinyllama-1.1b").reduced()
    tree = init_params_numpy(cfg, seed=8)
    jeng = JEngine(jbuild(jload("tinyllama-1.1b").reduced()), numpy_to_jax(tree),
                   cache_len=20, quantize=True, kv_quant=kv_quant)
    teng = InferenceEngine(build(cfg), params_from_numpy(tree, "cpu"), cache_len=20,
                           quantize=True, kv_quant=kv_quant, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(3, 7))
    for lengths in (None, np.array([3, 7, 5])):
        kw = {} if lengths is None else {"lengths": lengths}
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 6,
                                        paged=True, **kw).tokens)
        got = teng.generate({"tokens": torch.as_tensor(toks)}, 6, paged=True, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), want)
        flat = teng.generate({"tokens": torch.as_tensor(toks)}, 6, **kw)
        np.testing.assert_array_equal(flat.tokens.numpy(), want)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_decode_paged_hands_the_kernel_contiguous_rows(monkeypatch, kv_quant):
    """The CUDA wrapper takes contiguous tensors only, and q, k_new and v_new
    start as views of the fused QKV projection: under impl="cuda" every
    tensor that reaches the kernel's wrapper is contiguous, with the
    wrapper's dtypes (a stand-in wrapper runs the plain version here)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attn as paged_kern

    calls = []

    def stand_in(*args, **kw):
        tensors = list(args) + [kw["k_scales"], kw["v_scales"]]
        calls.append(all(t is None or t.is_contiguous() for t in tensors))
        assert args[0].dtype == args[5].dtype == args[6].dtype and args[7].dtype == torch.float32
        return ref.paged_attention_ref(*args, **kw)

    monkeypatch.setattr(paged_kern, "paged_attention_cuda", stand_in)
    cfg, _, params, _ = _setup(False, kv_quant)       # float weights: no GQMM call
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 5)))
    with torch.inference_mode():
        logits, cache = transformer.lm_prefill(params, toks, cfg, 16)
        pool, table = transformer.contiguous_to_paged(cache, BLOCK)
        want, _ = transformer.lm_decode_paged(params, toks[:, -1], dict(pool), table,
                                              torch.tensor([5, 5]), cfg)
        with ops.impl_scope("cuda"):
            got, _ = transformer.lm_decode_paged(params, toks[:, -1], pool, table,
                                                 torch.tensor([5, 5]), cfg)
    assert calls == [True] * cfg.num_layers
    torch.testing.assert_close(got, want)
