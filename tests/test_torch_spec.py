"""Speculative decoding in the port (``repro_torch.serving.spec``, the verify
path of ``models/transformer.py``, the captured verify programs) against
the reference (``repro.serving.spec``) on reduced TinyLlama with numpy-made
weights, f32 and int8.

- ``spec_accept``, greedy and top-p, k = 1 and k > 1: tokens and ``n_out``
  equal to the reference's given the reference's own draws
  (``jax.random.split`` of the key into the accept key and the
  categorical's key, ``uniform`` and ``gumbel`` reproduced here); the
  residual sampling preserves the top-p distribution.
- ``lm_verify`` / ``lm_verify_paged``: logits within 1e-5 of max|logit|
  and K/V rows within 1e-5 of max|row| of the reference's (another f32
  summation order: XLA's and PyTorch's); with int8 weights each verify
  row's logits equal its decode step's bit for bit, contiguous and paged,
  and the verify leaves the cache as it found it.
- Rollback: a full rejection leaves the cache bit-identical, a partial
  accept touches only the accepted slots, block 0 is never written, and
  the same rows committed paged and contiguous are equal bit for bit.
  Paged and contiguous verify rows are exact at layer 0 and within 1e-5 of
  max|row| deeper (paged and contiguous decode attention sum in other
  orders; the reference's own arrangements differ by up to 1.9e-6 at
  layer 1).
- ``generate(spec_k)``: tokens equal vanilla decode's and the reference's
  speculative run's, with the same ``spec_stats``, contiguous and paged,
  ragged lengths, EOS, ``logits_last`` seeded from the prefill; the oracle
  drafter's step count; the drafters; ``serve_ragged`` speculative in both
  modes against the reference, ``last_spec_stats`` included; the
  validation errors; and one verify program build per signature.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.models.transformer import contiguous_to_paged as jc2p  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import spec as jspec  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import CaptureCounter  # noqa: E402
from repro_torch.core import flags  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.models.transformer import contiguous_to_paged  # noqa: E402
from repro_torch.serving import batching, spec  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402
from repro_torch.serving.sampling import fill_gumbel, nucleus_mask  # noqa: E402

CACHE_LEN = 48
VERIFY_TOL = 1e-5           # f32: XLA's and PyTorch's summation orders
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def tree():
    return bridge.init_params_numpy(load_config(ARCH).reduced(), seed=23)


def _engines(tree, quantize, eos_id=None, cache_len=CACHE_LEN):
    jeng = JEngine(jbuild(jload(ARCH).reduced()), numpy_to_jax(tree), cache_len=cache_len,
                   quantize=quantize, eos_id=eos_id)
    teng = InferenceEngine(build(load_config(ARCH).reduced()),
                           bridge.params_from_numpy(tree, "cpu"), cache_len=cache_len,
                           quantize=quantize, eos_id=eos_id, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def pair(tree):
    return _engines(tree, True)


def _toks(b=2, s=8, seed=0):
    return np.random.default_rng(seed).integers(1, 500, (b, s))


class AdversarialDrafter:
    """Drafts tokens unrelated to the target's: every draft is rejected."""

    name = "adversarial"

    def draft(self, tokens, k):
        return [(tokens[-1] + 1 + i) % 97 + 1 for i in range(k)]


# ---------------------------------------------------------------------------
# spec_accept against the reference, on the reference's draws
# ---------------------------------------------------------------------------

def _accept_case(seed, b, k, v, temp):
    """Logits (b, k, v) and a chunk whose drafts are often the likely tokens."""
    rng = np.random.default_rng(seed)
    lg = (rng.normal(size=(b, k, v)) * 2).astype(np.float32)
    likely = np.argmax(lg, -1)
    drafts = np.where(rng.random((b, k)) < 0.6, likely, rng.integers(0, v, (b, k)))
    chunk = np.concatenate([rng.integers(0, v, (b, 1)), drafts[:, : k - 1]], 1)
    return lg, chunk.astype(np.int64)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_accept_greedy_equals_reference(k):
    for seed in range(8):
        lg, chunk = _accept_case(seed, 5, k, 12, 1.0)
        want = jspec.spec_accept(jnp.asarray(lg), jnp.asarray(chunk, jnp.int32),
                                 jax.random.PRNGKey(0))
        got = spec.spec_accept(torch.as_tensor(lg), torch.as_tensor(chunk))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("p,temperature", [(0.9, 1.0), (0.6, 0.8), (1e-6, 1.0)])
def test_spec_accept_top_p_equals_reference_on_its_draws(k, p, temperature):
    """The reference splits its key into (accept, categorical) keys and draws
    uniform (b, k-1) and Gumbel (b, V) from them; the port given those
    draws returns the same tokens and n_out."""
    b, v = 6, 16
    kw = {"p": p, "temperature": temperature}
    for seed in range(8):
        lg, chunk = _accept_case(100 + seed, b, k, v, temperature)
        key = jax.random.PRNGKey(seed)
        want = jspec.spec_accept(jnp.asarray(lg), jnp.asarray(chunk, jnp.int32), key,
                                 sampler="top_p", sampler_kw=kw)
        ku, kr = jax.random.split(key)
        uniform = np.array(jax.random.uniform(ku, (b, k - 1)))
        gumbel = np.array(jax.random.gumbel(kr, (b, v), jnp.float32))
        got = spec.spec_accept(torch.as_tensor(lg), torch.as_tensor(chunk), sampler="top_p",
                               sampler_kw=tuple(kw.items()), uniform=torch.as_tensor(uniform),
                               gumbel=torch.as_tensor(gumbel))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_spec_accept_errors():
    lg, chunk = torch.zeros((1, 2, 4)), torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="unknown sampler"):
        spec.spec_accept(lg, chunk, sampler="beam")
    with pytest.raises(ValueError, match="top_p accept takes p/temperature"):
        spec.spec_accept(lg, chunk, sampler="top_p", sampler_kw=(("k", 3),))


def test_residual_sampling_preserves_distribution():
    """One accept/reject position with a deterministic draft: the output
    token's frequencies over 20k rows equal the top-p target distribution
    within a 5-sigma binomial envelope (accept d with p(d), else sample the
    target with d removed)."""
    logits = torch.tensor([2.0, 1.0, 0.5, -1.0, -3.0, -3.5])
    p, n, draft = 0.85, 20_000, 1
    target = torch.softmax(torch.where(nucleus_mask(logits[None], p)[0], logits, -1e30),
                           -1).numpy()
    gen = torch.Generator().manual_seed(0)
    lg = logits.expand(n, 2, 6)
    chunk = torch.tensor([[0, draft]]).expand(n, 2)
    uniform = torch.rand((n, 1), generator=gen)
    gumbel = fill_gumbel(torch.empty((n, 6)), gen)
    out, n_out = spec.spec_accept(lg, chunk, sampler="top_p", sampler_kw=(("p", p),),
                                  uniform=uniform, gumbel=gumbel)
    counts = np.bincount(out[:, 0].numpy(), minlength=6)
    assert counts[target == 0].sum() == 0
    for v in range(6):
        sigma = math.sqrt(max(target[v] * (1 - target[v]) / n, 1e-12))
        assert abs(counts[v] / n - target[v]) < 5 * sigma + 1e-9, (v, counts[v] / n, target[v])
    accepted = (n_out == 2).float().mean().item()
    assert abs(accepted - target[draft]) < 5 * math.sqrt(target[draft] / n)


# ---------------------------------------------------------------------------
# lm_verify / lm_verify_paged and the rollback invariants
# ---------------------------------------------------------------------------

def _prefilled(jeng, teng, seed=0):
    toks = _toks(seed=seed)
    jlog, jcache = jeng.model.prefill(jeng.params, {"tokens": jnp.asarray(toks, jnp.int32)},
                                      jeng.cache_len)
    with torch.inference_mode():
        _, tcache = teng.model.prefill(teng.params, {"tokens": torch.as_tensor(toks)},
                                       teng.cache_len)
    tok0 = np.asarray(jnp.argmax(jlog, -1))
    chunk = np.concatenate([tok0[:, None], [[3, 5, 7], [2, 4, 6]]], 1)
    pos = np.full((2,), toks.shape[1])
    return jcache, tcache, chunk, pos


def _close(got, want, tol=VERIFY_TOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_logits_and_rows_match_reference(tree, quantize, paged):
    jeng, teng = _engines(tree, quantize)
    jcache, tcache, chunk, pos = _prefilled(jeng, teng)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.as_tensor(pos)
    with torch.inference_mode():
        if paged:
            jpool, jtab = jc2p(jcache, 8)
            tpool, ttab = contiguous_to_paged(tcache, 8)
            want = jeng.model.verify_paged(jeng.params, jnp.asarray(chunk, jnp.int32), jpool,
                                           jtab, jpos)
            got = teng.model.verify_paged(teng.params, torch.as_tensor(chunk), tpool, ttab, tpos)
        else:
            want = jeng.model.verify(jeng.params, jnp.asarray(chunk, jnp.int32), jcache, jpos)
            got = teng.model.verify(teng.params, torch.as_tensor(chunk), tcache, tpos)
    _close(got[0], want[0])
    for name in ("k", "v"):
        _close(got[1][name], want[1][name])
    assert got[0].shape == (2, 4, teng.cfg.vocab_padded)


@pytest.mark.parametrize("paged,deferred", [(False, False), (False, True), (True, False)],
                         ids=["contiguous", "contiguous-deferred", "paged"])
def test_verify_rows_are_decode_steps_bit_for_bit(pair, paged, deferred):
    """int8 weights: verify row m's logits equal, bit for bit, those of the
    decode step at pos + m fed chunk token m (also under
    ``deferred_decode_cache``, whose decode attends in two parts); the
    verify leaves the cache bit-identical; and its rows, all committed,
    give the cache of those k decode steps. Greedy spec is vanilla decode
    because each verify row sums as its decode step does (the norms per
    chunk column, the decode step's attention; a GQMM row's result does not
    depend on the rows beside it), on the card as here. (Float weights go
    through a BLAS product whose row sums may depend on the number of
    rows.)"""
    jeng, teng = pair
    _, cache, chunk, pos = _prefilled(jeng, teng)
    model, params = teng.model, teng.params
    pos_t, chunk_t = torch.as_tensor(pos), torch.as_tensor(chunk)
    k = chunk.shape[1]
    with torch.inference_mode(), flags.overrides(deferred_decode_cache=deferred):
        table = None
        if paged:
            cache, table = contiguous_to_paged(cache, 8)
        before = {name: v.clone() for name, v in cache.items()}
        if paged:
            logits, rows = model.verify_paged(params, chunk_t, cache, table, pos_t)
        else:
            logits, rows = model.verify(params, chunk_t, cache, pos_t)
        for name in cache:
            assert torch.equal(cache[name], before[name])
        dec = before
        for m in range(k):
            if paged:
                lg, dec = model.decode_paged(params, chunk_t[:, m], dec, table, pos_t + m)
            else:
                lg, dec = model.decode(params, chunk_t[:, m], dec, pos_t + m)
            assert torch.equal(logits[:, m], lg), m
        full = torch.full((2,), k)
        if paged:
            model.commit_verify_paged(cache, rows, table, pos_t, full)
        else:
            model.commit_verify(cache, rows, pos_t, full)
    for name in cache:
        assert torch.equal(cache[name], dec[name]), name


def test_rollback_contiguous(pair):
    jeng, teng = pair
    _, cache, chunk, pos = _prefilled(jeng, teng)
    pos_t = torch.as_tensor(pos)
    with torch.inference_mode():
        _, rows = teng.model.verify(teng.params, torch.as_tensor(chunk), cache, pos_t)
        before = {k: v.clone() for k, v in cache.items()}
        # full rejection: nothing committed, the cache bit-identical
        teng.model.commit_verify(cache, rows, pos_t, torch.zeros(2, dtype=torch.long))
        for name in cache:
            assert torch.equal(cache[name], before[name])
        # partial accept: only slots pos..pos+n-1 change
        teng.model.commit_verify(cache, rows, pos_t, torch.tensor([2, 1]))
    p = int(pos[0])
    for name in ("k", "v"):
        b, a = before[name].numpy(), cache[name].numpy()
        touched = np.zeros(b.shape, bool)
        touched[:, 0, p:p + 2] = True
        touched[:, 1, p:p + 1] = True
        np.testing.assert_array_equal(a[~touched], b[~touched])
        np.testing.assert_array_equal(a[:, 0, p:p + 2], rows[name][:, 0, :2].numpy())
        np.testing.assert_array_equal(a[:, 1, p:p + 1], rows[name][:, 1, :1].numpy())


def test_rollback_paged_block0_and_paged_equals_contiguous(pair):
    """The paged commit: full rejection bit-identical; a rejected suffix
    never writes block 0 (under identity tables row 0's first block); the
    same rows committed paged and contiguous equal bit for bit; paged and
    contiguous verify rows exact at layer 0 and within VERIFY_TOL deeper."""
    jeng, teng = pair
    _, cache, chunk, pos = _prefilled(jeng, teng)
    pos_t, chunk_t = torch.as_tensor(pos), torch.as_tensor(chunk)
    with torch.inference_mode():
        pool, table = contiguous_to_paged({k: v.clone() for k, v in cache.items()}, 8)
        _, rows_p = teng.model.verify_paged(teng.params, chunk_t, pool, table, pos_t)
        _, rows_c = teng.model.verify(teng.params, chunk_t, cache, pos_t)
        before = {k: v.clone() for k, v in pool.items()}
        teng.model.commit_verify_paged(pool, rows_p, table, pos_t, torch.zeros(2, dtype=torch.long))
        for name in pool:
            assert torch.equal(pool[name], before[name])
        teng.model.commit_verify_paged(pool, rows_p, table, pos_t, torch.tensor([1, 1]))
        assert torch.equal(pool["k_pages"][:, 0], before["k_pages"][:, 0])
        assert torch.equal(pool["v_pages"][:, 0], before["v_pages"][:, 0])
        for name in ("k", "v"):
            assert torch.equal(rows_p[name][0], rows_c[name][0])          # layer 0: exact
            _close(rows_p[name], rows_c[name].numpy())
        # the same rows committed both ways are equal bit for bit
        n = torch.tensor([2, 1])
        pool2, table2 = contiguous_to_paged({k: v.clone() for k, v in cache.items()}, 8)
        teng.model.commit_verify_paged(pool2, rows_c, table2, pos_t, n)
        teng.model.commit_verify(cache, rows_c, pos_t, n)
        pooled, _ = contiguous_to_paged(cache, 8)
    for name in ("k_pages", "v_pages"):
        assert torch.equal(pool2[name], pooled[name])


def test_verify_refuses_quantized_and_kvt_layouts(tree):
    _, teng = _engines(tree, True)
    toks = torch.ones((1, 2), dtype=torch.long)
    with both_flags(kvt_cache_layout=True):
        cache = teng.model.init_cache(1, 16, torch.float32, "cpu")
        with pytest.raises(ValueError, match="base float KV layout"):
            teng.model.verify(teng.params, toks, cache, 0)


# ---------------------------------------------------------------------------
# generate(spec_k)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_generate_spec_equals_vanilla_and_reference(tree, quantize, paged):
    jeng, teng = _engines(tree, quantize)
    toks = _toks()
    van = teng.generate({"tokens": torch.as_tensor(toks)}, 12, paged=paged)
    for drafter in (None, AdversarialDrafter()):
        got = teng.generate({"tokens": torch.as_tensor(toks)}, 12, paged=paged, spec_k=4,
                            drafter=drafter)
        want = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 12, paged=paged,
                             spec_k=4, drafter=drafter)
        np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert got.spec_stats == want.spec_stats and got.steps == want.steps
        _close(got.logits_last, np.asarray(want.logits_last))
    assert got.spec_stats["accepted"] == 0                  # adversarial: pure rollback


def test_generate_spec_ragged_lengths(pair):
    jeng, teng = pair
    toks, lens = _toks(b=3, s=10, seed=3), [4, 10, 7]
    van = teng.generate({"tokens": torch.as_tensor(toks)}, 10, lengths=lens)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, 10, lengths=lens, spec_k=3)
    want = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10, lengths=lens, spec_k=3)
    np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.spec_stats == want.spec_stats


def test_generate_spec_eos_and_stats(tree):
    jeng0, teng0 = _engines(tree, True)
    toks = _toks(seed=11)
    probe = teng0.generate({"tokens": torch.as_tensor(toks)}, 12).tokens.numpy()
    eos = int(probe[0, 4])
    jeng, teng = _engines(tree, True, eos_id=eos)
    van = teng.generate({"tokens": torch.as_tensor(toks)}, 12)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, 12, spec_k=4)
    want = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 12, spec_k=4)
    np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.spec_stats == want.spec_stats
    t = got.tokens.numpy()
    kept = sum(int(np.argmax(row == eos)) + 1 if eos in row else t.shape[1] for row in t)
    assert got.spec_stats["generated"] == kept
    _close(got.logits_last, np.asarray(want.logits_last))


def test_generate_spec_logits_seeded_from_prefill(pair):
    """max_new = 1 runs no verify step: logits_last is the prefill's, bit
    for bit, and the tokens and stats are the reference's."""
    jeng, teng = pair
    toks = _toks(seed=13)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, 1, spec_k=4)
    want = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 1, spec_k=4)
    assert got.spec_stats == want.spec_stats and got.spec_stats["verify_steps"] == 0
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    prefill, _ = teng.prefill({"tokens": torch.as_tensor(toks)})
    assert torch.equal(got.logits_last, prefill)


class OracleDrafter:
    """Drafts the target's own greedy continuation (the reference's
    SelfDrafter), for one row."""

    name = "oracle"

    def __init__(self, continuation, prompt_len):
        self.continuation = [int(t) for t in continuation]
        self.prompt_len = prompt_len

    def draft(self, tokens, k):
        g = len(tokens) - self.prompt_len
        out = self.continuation[g:g + k]
        return out + [0] * (k - len(out))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_self_draft_full_acceptance(pair, paged):
    _, teng = pair
    k, n = 4, 13
    toks = _toks(b=1, seed=5)
    van = teng.generate({"tokens": torch.as_tensor(toks)}, n + k).tokens.numpy()
    drafter = OracleDrafter(van[0, 1:], prompt_len=toks.shape[1] + 1)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, n, spec_k=k, drafter=drafter,
                        paged=paged)
    np.testing.assert_array_equal(got.tokens.numpy(), van[:, :n])
    st = got.spec_stats
    assert st["accepted"] == st["drafted"] and st["verify_steps"] == math.ceil((n - 1) / k)


def test_top_p_tiny_p_equals_greedy_spec(pair):
    _, teng = pair
    batch = {"tokens": torch.as_tensor(_toks())}
    van = teng.generate(batch, 10)
    got = teng.generate(batch, 10, spec_k=3, sampler="top_p", sampler_kw={"p": 1e-6})
    np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())
    a = teng.generate(batch, 10, spec_k=3, sampler="top_p", sampler_kw={"p": 0.9}, seed=2)
    b = teng.generate(batch, 10, spec_k=3, sampler="top_p", sampler_kw={"p": 0.9}, seed=2)
    assert torch.equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < teng.cfg.vocab_padded)).all()


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_equals_reference_on_random_histories():
    rng = np.random.default_rng(0)
    for max_n, window in ((3, 512), (1, 512), (2, 6)):
        mine, ref = spec.NgramDrafter(max_n, window), jspec.NgramDrafter(max_n, window)
        for _ in range(200):
            hist = rng.integers(0, 6, size=int(rng.integers(0, 30))).tolist()
            k = int(rng.integers(1, 6))
            assert mine.draft(hist, k) == ref.draft(hist, k)
    assert spec.NgramDrafter().draft([1, 7, 8, 9, 10, 11, 7, 8], 3) == [9, 10, 11]
    assert spec.NgramDrafter().draft([], 2) == [0, 0]
    with pytest.raises(ValueError, match="max_n"):
        spec.NgramDrafter(max_n=0)
    assert isinstance(spec.NgramDrafter(), spec.Drafter)


def test_model_drafter_equals_reference_and_keeps_tokens(tree, pair):
    """The port's ModelDrafter (its own prefill and decode) drafts the
    reference ModelDrafter's tokens on the same weights, and drafting with
    it leaves greedy output unchanged."""
    jeng, teng = pair
    cfg = load_config(ARCH).reduced()
    dtree = bridge.init_params_numpy(cfg, seed=9)
    mine = spec.ModelDrafter(build(cfg), bridge.params_from_numpy(dtree, "cpu"))
    ref = jspec.ModelDrafter(jbuild(jload(ARCH).reduced()), numpy_to_jax(dtree))
    assert mine.name == ref.name == "model:tinyllama-1.1b"
    for ctx in ([5, 6, 7], list(range(1, 12)), [3] * 9):
        assert mine.draft(ctx, 3) == ref.draft(ctx, 3)
    toks = _toks()
    van = teng.generate({"tokens": torch.as_tensor(toks)}, 8)
    got = teng.generate({"tokens": torch.as_tensor(toks)}, 8, spec_k=3, drafter=mine)
    np.testing.assert_array_equal(got.tokens.numpy(), van.tokens.numpy())


def test_resolve_drafter():
    assert isinstance(spec.resolve_drafter(None), spec.NgramDrafter)
    assert isinstance(spec.resolve_drafter("ngram"), spec.NgramDrafter)
    md = spec.resolve_drafter("model:tinyllama-1.1b", reduced=True, device="cpu")
    assert isinstance(md, spec.ModelDrafter) and md.name == "model:tinyllama-1.1b"
    assert len(md.draft([1, 2, 3], 2)) == 2
    with pytest.raises(ValueError, match="unknown drafter"):
        spec.resolve_drafter("medusa")
    # the encoder-decoder refuses as in the reference (repro's ModelDrafter)
    with pytest.raises(ValueError, match="ModelDrafter needs length-aware prefill"):
        spec.resolve_drafter("model:seamless-m4t-large-v2", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="length-aware prefill"):
        spec.resolve_drafter("model:rwkv6-7b", reduced=True, device="cpu")


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["continuous", "paged"])
def test_serve_ragged_spec_equals_reference(pair, mode):
    jeng, teng = pair
    rng = np.random.default_rng(2)
    lens, buds = [2, 5, 9, 14, 3, 7], [12, 3, 10, 4, 8, 6]
    prompts = [rng.integers(1, 500, size=(n,)).tolist() for n in lens]
    kw = dict(mode=mode, slots=3, chunk=4, spec_k=4)
    want = jbatching.serve_ragged(jeng, [jbatching.Request(i, p, max_new=m) for i, (p, m)
                                         in enumerate(zip(prompts, buds))], 12, **kw)
    reqs = [batching.Request(i, p, max_new=m) for i, (p, m) in enumerate(zip(prompts, buds))]
    got = batching.serve_ragged(teng, reqs, 12, **kw)
    van = batching.serve_ragged(teng, reqs, 12, mode=mode, slots=3, chunk=4)
    for g, w, v in zip(got, want, van):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        np.testing.assert_array_equal(g.tokens, v.tokens)
        assert g.length == w.length == v.length
    scheds = teng._paged_schedulers if mode == "paged" else teng._slot_schedulers
    jscheds = jeng._paged_schedulers if mode == "paged" else jeng._slot_schedulers
    mine = [s.last_spec_stats for s in scheds.values() if s.last_spec_stats]
    ref = [s.last_spec_stats for s in jscheds.values() if s.last_spec_stats]
    assert mine == ref and mine[0]["generated"] == sum(buds)


def test_serve_spec_with_eos_and_small_pool(tree):
    """EOS mid-chunk and a pool too small for every slot's worst case (the
    block lookahead covers a whole verify chunk): tokens equal vanilla's."""
    _, teng0 = _engines(tree, True)
    reqs = [batching.Request(i, list(range(3 + i, 9 + 2 * i)), max_new=9) for i in range(5)]
    free = batching.serve_ragged(teng0, reqs, 9, mode="continuous", slots=2)
    eos = int(free[1].tokens[3])
    _, teng = _engines(tree, True, eos_id=eos)
    for mode, extra in (("continuous", {}), ("paged", {"num_blocks": 9, "block_size": 4})):
        van = batching.serve_ragged(teng, reqs, 9, mode=mode, slots=2, **extra)
        got = batching.serve_ragged(teng, reqs, 9, mode=mode, slots=2, spec_k=3, **extra)
        assert [r.tokens.tolist() for r in got] == [r.tokens.tolist() for r in van]
        assert [r.length for r in got] == [r.length for r in van]


def test_spec_validation_errors(pair):
    _, teng = pair
    batch = {"tokens": torch.as_tensor(_toks())}
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        teng.generate(batch, 4, spec_k=1)
    with pytest.raises(ValueError, match=r"spec_k=4 needs 52 slots"):
        teng.generate(batch, 40, spec_k=4)           # vanilla fits: 8 + 40 = 48
    teng.generate(batch, 40)
    qeng = InferenceEngine(teng.model, teng.params, cache_len=CACHE_LEN, kv_quant="int8",
                           device="cpu")
    with pytest.raises(ValueError, match="float KV layout"):
        qeng.generate(batch, 4, spec_k=2)
    req = [batching.Request(0, list(range(1, 9)), max_new=40)]
    with pytest.raises(ValueError, match="bucketed"):
        batching.serve_ragged(teng, req[:1], 4, spec_k=2, mode="bucketed")
    for mode in ("continuous", "paged"):
        with pytest.raises(ValueError, match=r"\+ spec_k=4 needs"):
            batching.serve_ragged(teng, req, 40, mode=mode, spec_k=4)
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        batching.SlotScheduler(teng, spec_k=1)


def test_verify_programs_build_once_per_signature(tree):
    """The captured verify program (run eagerly on the CPU): one build per
    signature, none for a repeated call, a new one for another k, sampler
    or cache layout; the schedulers' likewise."""
    _, teng = _engines(tree, True)
    batch = {"tokens": torch.as_tensor(_toks(seed=21))}
    with CaptureCounter() as cc:
        teng.generate(batch, 9, spec_k=4)
        teng.generate(batch, 9, spec_k=4)
    assert dict(cc.counts) == {"generate.prefill": 1, "generate.verify": 1}
    with CaptureCounter() as cc:
        teng.generate(batch, 9, spec_k=4)
        teng.generate(batch, 9, spec_k=3)
        teng.generate(batch, 9, spec_k=4, paged=True)
        teng.generate(batch, 9, spec_k=4, sampler="top_p", sampler_kw={"p": 0.5})
    assert cc.counts["generate.verify"] == 3 and cc.counts["generate.prefill"] == 2
    reqs = [batching.Request(i, list(range(2, 6 + i)), max_new=5) for i in range(4)]
    for mode, name in (("paged", "paged.verify"), ("continuous", "contiguous.verify")):
        with CaptureCounter() as first:
            batching.serve_ragged(teng, reqs, 5, mode=mode, slots=2, spec_k=3)
        with CaptureCounter() as second:
            batching.serve_ragged(teng, reqs, 5, mode=mode, slots=2, spec_k=3)
        first.assert_builds(name, 1)
        assert second.total() == 0


def test_serve_cli_spec_and_top_p(capsys):
    """The serve CLI's --spec-k / --drafter and --sampler top_p on the CPU:
    the uniform batch reports its verify steps, the ragged trace serves
    speculatively, a model drafter is taken by name, and --kv-quant with
    --spec-k is refused."""
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "6", "--steps", "5",
            "--device", "cpu"]
    res = serve.main(base + ["--spec-k", "3", "--sampler", "top_p", "--top-p", "0.8"])
    out = capsys.readouterr().out
    assert "speculative (ngram)" in out and "verify steps" in out
    assert tuple(res.tokens.shape) == (2, 5) and res.spec_stats["generated"] == 10
    out = serve.main(base + ["--ragged", "--slots", "2", "--spec-k", "2",
                             "--drafter", "model:tinyllama-1.1b"])
    assert [r.length for r in out] == [5, 5] and "ragged (paged" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(base + ["--spec-k", "2", "--kv-quant", "int8"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--ragged", "--mode", "bucketed", "--spec-k", "2"])
