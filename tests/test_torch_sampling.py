"""The port's samplers (``repro_torch.serving.sampling``) against the
reference's (``repro.serving.sampling``): ``nucleus_mask`` equal on the same
logits (ties included, several p), ``top_p`` equal tokens given the
reference's own Gumbel draw, the sampler factory's errors, the Gumbel noise
the serving path draws, top-p's distribution, and top-p through
``generate`` and ``serve_ragged`` on reduced TinyLlama: the noise plumbing
(one draw a step, prefill first) against a hand-run step loop, seeds, and
p -> 0 collapsing to greedy."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.common import NEG_INF  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving import batching, sampling  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CACHE_LEN = 40
PS = (1e-6, 0.1, 0.3, 0.5, 0.75, 0.9, 0.99)
PROMPTS = [[5, 3], [7, 1, 4], list(range(1, 11)), [9] * 6, list(range(30, 39))]
BUDGETS = [6, 3, 5, 1, 4]


def _logits(seed: int, shape, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ties:        # half-unit steps: many exactly equal logits
        return (rng.integers(-3, 4, size=shape) * 0.5).astype(np.float32)
    return (rng.normal(size=shape) * 3).astype(np.float32)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_nucleus_mask_equals_reference(p, ties):
    """Boolean masks exactly equal for p < 1 (at p = 1 the last tail token
    sits on the exclusive mass's rounding edge, where the two cumsums may
    round apart)."""
    for seed in range(6):
        lg = _logits(seed, (3, 7 + 9 * seed), ties)
        want = np.asarray(jsampling.nucleus_mask(jnp.asarray(lg), p))
        got = sampling.nucleus_mask(torch.as_tensor(lg), p).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.any(axis=-1).all()                  # the top token is always kept


@pytest.mark.parametrize("p,temperature", [(0.9, 1.0), (0.5, 0.7), (0.99, 1.5), (1e-6, 1.0)])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_top_p_equals_reference_given_its_draw(p, temperature, ties):
    """The reference's categorical is argmax(logits + gumbel(key, shape)):
    the port given that draw returns the reference's tokens exactly."""
    for seed in range(5):
        lg = _logits(100 + seed, (4, 50), ties)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsampling.top_p(jnp.asarray(lg), key, p, temperature))
        gumbel = np.array(jax.random.gumbel(key, lg.shape, jnp.float32))
        sample = sampling.make_sampler("top_p", p=p, temperature=temperature)
        got = sample(torch.as_tensor(lg), gumbel=torch.as_tensor(gumbel)).numpy()
        np.testing.assert_array_equal(got, want)


def test_make_sampler_and_sig():
    assert sampling.make_sampler("greedy") is sampling.greedy
    with pytest.raises(ValueError, match="greedy sampler takes no kwargs"):
        sampling.make_sampler("greedy", p=0.5)
    with pytest.raises(ValueError, match="unknown sampler"):
        sampling.make_sampler("beam")
    with pytest.raises(TypeError):        # as the reference: unknown top_p kwargs fail at call
        sampling.make_sampler("top_p", k=5)(torch.zeros((1, 3)), gumbel=torch.zeros((1, 3)))
    assert sampling.sampler_sig({"temperature": 1.0, "p": 0.9}) == \
        jsampling.sampler_sig({"p": 0.9, "temperature": 1.0}) == (("p", 0.9), ("temperature", 1.0))
    assert sampling.sampler_sig(None) == ()
    assert sampling.needs_noise("top_p") and not sampling.needs_noise("greedy")


def test_gumbel_noise_is_seeded_and_standard():
    """``fill_gumbel`` draws Gumbel(0, 1) in place from the generator: the
    same seed gives the same draw, and 200k draws have the distribution's
    mean (Euler's gamma) and variance (pi^2 / 6) within 5 sigma."""
    draw = [sampling.fill_gumbel(torch.empty(200_000), torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and torch.isfinite(draw[0]).all()
    x = draw[0].double()
    var = math.pi ** 2 / 6
    assert abs(x.mean().item() - 0.5772156649) < 5 * math.sqrt(var / x.numel())
    assert abs(x.var().item() - var) < 0.05 * var
    ins = {sampling.UNIFORM: torch.zeros(3, 2), sampling.GUMBEL: torch.zeros(3, 5),
           "other": torch.zeros(2)}
    sampling.draw_noise(ins, torch.Generator().manual_seed(1))
    u = ins[sampling.UNIFORM]
    assert ((u >= 0) & (u < 1)).all() and u.unique().numel() == 6
    assert (ins[sampling.GUMBEL] != 0).all() and not ins["other"].any()


def test_top_p_sampling_preserves_the_nucleus_distribution():
    """20k rows of one toy distribution: the token frequencies match the
    renormalised nucleus within a 5-sigma binomial envelope, and no token
    outside the nucleus is ever drawn."""
    lg = torch.tensor([2.0, 1.0, 0.5, -1.0, -3.0, -3.5])
    p, n = 0.85, 20_000
    mask = sampling.nucleus_mask(lg[None], p)[0]
    target = torch.softmax(torch.where(mask, lg, NEG_INF), -1).numpy()
    gumbel = sampling.fill_gumbel(torch.empty((n, 6)), torch.Generator().manual_seed(0))
    toks = sampling.top_p(lg.expand(n, 6), p, gumbel=gumbel)
    counts = np.bincount(toks.numpy(), minlength=6)
    assert counts[target == 0].sum() == 0
    for v in range(6):
        sigma = math.sqrt(max(target[v] * (1 - target[v]) / n, 1e-12))
        assert abs(counts[v] / n - target[v]) < 5 * sigma + 1e-9, (v, counts[v] / n, target[v])


# ---------------------------------------------------------------------------
# top-p through the serving paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    cfg = load_config("tinyllama-1.1b").reduced()
    tree = bridge.init_params_numpy(cfg, seed=11)
    return InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=CACHE_LEN, quantize=True, device="cpu")


def _prompt(b=3, s=8, seed=4):
    return {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(1, 500, (b, s)))}


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_generate_top_p_matches_a_step_loop_on_the_same_noise(engine, paged):
    """generate(top_p) draws one (b, V) Gumbel block before the prefill and
    one before each decode step from a generator seeded with ``seed``: a
    prefill + decode_step loop sampling with the same draws gives the same
    tokens, exactly."""
    batch, n, kw = _prompt(), 7, {"p": 0.8, "temperature": 0.9}
    got = engine.generate(batch, n, sampler="top_p", sampler_kw=kw, seed=5, paged=paged)
    gen = torch.Generator().manual_seed(5)
    sample = sampling.make_sampler("top_p", **kw)
    v = engine.cfg.vocab_padded
    with torch.inference_mode():
        logits, cache = engine.prefill(batch)
        toks = []
        for i in range(n):
            tok = sample(logits, gumbel=sampling.fill_gumbel(torch.empty((3, v)), gen))
            toks.append(tok)
            logits, cache = engine.decode_step(tok, cache, 8 + i)
    np.testing.assert_array_equal(got.tokens.numpy(), torch.stack(toks, 1).numpy())


def test_generate_top_p_seeds_and_tiny_p(engine):
    batch, kw = _prompt(), dict(sampler="top_p", sampler_kw={"p": 0.95})
    a = engine.generate(batch, 8, seed=1, **kw).tokens
    b = engine.generate(batch, 8, seed=1, **kw).tokens
    c = engine.generate(batch, 8, seed=2, **kw).tokens
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = engine.generate(batch, 8).tokens
    tiny = engine.generate(batch, 8, sampler="top_p", sampler_kw={"p": 1e-6}, seed=3).tokens
    assert torch.equal(tiny, greedy)
    with pytest.raises(ValueError, match="greedy sampler takes no kwargs"):
        engine.generate(batch, 4, sampler_kw={"p": 0.9})


@pytest.mark.parametrize("mode", ["paged", "continuous", "bucketed"])
def test_serve_ragged_top_p(engine, mode):
    """Every serving mode takes ``sampler_kw`` and ``seed``: p -> 0 gives the
    greedy tokens, a seed gives the same tokens twice, and the tokens stay
    in the vocabulary with each request's budget."""
    reqs = [batching.Request(i, p, max_new=b) for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    kw = dict(mode=mode, slots=2, chunk=3)
    greedy = batching.serve_ragged(engine, reqs, 6, **kw)
    tiny = batching.serve_ragged(engine, reqs, 6, sampler="top_p",
                                 sampler_kw={"p": 1e-6}, **kw)
    assert [r.tokens.tolist() for r in tiny] == [r.tokens.tolist() for r in greedy]
    one = batching.serve_ragged(engine, reqs, 6, sampler="top_p", sampler_kw={"p": 0.9},
                                seed=4, **kw)
    two = batching.serve_ragged(engine, reqs, 6, sampler="top_p", sampler_kw={"p": 0.9},
                                seed=4, **kw)
    assert [r.tokens.tolist() for r in one] == [r.tokens.tolist() for r in two]
    for r, b in zip(one, BUDGETS):
        assert r.length == b and ((r.tokens >= 0) & (r.tokens < engine.cfg.vocab_padded)).all()
