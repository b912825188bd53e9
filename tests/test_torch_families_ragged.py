"""The families through ``serve_ragged`` against the reference on their
reduced configs (``tests/test_torch_families_serving.py`` states the
weights and gemma2's window, cut to 16): the paged, continuous and
bucketed modes, and speculative (k = 4) in the first two where the family
verifies, whose tokens must equal the reference's vanilla ones. Every mode
runs on gemma2, one on its tight-cap case and on each plain GQA family and
dbrx; the MLA families (no paged pool, no verify) run the continuous
(minicpm3) and bucketed (deepseek-v2-lite) modes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import batching as jbatching  # noqa: E402
from repro_torch.serving import batching  # noqa: E402
from _torch_families import serving_engines  # noqa: E402

SERVE_CACHE = 64             # the bucketed mode pads a 30-token prompt to 32


def _requests(mod, cfg):
    """Prompts of 5 to 30 tokens (gemma2's window is 16)."""
    rng = np.random.default_rng(2)
    lens = [5, 30, 12, 22]
    buds = [8, 6, 10, 4]
    vocab = cfg.vocab_size
    return [mod.Request(i, rng.integers(1, vocab, size=(n,)).tolist(), max_new=m)
            for i, (n, m) in enumerate(zip(lens, buds))]


def _same(got, want):
    assert [r.id for r in got] == [r.id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.length == w.length


@pytest.mark.parametrize("case,mode", [
    ("gemma2-2b", "paged"), ("gemma2-2b", "continuous"), ("gemma2-2b", "bucketed"),
    ("gemma2-2b-tight", "paged"), ("internlm2-1.8b", "continuous"),
    ("deepseek-coder-33b", "bucketed"), ("pixtral-12b", "paged"), ("dbrx-132b", "paged"),
    ("minicpm3-4b", "continuous"), ("deepseek-v2-lite-16b", "bucketed")])
def test_serve_ragged_modes_and_spec_match_reference(case, mode):
    jeng, teng = serving_engines(case, True, SERVE_CACHE)
    cfg = teng.cfg
    kw = dict(mode=mode, slots=3, chunk=4, block_size=8)
    want = jbatching.serve_ragged(jeng, _requests(jbatching, cfg), 10, **kw)
    got = batching.serve_ragged(teng, _requests(batching, cfg), 10, **kw)
    _same(got, want)
    if mode != "bucketed" and teng.model.supports_spec:
        spec = batching.serve_ragged(teng, _requests(batching, cfg), 10, spec_k=4, **kw)
        _same(spec, want)
