"""The families' decode steps against the reference on their
reduced configs (``tests/test_torch_families.py`` states the weights, the
tolerances and the int8 tie rule; ``tests/_torch_families.py`` the cases):
three decode steps at per-row positions past gemma2's reduced window of 64
on the base cache, under ``deferred_decode_cache`` and
``kvt_cache_layout`` (entered in both packages) and over the int8 KV cache;
and three paged decode steps over a float or int8 block pool under a
permuted block table; logits every step and the cache or pool after the
last. The MLA families' latent cache takes the plain and the deferred
decode (``kvt_cache_layout`` selects the deferred one, as in the
reference); dbrx's MoE runs over the base cache and the paged pool.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import (  # noqa: E402
    CACHE_LEN, LENGTHS, both, hold, matrix, setup, tokens, top_k,
)
from _torch_helpers import both_flags  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

DECODE_MODES = {"plain": {}, "deferred": {"deferred_decode_cache": True},
                "kvt": {"kvt_cache_layout": True}, "int8_kv": {}}


@pytest.mark.parametrize("case,mode,quantized", matrix(
    [("plain", False), ("plain", True), ("deferred", False), ("kvt", False),
     ("int8_kv", False)],
    {"internlm2-1.8b": [("plain", True)], "deepseek-coder-33b": [("kvt", False)],
     "pixtral-12b": [("int8_kv", False)], "dbrx-132b": [("plain", True)],
     "minicpm3-4b": [("plain", True), ("deferred", False)],
     "deepseek-v2-lite-16b": [("plain", False), ("kvt", True)]},
    tight=[("plain", False), ("deferred", False), ("int8_kv", False)]))
def test_decode_vector_positions_match_reference(case, mode, quantized):
    """Ragged prefill, then three decode steps at per-row positions past
    gemma2's reduced window: logits every step and the cache after the
    last, on the base cache, under ``deferred_decode_cache`` and
    ``kvt_cache_layout`` (entered in both packages), and over the int8
    KV cache."""
    kvq = "int8" if mode == "int8_kv" else None
    cfg, jcfg, params, jparams = setup(case, quantized, kvq)
    toks = tokens(cfg, seed=1)
    jlen, tlen = both(LENGTHS)

    def run(held):
        with both_flags(**DECODE_MODES[mode]):
            jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN,
                                    lengths=jlen)
            with torch.inference_mode():
                _, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN,
                                               lengths=tlen)
            tok = np.asarray(jl).argmax(-1)
            jpos, tpos = jlen, tlen
            for step in range(3):
                jlog, jc = jtf.lm_decode(jparams, jnp.asarray(tok, jnp.int32), jc, jpos, jcfg)
                with torch.inference_mode():
                    tlog, tc = transformer.lm_decode(params, torch.as_tensor(tok), tc, tpos, cfg)
                held.logits(tlog, jlog, f"step {step}")
                tok = np.asarray(jlog).argmax(-1)
                jpos, tpos = jpos + 1, tpos + 1
        held.cache(tc, jc)

    hold(run, quantized, kvq, top_k(cfg))


@pytest.mark.parametrize("case,kv_quant,quantized", matrix(
    [(None, False), (None, True), ("int8", False)],
    {"internlm2-1.8b": [(None, True)], "deepseek-coder-33b": [("int8", False)],
     "pixtral-12b": [(None, False)], "dbrx-132b": [(None, True)]},
    tight=[(None, False), ("int8", False)]))
def test_decode_paged_matches_reference(case, kv_quant, quantized):
    """The contiguous prefill cache as a block pool under a permuted table,
    then three paged decode steps past the window: logits and the pool."""
    cfg, jcfg, params, jparams = setup(case, quantized, kv_quant)
    toks = tokens(cfg, seed=2)
    jlen, tlen = both(LENGTHS)

    def run(held):
        jl, jc = jtf.lm_prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, CACHE_LEN,
                                lengths=jlen)
        with torch.inference_mode():
            _, tc = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, CACHE_LEN,
                                           lengths=tlen)
        jpool, jtable = jtf.contiguous_to_paged(jc, 8)
        tpool, _ = transformer.contiguous_to_paged(tc, 8)
        perm = np.random.default_rng(3).permutation(jtable.size)
        jpool = {k: v[:, np.argsort(perm)] for k, v in jpool.items()}
        tpool = {k: v[:, np.argsort(perm)] for k, v in tpool.items()}
        table = perm[np.asarray(jtable)]
        tok, pos = np.asarray(jl).argmax(-1), LENGTHS.copy()
        for step in range(3):
            jlog, jpool = jtf.lm_decode_paged(jparams, jnp.asarray(tok, jnp.int32), jpool,
                                              jnp.asarray(table, jnp.int32),
                                              jnp.asarray(pos, jnp.int32), jcfg)
            with torch.inference_mode():
                tlog, tpool = transformer.lm_decode_paged(params, torch.as_tensor(tok), tpool,
                                                          torch.as_tensor(table),
                                                          torch.as_tensor(pos), cfg)
            held.logits(tlog, jlog, f"step {step}")
            tok, pos = np.asarray(jlog).argmax(-1), pos + 1
        held.cache(tpool, jpool)

    hold(run, quantized, kv_quant, top_k(cfg))


