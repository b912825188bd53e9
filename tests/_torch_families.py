"""Shared setup of the families' parity tests (``tests/test_torch_families*.py``):
the cases (the four families' reduced configs, and gemma2 with caps that
bend its values), both packages' weights from one numpy draw with random
norm weights, the stated tolerances and the int8 tie rule (``hold``: an
int8 case that misses the tolerance is re-run recording every int8
rounding in both packages, and holds only if the first values that round
differently are .5 ties; ``tests/test_torch_families.py`` says why).

Every variant runs on gemma2 and most on its tight-cap case, whose model
code (norms, window, caps) is this slice's; each plain GQA family
(internlm2, deepseek-coder, pixtral) runs one or two variants, chosen so
that together they cover every variant: their reduced configs differ
only in RoPE theta and pixtral's frontend, and run the code TinyLlama's
tests hold already.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_helpers import numpy_to_jax
from repro.core.policy import quantize_params as jquantize_params
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import bridge
from repro_torch.core.policy import quantize_params
from repro_torch.kernels import ops
from repro_torch.models import attention, registry
from repro_torch.serving.engine import InferenceEngine

def matrix(variants, plain, tight=None):
    """(case, *variant) for every variant of gemma2, the ``tight`` ones
    (default: every one) of its tight-cap case, and each plain GQA family's
    from ``plain`` {family: [variant, ...]}."""
    out = [("gemma2-2b", *v) for v in variants]
    out += [("gemma2-2b-tight", *v) for v in (variants if tight is None else tight)]
    return out + [(c, *v) for c, vs in plain.items() for v in vs]


ARCHS = ("internlm2-1.8b", "deepseek-coder-33b", "pixtral-12b", "gemma2-2b")
TIGHT = {"attn_logit_softcap": 1.0, "final_logit_softcap": 2.0}
CASES = {**{a: (a, {}) for a in ARCHS}, "gemma2-2b-tight": ("gemma2-2b", TIGHT)}
NORM_SCALE = 0.1
CACHE_LEN = 96
PROMPT = 72                  # past gemma2's reduced window of 64
LENGTHS = np.array([72, 58, 66])
VERIFY_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def tree_of(arch: str):
    return bridge.init_params_numpy(registry.load_config(arch).reduced(), seed=7,
                                    norm_scale=NORM_SCALE)


def setup(case: str, quantized: bool, kv_quant=None):
    arch, changes = CASES[case]
    cfg = dataclasses.replace(registry.load_config(arch).reduced(), kv_quant=kv_quant, **changes)
    jcfg = dataclasses.replace(jreg.load_config(arch).reduced(), kv_quant=kv_quant, **changes)
    tree = tree_of(arch)
    jparams = numpy_to_jax(tree)
    params = bridge.params_from_numpy(tree, "cpu")
    if quantized:
        jparams = jquantize_params(jparams, jcfg.group_size)
        params = quantize_params(params, cfg.group_size)
    return cfg, jcfg, params, jparams


def tol(quantized, ref):
    return 2e-3 * np.abs(ref).max() if quantized else 1e-4


TIE = 1e-4


class Held:
    """The comparisons of one run, misses kept (shapes and key sets are
    checked at once)."""

    def __init__(self, quantized: bool):
        self.quantized, self.misses = quantized, []

    def logits(self, got, want, what="logits"):
        ref = np.asarray(want, np.float32)
        assert tuple(got.shape) == ref.shape, what
        err = np.abs(got.float().numpy() - ref).max()
        if err > tol(self.quantized, ref):
            self.misses.append(f"{what}: {err:.3e} > {tol(self.quantized, ref):.3e}")

    def cache(self, tc, jc):
        assert set(tc) == set(jc)
        for k in jc:
            want = np.asarray(jc[k]).astype(np.float32)
            got = tc[k].float().numpy()
            assert got.shape == want.shape, k
            if tc[k].dtype in (torch.int8, torch.float8_e4m3fn):
                # storage rows: one quantum apart at most where an f32
                # reordering moved a value across a rounding edge
                ok = (np.abs(got - want) <= np.abs(want) / 8 + 1).all()
            else:
                ok = np.abs(got - want).max() <= 1e-3
            if not ok:
                self.misses.append(f"cache {k}: {np.abs(got - want).max():.3e}")


@contextlib.contextmanager
def recorded():
    """Record (x, int8 x, scales) of every int8 rounding, in call order, in
    both packages: each quantized projection's activations and each int8
    KV-cache row quantization."""
    ref, port = [], []
    jqmm, tqmm = jops.quantized_matmul, ops.quantized_matmul
    jrows, trows = jattn._quantize_rows, attention._quantize_rows

    def ref_put(*a):
        jax.debug.callback(lambda *t: ref.append([np.asarray(v, np.float32) for v in t]),
                           *a, ordered=True)

    def ref_fn(x, w, *, impl="auto"):
        q = jops.quantize_activation(x, group_size=w.group_size)
        ref_put(x, q.qvalues, q.scales)
        return jqmm(x, w, impl=impl)

    def port_fn(x, w, *, impl=None):
        q = ops.quantize_activation(x, group_size=w.group_size)
        port.append([t.float().numpy().copy() for t in (x, q.qvalues, q.scales)])
        return tqmm(x, w, impl=impl)

    def ref_rows(t, fmt="int8"):
        q, sc = jrows(t, fmt)
        ref_put(t, q, sc[..., None])
        return q, sc

    def port_rows(t, fmt="int8"):
        q, sc = trows(t, fmt)
        port.append([v.float().numpy().copy() for v in (t, q, sc[..., None])])
        return q, sc

    jops.quantized_matmul, ops.quantized_matmul = ref_fn, port_fn
    jattn._quantize_rows, attention._quantize_rows = ref_rows, port_rows
    try:
        yield ref, port
    finally:
        jops.quantized_matmul, ops.quantized_matmul = jqmm, tqmm
        jattn._quantize_rows, attention._quantize_rows = jrows, trows


def ratio(x, s):
    x = x.reshape(-1, x.shape[-1])
    s = s.reshape(x.shape[0], -1)
    s = np.repeat(s, x.shape[-1] // s.shape[-1], axis=-1)
    return x / np.where(s > 0, s, 1.0)          # a zero row (a pad) keeps scale 0


def first_flips(ref, port) -> list[tuple[float, float]]:
    """(reference x/S, port x/S) of every int8 value that differs in the
    first recorded rounding where any differs."""
    for (x0, q0, s0), (x1, q1, s1) in zip(ref, port):
        assert q0.shape == q1.shape
        diff = q0.reshape(-1, q0.shape[-1]) != q1.reshape(-1, q1.shape[-1])
        if diff.any():
            return list(zip(ratio(x0, s0)[diff].tolist(), ratio(x1, s1)[diff].tolist()))
    return []


def tie(a: float, b: float) -> bool:
    """a and b lie within TIE of the same .5 boundary."""
    edge = np.floor(a) + 0.5
    return max(abs(a - edge), abs(b - edge)) <= TIE * max(1.0, abs(a))


def hold(run, quantized: bool, kv_quant=None) -> None:
    """``run(held)`` makes both packages' calls and records comparisons; all
    must hold, or with int8 weights or an int8 KV cache the run's first
    int8 values that differ must be .5 ties (module docstring)."""
    held = Held(quantized)
    run(held)
    if not held.misses:
        return
    assert quantized or kv_quant, held.misses
    with recorded() as (ref, port):
        run(Held(quantized))
    assert len(ref) == len(port)
    flips = first_flips(ref, port)
    assert flips, f"no int8 activation differs, yet {held.misses}"
    assert all(tie(a, b) for a, b in flips), (flips[:4], held.misses)


def tokens(cfg, b=3, s=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s))


def patches(cfg, b=3, seed=5):
    """pixtral's patch embeddings (b, P, d), or None for the other families."""
    if cfg.frontend != "patch_embed":
        return None
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)


def both(x, dtype=None):
    """(jax array, torch tensor) of a numpy array, or (None, None)."""
    if x is None:
        return None, None
    return jnp.asarray(x, dtype), torch.as_tensor(x)




# the serving tests' cases: gemma2's reduced window cut to 16 in both
# packages, so that short prompts and their decode reach past it
WINDOW = {"sliding_window": 16}
SERVING_CASES = {**{a: (a, {}) for a in ARCHS if a != "gemma2-2b"},
                 "gemma2-2b": ("gemma2-2b", WINDOW),
                 "gemma2-2b-tight": ("gemma2-2b", {**WINDOW, **TIGHT})}


def serving_engines(case: str, quantize, cache_len: int):
    """(reference engine, port engine on the CPU) of a serving case, on one
    numpy weight draw with random norm weights."""
    arch, changes = SERVING_CASES[case]
    cfg = dataclasses.replace(registry.load_config(arch).reduced(), **changes)
    jcfg = dataclasses.replace(jreg.load_config(arch).reduced(), **changes)
    tree = bridge.init_params_numpy(cfg, seed=11, norm_scale=NORM_SCALE)
    jeng = JEngine(jreg.build(jcfg), numpy_to_jax(tree), cache_len=cache_len,
                   quantize=quantize)
    teng = InferenceEngine(registry.build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=cache_len, quantize=quantize, device="cpu")
    return jeng, teng
