"""Shared setup of the families' parity tests (``tests/test_torch_families*.py``):
the cases (the seven families' reduced configs, and gemma2 with caps that
bend its values), both packages' weights from one numpy draw with random
norm weights, the stated tolerances and the tie rule (``hold``: a case
that misses the tolerance is re-run recording every int8 rounding and MoE
router choice in both packages, and holds only if the first decision that
differs is a tie: int8 values on .5 boundaries, or a router whose k-th and
(k+1)-th probabilities lie within ROUTER_TIE; ``tests/test_torch_families.py``
says why).

Every variant runs on gemma2 and most on its tight-cap case, whose model
code (norms, window, caps) is this slice's; each plain GQA family
(internlm2, deepseek-coder, pixtral) runs one or two variants, chosen so
that together they cover every variant: their reduced configs differ
only in RoPE theta and pixtral's frontend, and run the code TinyLlama's
tests hold already. The MoE and MLA families (``MOE_MLA``) run the
variants their own code reaches: dbrx the GQA caches, paged decode and
verify through its MoE; minicpm3 and deepseek-v2-lite the latent cache's
prefill and decode (plain and deferred); ``tests/test_torch_moe.py`` and
``tests/test_torch_mla.py`` hold the modules themselves.
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
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import bridge
from repro_torch.core.policy import quantize_params
from repro_torch.kernels import ops
from repro_torch.models import attention, mlp, registry
from repro_torch.serving.engine import InferenceEngine

def matrix(variants, plain, tight=None):
    """(case, *variant) for every variant of gemma2, the ``tight`` ones
    (default: every one) of its tight-cap case, and each plain GQA family's
    from ``plain`` {family: [variant, ...]}."""
    out = [("gemma2-2b", *v) for v in variants]
    out += [("gemma2-2b-tight", *v) for v in (variants if tight is None else tight)]
    return out + [(c, *v) for c, vs in plain.items() for v in vs]


ARCHS = ("internlm2-1.8b", "deepseek-coder-33b", "pixtral-12b", "gemma2-2b")
# the MoE and MLA families: dbrx (GQA with a MoE FFN), minicpm3 (MLA with a
# low-rank query, dense FFN), deepseek-v2-lite (MLA and a MoE with a shared
# expert); each runs the variants its model code adds
MOE_MLA = ("dbrx-132b", "minicpm3-4b", "deepseek-v2-lite-16b")
TIGHT = {"attn_logit_softcap": 1.0, "final_logit_softcap": 2.0}
CASES = {**{a: (a, {}) for a in ARCHS + MOE_MLA}, "gemma2-2b-tight": ("gemma2-2b", TIGHT)}
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


def top_k(cfg):
    """The router's k of a MoE config (the tie rule's), else None."""
    return cfg.moe.top_k if cfg.moe else None


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
    """Record, in call order, in both packages: ("int8", x, int8 x, scales)
    of every int8 rounding (each quantized projection's activations and each
    int8 KV-cache row quantization) and ("router", probs) of every MoE
    router (the f32 softmax the top-k reads). An input quantized once for
    several weights (the MoE experts' shared input: the reference's
    ``vmap`` with the input unbatched, the port's ``quantize_input``) is one
    record in each. The reference's ``mla_prefill`` computes the latent a
    second time for the cache, the same values; that second rounding is
    not recorded (the port computes it once)."""
    ref, port = [], []
    jqmm, tqa = jops.quantized_matmul, ops.quantize_activation
    jrows, trows = jattn._quantize_rows, attention._quantize_rows
    jprefill, jlatent = jattn.mla_prefill, jattn._mla_latent
    jmoe, tmoe = jmlp.moe_forward, mlp.moe_forward
    latents = {"n": None}          # latent computations inside a reference mla_prefill

    def ref_put(kind, *a):
        jax.debug.callback(lambda *t: ref.append((kind, *[np.asarray(v, np.float32)
                                                          for v in t])), *a, ordered=True)

    def ref_fn(x, w, *, impl="auto"):
        q = jops.quantize_activation(x, group_size=w.group_size)
        if latents["n"] != 2:
            ref_put("int8", x, q.qvalues, q.scales)
        return jqmm(x, w, impl=impl)

    def ref_prefill(*a, **kw):
        latents["n"] = 0
        try:
            return jprefill(*a, **kw)
        finally:
            latents["n"] = None

    def ref_latent(*a, **kw):
        if latents["n"] is not None:
            latents["n"] += 1
        try:
            return jlatent(*a, **kw)
        finally:
            if latents["n"] == 2:
                latents["n"] = 3

    def ref_moe(p, x, cfg):
        logits = jnp.einsum("bsd,ed->bse", x.astype(jnp.float32), p["router_w"])
        ref_put("router", jax.nn.softmax(logits, axis=-1))
        return jmoe(p, x, cfg)

    def port_quant(x, group_size):
        q = tqa(x, group_size=group_size)
        port.append(("int8", *[t.float().numpy().copy() for t in (x, q.qvalues, q.scales)]))
        return q

    def port_moe(p, x, cfg, **kw):
        probs = torch.softmax(mlp._router_logits(x, p["router_w"]), dim=-1)
        port.append(("router", probs.numpy().copy()))
        return tmoe(p, x, cfg, **kw)

    def ref_rows(t, fmt="int8"):
        q, sc = jrows(t, fmt)
        ref_put("int8", t, q, sc[..., None])
        return q, sc

    def port_rows(t, fmt="int8"):
        q, sc = trows(t, fmt)
        port.append(("int8", *[v.float().numpy().copy() for v in (t, q, sc[..., None])]))
        return q, sc

    jops.quantized_matmul, ops.quantize_activation = ref_fn, port_quant
    jattn._quantize_rows, attention._quantize_rows = ref_rows, port_rows
    jattn.mla_prefill, jattn._mla_latent = ref_prefill, ref_latent
    jmlp.moe_forward, mlp.moe_forward = ref_moe, port_moe
    try:
        yield ref, port
    finally:
        jops.quantized_matmul, ops.quantize_activation = jqmm, tqa
        jattn._quantize_rows, attention._quantize_rows = jrows, trows
        jattn.mla_prefill, jattn._mla_latent = jprefill, jlatent
        jmlp.moe_forward, mlp.moe_forward = jmoe, tmoe


def ratio(x, s):
    x = x.reshape(-1, x.shape[-1])
    s = s.reshape(x.shape[0], -1)
    s = np.repeat(s, x.shape[-1] // s.shape[-1], axis=-1)
    return x / np.where(s > 0, s, 1.0)          # a zero row (a pad) keeps scale 0


def router_margins(p0: np.ndarray, p1: np.ndarray, k: int) -> list[float] | None:
    """None where every row's top-k expert set is the same in both
    packages' router probabilities, else, for each row where it differs,
    the reference's gap between its k-th and (k+1)-th probability relative
    to the k-th."""
    p0, p1 = p0.reshape(-1, p0.shape[-1]), p1.reshape(-1, p1.shape[-1])
    i0, i1 = np.argsort(-p0, axis=-1)[:, :k], np.argsort(-p1, axis=-1)[:, :k]
    rows = [r for r in range(p0.shape[0]) if set(i0[r]) != set(i1[r])]
    if not rows:
        return None
    srt = -np.sort(-p0[rows], axis=-1)
    return ((srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]).tolist()


def first_flips(ref, port, top_k: int | None = None) -> tuple[str, list]:
    """The first recorded decision where the packages differ: ("int8",
    [(reference x/S, port x/S)] of every int8 value that differs in that
    rounding), ("router", the ``router_margins`` of its rows whose top-k
    set differs; ``top_k`` the config's k), or ("", [])."""
    for r, t in zip(ref, port):
        assert r[0] == t[0], (r[0], t[0])
        if r[0] == "router":
            margins = router_margins(r[1], t[1], top_k)
            if margins is not None:
                return "router", margins
            continue
        (_, x0, q0, s0), (_, x1, q1, s1) = r, t
        assert q0.shape == q1.shape
        diff = q0.reshape(-1, q0.shape[-1]) != q1.reshape(-1, q1.shape[-1])
        if diff.any():
            return "int8", list(zip(ratio(x0, s0)[diff].tolist(), ratio(x1, s1)[diff].tolist()))
    return "", []


def tie(a: float, b: float) -> bool:
    """a and b lie within TIE of the same .5 boundary."""
    edge = np.floor(a) + 0.5
    return max(abs(a - edge), abs(b - edge)) <= TIE * max(1.0, abs(a))


# a router choice may differ between the packages only where the
# reference's k-th and (k+1)-th probabilities lie this close (relative)
ROUTER_TIE = 1e-6


def traced(kind: str, flips: list) -> bool:
    """The first difference is a tie: .5 ties of int8 roundings, or router
    near ties within ROUTER_TIE."""
    if kind == "router":
        return all(m <= ROUTER_TIE for m in flips)
    return kind == "int8" and all(tie(a, b) for a, b in flips)


def hold(run, quantized: bool, kv_quant=None, top_k: int | None = None) -> None:
    """``run(held)`` makes both packages' calls and records comparisons; all
    must hold, or the run's first decision that differs must be a tie: a
    router near tie (a MoE config, ``top_k`` its k), or with int8 weights or
    an int8 KV cache int8 values on .5 ties (module docstring)."""
    held = Held(quantized)
    run(held)
    if not held.misses:
        return
    assert quantized or kv_quant or top_k, held.misses
    with recorded() as (ref, port):
        run(Held(quantized))
    assert len(ref) == len(port)
    kind, flips = first_flips(ref, port, top_k)
    assert flips, f"no int8 activation or router choice differs, yet {held.misses}"
    assert kind == "router" or quantized or kv_quant, (kind, flips[:4], held.misses)
    assert traced(kind, flips), (kind, flips[:4], held.misses)


def first_difference(jeng, teng, prompt: np.ndarray, want: np.ndarray,
                     extra: dict | None = None) -> dict:
    """Both engines' prefill and decode steps fed the reference's greedy
    tokens ``want`` (b, T), on each engine's own weights, every int8
    rounding and MoE router recorded: the first decision where the packages
    differ, as ``first_flips`` gives it ({"kind", "values"}). Where two
    greedy runs part, this finds what parted them. Through each registry
    ``Model``'s ``prefill`` and ``decode``, so any family; ``extra`` (numpy
    arrays by name, e.g. the encoder-decoder's ``frames``) joins the
    prefill batch."""
    cfg, jm, tm = jeng.cfg, jeng.model, teng.model
    p = prompt.shape[1]
    extra = extra or {}
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.as_tensor(v) for k, v in extra.items()}
    with recorded() as (ref, port):
        # traced here, inside the recorder (fresh functions: no cached trace)
        jpre = jax.jit(lambda prm, t: jm.prefill(prm, {"tokens": t, **jextra}, jeng.cache_len))
        jdec = jax.jit(lambda prm, t, c, pos: jm.decode(prm, t, c, pos))
        logits, cache = jpre(jeng.params, jnp.asarray(prompt, jnp.int32))
        for step in range(want.shape[1] - 1):
            logits, cache = jdec(jeng.params, jnp.asarray(want[:, step], jnp.int32), cache,
                                 jnp.int32(p + step))
        jax.block_until_ready(logits)
        with torch.inference_mode():
            _, tcache = tm.prefill(teng.params, {"tokens": torch.as_tensor(prompt), **textra},
                                   teng.cache_len)
            for step in range(want.shape[1] - 1):
                tm.decode(teng.params, torch.as_tensor(want[:, step]), tcache, p + step)
    kind, flips = first_flips(ref, port, top_k(cfg))
    return {"kind": kind, "values": flips[:8]}


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
SERVING_CASES = {**{a: (a, {}) for a in ARCHS + MOE_MLA if a != "gemma2-2b"},
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
