"""The port's MLA attention (``models/attention.py``: ``mla_forward``,
``mla_prefill``, ``mla_decode``, ``mla_decode_deferred``) against the
reference on the reduced minicpm3-4b (low-rank query) and
deepseek-v2-lite-16b (full query) configs, one layer's weights from
``bridge.init_params_numpy`` with random norm weights, f32 (atol 1e-4; the
latent cache 1e-3) and int8 (2e-3 * max|y|, under the int8 tie rule of
``tests/_torch_families.hold``); the MLA refusals, each with the
reference's exception and message; and the earlier configs' numpy draws,
held to their golden files' weight checksums.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_families import hold, tree_of  # noqa: E402
from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.core.tree import tree_index  # noqa: E402
from repro_torch.models import attention, registry, transformer  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")
T = 32                      # cache length
S = 20                      # prompt length
LENGTHS = np.array([20, 13, 17])


def _layer_attn(arch: str, quantized: bool, layer: int = 1):
    cfg, jcfg = registry.load_config(arch).reduced(), jreg.load_config(arch).reduced()
    tree = tree_of(arch)
    jp, tp = numpy_to_jax(tree), bridge.params_from_numpy(tree, "cpu")
    if quantized:
        jp, tp = jquantize_params(jp, jcfg.group_size), quantize_params(tp, cfg.group_size)
    jl = jax.tree.map(lambda a: a[layer], jp["layers"]["attn"])
    return cfg, jcfg, tree_index(tp["layers"]["attn"], layer), jl


def _x(cfg, s=S, seed=0):
    return np.random.default_rng(seed).normal(size=(3, s, cfg.d_model)).astype(np.float32)


def _close(held, got, want, what, atol=None):
    if atol is None:
        held.logits(got, want, what)
        return
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    if err > atol:
        held.misses.append(f"{what}: {err:.3e} > {atol:.1e}")


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "lengths"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_forward_and_prefill_match_reference(arch, quantized, ragged):
    """``mla_forward`` (with ``lengths`` where ragged) and ``mla_prefill``:
    the output and the padded latent cache (pad rows zeroed)."""
    cfg, jcfg, tp, jp = _layer_attn(arch, quantized)
    x = _x(cfg)
    jlen, tlen = ((jnp.asarray(LENGTHS), torch.as_tensor(LENGTHS)) if ragged
                  else (None, None))

    def run(held):
        jy = jattn.mla_forward(jp, jnp.asarray(x), jcfg, lengths=jlen)
        jy2, (jc, jr) = jattn.mla_prefill(jp, jnp.asarray(x), jcfg, T, lengths=jlen)
        with torch.inference_mode():
            ty = attention.mla_forward(tp, torch.as_tensor(x), cfg, lengths=tlen)
            ty2, (tc, tr) = attention.mla_prefill(tp, torch.as_tensor(x), cfg, T, lengths=tlen)
        _close(held, ty, jy, "forward")
        _close(held, ty2, jy2, "prefill")
        _close(held, tc, jc, "c_kv", 1e-3)
        _close(held, tr, jr, "k_rope", 1e-3)
        assert tuple(tc.shape) == (3, T, cfg.mla.kv_lora_rank)
        if ragged:
            assert not tc[1, LENGTHS[1]:].any() and not tr[2, LENGTHS[2]:].any()

    hold(run, quantized)


@pytest.mark.parametrize("pos_kind", ["scalar", "vector"])
@pytest.mark.parametrize("deferred", [False, True], ids=["decode", "deferred"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_decode_matches_reference(arch, quantized, deferred, pos_kind):
    """Three absorbed decode steps over a prefilled latent cache: ``mla_decode``
    (writes its rows, in place here) or ``mla_decode_deferred`` (returns
    them; committed here as the layer loop does), at a scalar position or
    per-row positions; y each step and the cache after the last. ``wukv``
    is dequantized to f32, never a GQMM."""
    cfg, jcfg, tp, jp = _layer_attn(arch, quantized)
    x = _x(cfg)
    vector = pos_kind == "vector"
    lens = LENGTHS if vector else np.full(3, S)

    def run(held):
        _, (jc, jr) = jattn.mla_prefill(jp, jnp.asarray(x), jcfg, T,
                                        lengths=jnp.asarray(lens) if vector else None)
        with torch.inference_mode():
            _, (tc, tr) = attention.mla_prefill(tp, torch.as_tensor(x), cfg, T,
                                                lengths=torch.as_tensor(lens) if vector else None)
        pos = lens.copy()
        for step in range(3):
            xs = _x(cfg, s=1, seed=10 + step)[:, 0]
            jpos = jnp.asarray(pos, jnp.int32) if vector else int(pos[0])
            tpos = torch.as_tensor(pos) if vector else int(pos[0])
            if deferred:
                jy, (jcn, jrn) = jattn.mla_decode_deferred(jp, jnp.asarray(xs), (jc, jr), jpos,
                                                           jcfg)
                jc = jattn.commit_layers_bt(jc[None], jcn[None], jpos)[0]
                jr = jattn.commit_layers_bt(jr[None], jrn[None], jpos)[0]
                with torch.inference_mode():
                    ty, (tcn, trn) = attention.mla_decode_deferred(
                        tp, torch.as_tensor(xs), (tc, tr), tpos, cfg)
                    attention.commit_layers_bt(tc[None], tcn[None], tpos)
                    attention.commit_layers_bt(tr[None], trn[None], tpos)
            else:
                jy, (jc, jr) = jattn.mla_decode(jp, jnp.asarray(xs), (jc, jr), jpos, jcfg)
                with torch.inference_mode():
                    ty, _ = attention.mla_decode(tp, torch.as_tensor(xs), (tc, tr), tpos, cfg)
            _close(held, ty, jy, f"step {step}")
            pos = pos + 1
        _close(held, tc, jc, "c_kv", 1e-3)
        _close(held, tr, jr, "k_rope", 1e-3)

    hold(run, quantized)


def test_mla_decode_runs_no_gqmm_on_wukv(monkeypatch):
    """int8 weights: a decode step runs wq, wdkv and wo as GQMMs (deepseek's
    full query) and dequantizes wukv; prefill runs wukv as a GQMM too."""
    from repro_torch.kernels import ops

    cfg, _, tp, _ = _layer_attn("deepseek-v2-lite-16b", True)
    calls = []
    qmm = ops.quantized_matmul
    monkeypatch.setattr(ops, "quantized_matmul",
                        lambda x, w, **kw: calls.append(tuple(w.shape)) or qmm(x, w, **kw))
    x = torch.as_tensor(_x(cfg))
    with torch.inference_mode():
        _, cache = attention.mla_prefill(tp, x, cfg, T)
        prefill, calls[:] = list(calls), []
        attention.mla_decode(tp, x[:, 0], cache, S, cfg)
    wukv = tuple(tp["wukv"].shape)
    assert prefill.count(wukv) == 1 and len(prefill) == 4
    assert wukv not in calls and len(calls) == 3


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_refusals_match_reference(arch):
    """A paged cache, verify, generate(paged=True), spec_k and kv_quant raise
    the reference's exception with its message; the model declares no
    paged or verify hook."""
    cfg, jcfg = registry.load_config(arch).reduced(), jreg.load_config(arch).reduced()
    tree = tree_of(arch)
    jeng = JEngine(jreg.build(jcfg), numpy_to_jax(tree), cache_len=16)
    teng = InferenceEngine(registry.build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=16, device="cpu")
    toks = np.ones((2, 4), np.int64)
    pairs = [
        (lambda: jtf.lm_init_paged_cache(jcfg, 4, 8, jnp.float32),
         lambda: transformer.lm_init_paged_cache(cfg, 4, 8, torch.float32, "cpu")),
        (lambda: jtf.lm_verify(None, jnp.ones((2, 3), jnp.int32), None, 0, jcfg),
         lambda: transformer.lm_verify(
             None, torch.ones((2, 3), dtype=torch.long),
             transformer.lm_init_cache(cfg, 2, 16, torch.float32, "cpu"), 0, cfg)),
        (lambda: jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 2, paged=True),
         lambda: teng.generate({"tokens": torch.as_tensor(toks)}, 2, paged=True)),
        (lambda: jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 2, spec_k=2),
         lambda: teng.generate({"tokens": torch.as_tensor(toks)}, 2, spec_k=2)),
        (lambda: JEngine(jreg.build(jcfg), numpy_to_jax(tree), cache_len=16, kv_quant="int8"),
         lambda: InferenceEngine(registry.build(cfg), bridge.params_from_numpy(tree, "cpu"),
                                 cache_len=16, device="cpu", kv_quant="int8")),
    ]
    for ref, port in pairs:
        want, got = _raised(ref), _raised(port)
        assert got[0] is want[0] is ValueError
        assert got[1].split(" (")[0] == want[1].split(" (")[0] or got[1] == want[1], (got, want)
    model = registry.build(cfg)
    assert not model.supports_paged and not model.supports_spec
    for hook in ("init_paged_cache", "decode_paged", "verify", "commit_verify", "verify_paged",
                 "commit_verify_paged"):
        assert getattr(model, hook) is None and getattr(jreg.build(jcfg), hook) is None, hook


# ---------------------------------------------------------------------------
# the earlier configs' numpy draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("golden", ["golden_tinyllama.json"])
def test_numpy_draws_of_earlier_configs_unchanged(golden):
    """``init_params_numpy`` draws the dense GQA configs' leaves as it
    always did (the MoE and MLA branches are drawn where they enter, large
    leaves in slices): the golden file's weight checksum, at the golden's
    depth, f32. (The family goldens' full-width draws take 20-30 s each
    here; ``chip_smoke.py`` checks every golden's checksum on each run.)"""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    data = json.loads((ROOT / "src" / "repro_torch" / golden).read_text())
    if "arch" in data and data["arch"] != cs.GOLDEN["arch"]:
        cfg, seed = cs.family_golden_config(data["arch"]), cs.FAMILY_GOLDEN["seed"]
    else:
        cfg, seed = cs.golden_config(), cs.GOLDEN["seed"]
    assert cs.weights_checksum(bridge.init_params_numpy(cfg, seed)) == data["weights_checksum"]


def test_mla_cache_layout_and_flags():
    """The MLA cache is the latent layout whatever the KV flags, and batch
    sits on axis 1 of both leaves (the serving core's slot hooks)."""
    from repro_torch.core import flags

    cfg = registry.load_config("minicpm3-4b").reduced()
    for kw in ({}, {"kvt_cache_layout": True}, {"int8_kv_cache": True}):
        with flags.overrides(**kw):
            cache = transformer.lm_init_cache(cfg, 3, T, torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            "ckv": (cfg.num_layers, 3, T, cfg.mla.kv_lora_rank),
            "krope": (cfg.num_layers, 3, T, cfg.mla.qk_rope_dim)}
    rows = transformer.lm_gather_slots(cache, torch.tensor([2, 0]))
    assert rows["ckv"].shape[1] == 2
