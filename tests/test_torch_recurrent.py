"""The recurrent families in the port's model code (``models/rwkv.py``,
``models/ssm.py``, ``models/zamba.py``) against the reference on their
reduced configs, with weights from one ``bridge.init_params_numpy`` draw
(random norm weights): rwkv6 at 2 layers; zamba2 at 2 layers (one group of
two Mamba2 layers and the shared block, no tail) and at 3 through
``dataclasses.replace`` in both packages (one group and a tail layer).

- ``forward``, ``prefill`` and four ``decode`` steps, logits and every
  state leaf, with f32 and int8 weights; zamba2's decode plain, deferred,
  kvt and under ``int8_kv_cache`` (f32 weights; plain and int8-KV with
  int8 weights too). The reference's own prefill under ``int8_kv_cache``
  alone returns a layout its decode cannot read (ROADMAP Queue C), so the
  reference runs that case with the kvt flag too: the same values;
- both SSD scan forms (s 32, chunk 8), entered in both packages through
  ``tests/_torch_helpers.both_flags``, and each against the other;
- the bf16 causal conv's tap sums bit for bit, ``softplus`` past 20;
- ``insert_slots`` / ``gather_slots`` against the reference's, round trip;
- the parameter trees and the weight policy in all six weight settings on
  the full configs (JAX abstract arrays against torch meta tensors), the
  4-D (groups, per, out, in) leaves quantized slice by slice;
- ``InferenceEngine.unbounded_state`` against the reference's.

Tolerances are the families' (``tests/_torch_families.py``): f32 logits
atol 1e-4, states atol 1e-3; int8 2e-3 * max|logit|, and a miss holds only
if the first int8 rounding that differs between the packages lies on a .5
tie (``hold``). The recurrence sums in other orders than the reference's
scan (its per-step einsums), within f32 rounding.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_families import hold  # noqa: E402
from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.core import flags as jflags  # noqa: E402
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.core.quant import QuantizedTensor as JQT  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import flags as tflags  # noqa: E402
from repro_torch.core.policy import _quantize_stacked, quantize_params  # noqa: E402
from repro_torch.core.quant import QuantizedTensor, get_format  # noqa: E402
from repro_torch.core.tree import tree_index  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CASES = {"rwkv6-7b": ("rwkv6-7b", 2), "zamba2-7b": ("zamba2-7b", 2),
         "zamba2-7b-tail": ("zamba2-7b", 3)}
SETTINGS = ("int8", "int4", "int3", "fp8", "mixed", "mixed3")
PROMPT, CACHE_LEN, STEPS = 20, 32, 4
# the decode variants of zamba2's shared cache: the port's flags, and the
# reference's (int8_kv_cache alone breaks the reference's prefill layout)
DECODE = {"plain": ({}, {}),
          "deferred": ({"deferred_decode_cache": True}, {"deferred_decode_cache": True}),
          "kvt": ({"kvt_cache_layout": True}, {"kvt_cache_layout": True}),
          "int8_kv": ({"int8_kv_cache": True},
                      {"int8_kv_cache": True, "kvt_cache_layout": True})}


def configs(case: str):
    arch, layers = CASES[case]
    return (dataclasses.replace(registry.load_config(arch).reduced(), num_layers=layers),
            dataclasses.replace(jreg.load_config(arch).reduced(), num_layers=layers))


@functools.lru_cache(maxsize=None)
def tree_of(case: str):
    return bridge.init_params_numpy(configs(case)[0], seed=7, norm_scale=0.1)


def setup(case: str, quantized: bool):
    cfg, jcfg = configs(case)
    jp, tp = numpy_to_jax(tree_of(case)), bridge.params_from_numpy(tree_of(case), "cpu")
    if quantized:
        jp, tp = jquantize_params(jp, jcfg.group_size), quantize_params(tp, cfg.group_size)
    return cfg, jcfg, tp, jp


def flat(tree, prefix=""):
    """A nested dict's leaves under '/'-joined keys."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _tokens(cfg, b=3, s=PROMPT + STEPS, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s))


# every decode variant with f32 weights, the plain and int8-KV ones with
# int8 weights too
MODEL_CASES = ([("rwkv6-7b", q, "plain") for q in (False, True)]
               + [("zamba2-7b", q, "plain") for q in (False, True)]
               + [("zamba2-7b-tail", False, v) for v in DECODE]
               + [("zamba2-7b-tail", True, v) for v in ("plain", "int8_kv")])


@pytest.mark.parametrize("case,quantized,variant", MODEL_CASES)
def test_forward_prefill_decode_match_reference(case, quantized, variant):
    """The scoring forward over 24 tokens (in the plain variant: the decode
    flags do not reach it), a 20-token prefill and four decode steps on the
    next tokens: logits and every state leaf."""
    cfg, jcfg, tp, jp = setup(case, quantized)
    model, jmodel = registry.build(cfg), jreg.build(jcfg)
    toks = _tokens(cfg)
    tkw, jkw = DECODE[variant]

    def run(held):
        # jitted anew each run (fresh functions trace again), so that the
        # tie rule's recorder sees the reference's roundings
        jfwd = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t}))
        jpre = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, CACHE_LEN))
        jdec = jax.jit(lambda p, t, c, pos: jmodel.decode(p, t, c, pos))
        if variant == "plain":
            with torch.inference_mode():
                held.logits(model.forward(tp, {"tokens": torch.as_tensor(toks)}),
                            jfwd(jp, jnp.asarray(toks)), "forward")
        with jflags.overrides(**jkw):
            jl, jc = jpre(jp, jnp.asarray(toks[:, :PROMPT]))
            jsteps = []
            for i in range(STEPS):
                jlog, jc = jdec(jp, jnp.asarray(toks[:, PROMPT + i]), jc, PROMPT + i)
                jsteps.append(jlog)
        with tflags.overrides(**tkw), torch.inference_mode():
            tl, tc = model.prefill(tp, {"tokens": torch.as_tensor(toks[:, :PROMPT])}, CACHE_LEN)
            held.logits(tl, jl, "prefill")
            for i in range(STEPS):
                tlog, tc = model.decode(tp, torch.as_tensor(toks[:, PROMPT + i]), tc, PROMPT + i)
                held.logits(tlog, jsteps[i], f"decode {i}")
        held.cache(flat(tc), flat(jax.tree.map(np.asarray, jc)))

    hold(run, quantized)


def test_int8_kv_cache_shared_rows_stay_float_and_kvt():
    """Under ``int8_kv_cache`` zamba2's shared cache is the kvt layout in
    floats, from ``init_cache`` and from prefill alike."""
    cfg, _, tp, _ = setup("zamba2-7b-tail", False)
    model = registry.build(cfg)
    with tflags.overrides(int8_kv_cache=True), torch.inference_mode():
        init = model.init_cache(3, CACHE_LEN, torch.float32, "cpu")
        _, cache = model.prefill(tp, {"tokens": torch.as_tensor(_tokens(cfg)[:, :PROMPT])},
                                 CACHE_LEN)
    for c in (init, cache):
        assert c["shared_k"].dtype == torch.float32
        assert tuple(c["shared_k"].shape) == (1, 3, cfg.num_kv_heads, CACHE_LEN, 32)
    assert cache["shared_k"][:, :, :, PROMPT:].abs().max() == 0


@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_ssd_scan_forms_match_reference(form):
    """One Mamba2 layer over 32 positions, from a given (conv, h) state:
    the sequential scan, and the chunked one (chunk 8) under both packages'
    flags: y and the final state against the reference's, and the chunked
    form against the port's own sequential one."""
    cfg, jcfg, tp, jp = setup("zamba2-7b", False)
    lp = tree_index(tree_index(tp["mamba_layers"], 0), 1)["mamba"]
    jl = jax.tree.map(lambda a: a[0, 1], jp["mamba_layers"])["mamba"]
    rng = np.random.default_rng(3)
    _, nheads, conv_ch = ssm.ssm_dims(cfg)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, 3, conv_ch)).astype(np.float32)
    h0 = rng.normal(size=(2, nheads, 16, 16)).astype(np.float32)
    kw = {"chunked_ssd": form == "chunked", "ssd_chunk": 8}
    with both_flags(**kw):
        jy, (jconv, jh) = jax.jit(lambda p, x_, st: jssm.mamba2_forward(p, x_, jcfg, st))(
            jl, jnp.asarray(x), (jnp.asarray(conv), jnp.asarray(h0)))
        with torch.inference_mode():
            ty, (tconv, th) = ssm.mamba2_forward(
                lp, torch.as_tensor(x), cfg, (torch.as_tensor(conv), torch.as_tensor(h0)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(jconv), atol=1e-5, rtol=0)
    with torch.inference_mode():
        sy, (_, sh) = ssm.mamba2_forward(lp, torch.as_tensor(x), cfg,
                                         (torch.as_tensor(conv), torch.as_tensor(h0)))
    np.testing.assert_allclose(ty.numpy(), sy.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(th.numpy(), sh.numpy(), atol=1e-4, rtol=0)


def test_causal_conv_tap_sums_and_softplus():
    """The conv's tap sums equal the reference's bit for bit at bf16 (its
    Python sum, tap order, each add rounding) and f32, the new tail too;
    ``softplus`` is ``logaddexp(x, 0)`` past ``F.softplus``'s threshold."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 40)).astype(np.float32)
    w = (rng.normal(size=(4, 40)) * 0.1).astype(np.float32)
    tail = rng.normal(size=(2, 3, 40)).astype(np.float32)
    ident = (lambda t: t, lambda t: t)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        orig_j, orig_t = jax.nn.silu, torch.nn.functional.silu
        jax.nn.silu, torch.nn.functional.silu = ident
        try:
            jo, jt = jssm._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                       jnp.asarray(tail, jdt))
            to, tt = ssm._causal_conv(torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt),
                                      torch.as_tensor(tail).to(tdt))
        finally:
            jax.nn.silu, torch.nn.functional.silu = orig_j, orig_t
        np.testing.assert_array_equal(to.float().numpy(), np.asarray(jo.astype(jnp.float32)))
        np.testing.assert_array_equal(tt.float().numpy(), np.asarray(jt.astype(jnp.float32)))
    v = np.array([-50, -1, 0, 1e-3, 3, 19.9, 20.1, 30, 80], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.as_tensor(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["rwkv6-7b", "zamba2-7b-tail"])
def test_insert_and_gather_slots_match_reference(case):
    """A 2-row prefill's state scattered into slots (3, 1) of a 4-slot
    cache, in place, equals the reference's ``insert_slots``; gathering
    those slots gives the rows back."""
    cfg, jcfg, tp, jp = setup(case, False)
    model, jmodel = registry.build(cfg), jreg.build(jcfg)
    toks = _tokens(cfg, b=2, s=8)
    jl, jrows = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, CACHE_LEN))(
        jp, jnp.asarray(toks))
    big = jmodel.init_cache(4, CACHE_LEN, jnp.float32)
    big = jax.tree.map(lambda a: a + 1.0, big)
    jbig = jmodel.insert_slots(big, jrows, jnp.asarray([3, 1]))
    with torch.inference_mode():
        _, rows = model.prefill(tp, {"tokens": torch.as_tensor(toks)}, CACHE_LEN)
        cache = model.init_cache(4, CACHE_LEN, torch.float32, "cpu")
        for leaf in flat(cache).values():
            leaf.add_(1.0)
        out = model.insert_slots(cache, rows, torch.tensor([3, 1]))
        back = model.gather_slots(cache, torch.tensor([3, 1]))
    assert out is cache
    want = flat(jax.tree.map(np.asarray, jbig))
    got = flat(cache)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)
    for k, v in flat(rows).items():
        assert torch.equal(flat(back)[k], v), k
    jback = flat(jax.tree.map(np.asarray, jmodel.gather_slots(jbig, jnp.asarray([3, 1]))))
    for k in jback:
        np.testing.assert_allclose(flat(back)[k].numpy(), jback[k], atol=1e-5, rtol=0)


def _abstract_ref(arch: str):
    """The reference's init tree of the full-width config as abstract
    arrays: rwkv6 at 2 layers, zamba2 at 7 (a group of 6 and a tail)."""
    layers = 7 if arch == "zamba2-7b" else 2
    jcfg = dataclasses.replace(jreg.load_config(arch), num_layers=layers)
    return jax.eval_shape(jreg.build(jcfg).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_param_trees_match_reference(arch):
    """``init_params_numpy`` and the port's ``init`` draw the reference's
    tree on the reduced configs: the same keys, shapes and dtypes (at bf16
    parameters too: the scan parameters stay f32)."""
    for case in [c for c, (a, _) in CASES.items() if a == arch]:
        cfg, jcfg = configs(case)
        for dt in ("float32", "bfloat16"):
            ref = jax.eval_shape(jreg.build(dataclasses.replace(jcfg, param_dtype=dt)).init,
                                 jax.random.PRNGKey(0))
            want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat(ref).items()}
            params = registry.build(dataclasses.replace(cfg, param_dtype=dt)).init(
                seed=1, device="cpu")
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in flat(params).items()} == want, (case, dt)
        got = {k: (v.shape, v.dtype.name) for k, v in flat(tree_of(case)).items()}
        assert got == {k: (s_, "float32") for k, (s_, _) in want.items()}, case


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_policy_formats_and_group_sizes_match_reference_full_size(arch):
    """Every leaf of the full config's tree gets the reference's format and
    group size (or stays float) in all six weight settings: rwkv6's decay
    LoRA, ``bonus_u``, mixes and norms float; zamba2's ``conv_w``, scan
    parameters and norms float, its 4-D (groups, per, out, in) ``win`` and
    ``wout`` quantized. The reference on abstract arrays, the port on meta
    tensors."""
    cfg = registry.load_config(arch)
    ref = _abstract_ref(arch)
    meta = jax.tree.map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"), ref)
    for setting in SETTINGS:
        jq = flat(jax.eval_shape(lambda p: jquantize_params(p, cfg.group_size, formats=setting),
                                 ref))
        tq = flat(quantize_params(meta, cfg.group_size, formats=setting))
        assert set(jq) == set(tq), setting
        for path, leaf in tq.items():
            want = jq[path]
            if isinstance(want, JQT):
                assert isinstance(leaf, QuantizedTensor), (setting, path)
                assert (leaf.fmt, leaf.group_size) == (want.fmt, want.group_size), (setting, path)
                assert tuple(leaf.qvalues.shape) == tuple(want.qvalues.shape), (setting, path)
                assert tuple(leaf.scales.shape) == tuple(want.scales.shape), (setting, path)
            else:
                assert not isinstance(leaf, QuantizedTensor), (setting, path)
    q8 = flat(quantize_params(meta, cfg.group_size))
    floats = ([k for k in q8 if any(p in k for p in ("decay", "bonus", "mix", "norm"))]
              if arch == "rwkv6-7b" else
              [k for k in q8 if any(p in k for p in ("conv_w", "a_log", "dt_bias", "d_skip",
                                                     "norm"))])
    assert floats and not any(isinstance(q8[k], QuantizedTensor) for k in floats)
    if arch == "zamba2-7b":
        assert q8["mamba_layers/mamba/win"].qvalues.shape[:2] == (1, 6)
        assert q8["tail_layers/mamba/wout"].scales.shape == (1, 3584, 7168 // 256)


def test_stacked_4d_leaf_quantizes_slice_by_slice():
    """``_quantize_stacked`` on a (groups, per, out, in) leaf equals each
    (out, in) slice's own quantization, in every format."""
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(2, 3, 8, 64)).astype(np.float32))
    for fmt in ("int8", "int4", "int3", "fp8"):
        q = _quantize_stacked(get_format(fmt), x, 32)
        assert tuple(q.shape) == (2, 3, 8, 64)
        for g in range(2):
            for j in range(3):
                one = get_format(fmt).quantize(x[g, j], 32)
                assert torch.equal(q.qvalues[g, j].view(torch.uint8),
                                   one.qvalues.view(torch.uint8)), fmt
                assert torch.equal(q.scales[g, j], one.scales), fmt


@pytest.mark.parametrize("case", ["rwkv6-7b", "zamba2-7b"])
def test_unbounded_state_matches_reference(case):
    """rwkv6's state does not grow with cache_len (unbounded), zamba2's
    shared KV rows do; probed on the meta device, as the reference probes
    abstractly."""
    cfg, jcfg, tp, jp = setup(case, False)
    teng = InferenceEngine(registry.build(cfg), tp, cache_len=8, device="cpu")
    jeng = JEngine(jreg.build(jcfg), jp, cache_len=8)
    assert teng.unbounded_state is jeng.unbounded_state is (case == "rwkv6-7b")
    tiny = dataclasses.replace(registry.load_config("tinyllama-1.1b").reduced(), num_layers=1)
    assert not InferenceEngine(registry.build(tiny), bridge.params_from_numpy(
        bridge.init_params_numpy(tiny, seed=0), "cpu"), cache_len=8, device="cpu").unbounded_state
