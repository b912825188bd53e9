"""seamless-m4t-large-v2, the encoder-decoder (``models/encdec.py``),
against the reference's ``repro/models/encdec.py`` on the reduced config
(2 + 2 layers, d 128, 4 query / 2 KV heads, hd 32, vocab 512), weights from
one ``bridge.init_params_numpy`` draw with random norm weights, through
both packages on the CPU:

- ``encode``, ``cross_kv`` and ``cross_attend``, ``Model.forward``, prefill
  (logits and the four cache leaves {k, v, cross_k, cross_v}) and one
  decode step, with f32 weights within rtol 1e-5 (atol 1e-5 x max|ref|),
  plain and under ``blockwise_attention`` (the encoder's non-causal flash
  call); int8 weights by the families' rule (``_torch_families.hold``:
  2e-3 x max|logit|, else the first int8 rounding in which the packages
  differ must be a .5 tie), also under ``blockwise_attention``, and under
  ``prefill_dequant`` (no activation is quantized there: rtol 1e-5);
- prefill against decode, the reference's ``test_encdec_decode_consistency``
  on the port, at the reference's smoke batch (frames drawn after tokens);
- the parameter trees (``init``, ``init_params_numpy``) and the weight
  policy on the full config against the reference's;
- the refusals: the kvt and int8 KV-cache flags beside the reference's own
  failures, ragged lengths, missing frames, a cross cache of another
  length than the frames.
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
from repro.core.policy import quantize_params as jquantize_params  # noqa: E402
from repro.core.quant import QuantizedTensor as JQT  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import quantize_params  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.tree import tree_index  # noqa: E402
from repro_torch.models import encdec, registry  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S_ENC, S_DEC, CACHE_LEN = 3, 10, 12, 20
SETTINGS = ("int8", "int4", "int3", "fp8", "mixed", "mixed3")
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _tree():
    return bridge.init_params_numpy(registry.load_config(ARCH).reduced(), seed=11,
                                    norm_scale=0.1)


def setup(quantized: bool):
    cfg, jcfg = registry.load_config(ARCH).reduced(), jreg.load_config(ARCH).reduced()
    jp, tp = numpy_to_jax(_tree()), bridge.params_from_numpy(_tree(), "cpu")
    if quantized:
        jp, tp = jquantize_params(jp, jcfg.group_size), quantize_params(tp, cfg.group_size)
    return cfg, jcfg, tp, jp


def inputs(cfg, b=B, s_enc=S_ENC, s_dec=S_DEC, seed=0):
    """(reference batch, port batch): decoder tokens, then N(0, 1) frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s_dec))
    frames = rng.normal(size=(b, s_enc, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks, jnp.int32), "frames": jnp.asarray(frames)},
            {"tokens": torch.as_tensor(toks), "frames": torch.as_tensor(frames)})


def close(got, want, what=""):
    """f32 parity: rtol 1e-5, atol 1e-5 x max|ref|."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("blockwise", [False, True])
def test_encode_cross_kv_and_cross_attend_match_reference(blockwise):
    cfg, jcfg, tp, jp = setup(False)
    jb, tb = inputs(cfg)
    with both_flags(blockwise_attention=blockwise), torch.inference_mode():
        jmem = jencdec.encode(jp, jb["frames"], jcfg, remat=False)
        tmem = encdec.encode(tp, tb["frames"], cfg)
        close(tmem, jmem, "encode")
        jlp = jax.tree.map(lambda a: a[1], jp["dec_layers"])
        tlp = tree_index(tp["dec_layers"], 1)
        jk, jv = jencdec.cross_kv(jlp["cross"], jmem, jcfg)
        tk, tv = encdec.cross_kv(tlp["cross"], tmem, cfg)
        close(tk, jk, "cross k")
        close(tv, jv, "cross v")
        x = np.random.default_rng(3).normal(size=(B, 5, cfg.d_model)).astype(np.float32)
        close(encdec.cross_attend(tlp["cross"], torch.as_tensor(x), tk, tv, cfg),
              jencdec.cross_attend(jlp["cross"], jnp.asarray(x), jk, jv, jcfg), "cross attend")


# (weights, flags): f32 plain and blockwise; int8 plain, blockwise, and
# under prefill_dequant (every product a float one: f32 parity)
CASES = {"f32": (False, {}), "f32-blockwise": (False, {"blockwise_attention": True}),
         "int8": (True, {}), "int8-blockwise": (True, {"blockwise_attention": True}),
         "int8-prefill_dequant": (True, {"prefill_dequant": True})}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_decode_match_reference(case):
    """Model.forward, prefill (the last position's logits and all four
    cache leaves) and one decode step from that cache."""
    quantized, flag_kw = CASES[case]
    cfg, jcfg, tp, jp = setup(quantized)
    jm, tm = jreg.build(jcfg), registry.build(cfg)
    jb, tb = inputs(cfg)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(B,))
    float_parity = not quantized or "prefill_dequant" in flag_kw

    def run(held):
        with both_flags(**flag_kw), torch.inference_mode():
            got = {"forward": tm.forward(tp, tb)}
            want = {"forward": jm.forward(jp, jb, remat=False)}
            want["prefill"], jc = jm.prefill(jp, jb, CACHE_LEN)
            got["prefill"], tc = tm.prefill(tp, tb, CACHE_LEN)
            assert {k: tuple(v.shape) for k, v in tc.items()} == {
                k: tuple(v.shape) for k, v in jc.items()}
            assert tc["cross_k"].shape[2] == S_ENC and tc["k"].shape[2] == CACHE_LEN
            if float_parity:
                for k in jc:
                    close(tc[k], jc[k], f"prefill cache {k}")
            else:
                held.cache(tc, jc)
            want["decode"], jc2 = jm.decode(jp, jnp.asarray(tok, jnp.int32), jc,
                                            jnp.int32(S_DEC))
            got["decode"], tc2 = tm.decode(tp, torch.as_tensor(tok), tc, S_DEC)
            assert tc2 is tc                                # written in place
            for name in want:
                if float_parity:
                    close(got[name], want[name], name)
                else:
                    held.logits(got[name], want[name], name)
            if float_parity:
                close(tc2["k"], jc2["k"], "decode cache k")
            else:
                held.cache(tc2, jc2)

    if float_parity:
        run(None)
    else:
        hold(run, quantized)


def test_smoke_batch_and_prefill_decode_consistency():
    """The port's smoke_batch is the reference's (frames drawn after the
    tokens); the reference's test_encdec_decode_consistency on the port:
    prefill on 7 decoder tokens gives forward's logits at position 6, and
    decoding the 8th forward's at 7 (f32: atol 1e-4 x max|logit|, where the
    reference's own test allows 2e-2)."""
    cfg, jcfg = registry.load_config(ARCH).reduced(), jreg.load_config(ARCH).reduced()
    got, want = registry.smoke_batch(cfg, batch=1, seq=8), jreg.smoke_batch(jcfg, batch=1, seq=8)
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    tm = registry.build(cfg)
    params = tm.init(seed=3, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in got.items()}
    with torch.inference_mode():
        full = tm.forward(params, batch)
        logits_p, cache = tm.prefill(params, {"frames": batch["frames"],
                                              "tokens": batch["tokens"][:, :7]}, 8)
        logits_d, _ = tm.decode(params, batch["tokens"][:, 7], cache, 7)
    tol = 1e-4 * full.abs().max().item()
    assert (logits_p - full[:, 6]).abs().max().item() <= tol
    assert (logits_d - full[:, 7]).abs().max().item() <= tol


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_param_trees_match_reference():
    """``init`` (f32 and bf16 parameters) and ``init_params_numpy`` draw the
    reference's tree: the same keys, shapes and dtypes."""
    cfg, jcfg = registry.load_config(ARCH).reduced(), jreg.load_config(ARCH).reduced()
    for dt in ("float32", "bfloat16"):
        ref = jax.eval_shape(jreg.build(dataclasses.replace(jcfg, param_dtype=dt)).init,
                             jax.random.PRNGKey(0))
        want = {k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in flat(ref).items()}
        params = registry.build(dataclasses.replace(cfg, param_dtype=dt)).init(seed=1,
                                                                               device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in flat(params).items()} == want, dt
    got = {k: (v.shape, v.dtype.name) for k, v in flat(_tree()).items()}
    assert got == {k: (s, "float32") for k, (s, _) in want.items()}


def test_policy_formats_match_reference_full_width():
    """Every leaf of the full-width tree (2 + 2 layers) gets the reference's
    format and group size, or stays float, in all six weight settings: the
    encoder's and decoder's projections, the cross attention's and the
    classifier quantized; norms float. The reference on abstract arrays,
    the port on meta tensors."""
    jcfg = dataclasses.replace(jreg.load_config(ARCH), num_layers=2, encoder_layers=2)
    ref = jax.eval_shape(jreg.build(jcfg).init, jax.random.PRNGKey(0))
    meta = jax.tree.map(lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"), ref)
    for setting in SETTINGS:
        jq = flat(jax.eval_shape(lambda p: jquantize_params(p, jcfg.group_size,
                                                            formats=setting), ref))
        tq = flat(quantize_params(meta, jcfg.group_size, formats=setting))
        assert set(jq) == set(tq), setting
        for path, leaf in tq.items():
            want = jq[path]
            if isinstance(want, JQT):
                assert isinstance(leaf, QuantizedTensor), (setting, path)
                assert (leaf.fmt, leaf.group_size) == (want.fmt, want.group_size), (setting, path)
                assert tuple(leaf.qvalues.shape) == tuple(want.qvalues.shape), (setting, path)
            else:
                assert not isinstance(leaf, QuantizedTensor), (setting, path)
    q8 = flat(quantize_params(meta, jcfg.group_size))
    assert isinstance(q8["dec_layers/cross/wkv"], QuantizedTensor)
    assert q8["classifier"].qvalues.shape == (256224, 1024)
    assert not any(isinstance(v, QuantizedTensor) for k, v in q8.items() if k.endswith("norm"))


@pytest.mark.parametrize("flag", ["kvt_cache_layout", "int8_kv_cache"])
def test_kv_cache_flags_refused_where_the_reference_fails(flag):
    """Under kvt_cache_layout the reference's prefill writes the kvt self
    cache and its decode (the plain gqa_decode) fails to read it; under
    int8_kv_cache its prefill fails to unpack gqa_prefill's four leaves.
    The port's prefill refuses both, naming the failure."""
    cfg, jcfg, tp, jp = setup(False)
    jm, tm = jreg.build(jcfg), registry.build(cfg)
    jb, tb = inputs(cfg)
    with both_flags(**{flag: True}):
        with pytest.raises(NotImplementedError, match="reference's encdec_prefill"):
            tm.prefill(tp, tb, CACHE_LEN)
        if flag == "int8_kv_cache":
            with pytest.raises(ValueError, match="too many values to unpack"):
                jm.prefill(jp, jb, CACHE_LEN)
        else:
            _, jc = jm.prefill(jp, jb, CACHE_LEN)
            assert jc["k"].shape[2:4] == (cfg.num_kv_heads, CACHE_LEN)     # kvt
            with pytest.raises(TypeError, match="reshape"):
                jm.decode(jp, jnp.zeros((B,), jnp.int32), jc, jnp.int32(S_DEC))


def test_prefill_refuses_lengths_missing_frames_and_another_memory_length():
    cfg, jcfg, tp, jp = setup(False)
    jm, tm = jreg.build(jcfg), registry.build(cfg)
    jb, tb = inputs(cfg)
    with pytest.raises(ValueError, match="does not support ragged lengths"):
        tm.prefill(tp, {**tb, "lengths": torch.full((B,), S_DEC)}, CACHE_LEN)
    with pytest.raises(KeyError, match="frames"):
        jm.prefill(jp, {"tokens": jb["tokens"]}, CACHE_LEN)
    with pytest.raises(KeyError, match="frames"):
        tm.prefill(tp, {"tokens": tb["tokens"]}, CACHE_LEN)
    with pytest.raises(KeyError, match="frames"):
        tm.forward(tp, {"tokens": tb["tokens"]})
    # a cache of the reference's default memory length: cross attention
    # would attend to its zero rows
    cache = tm.init_cache(B, CACHE_LEN, torch.float32, "cpu")
    assert cache["cross_k"].shape[2] == encdec.DEFAULT_MEMORY_LEN == jencdec.DEFAULT_MEMORY_LEN
    with pytest.raises(ValueError, match="memory rows"):
        tm.prefill(tp, tb, CACHE_LEN, cache=cache)
    right = tm.init_cache(B, CACHE_LEN, torch.float32, "cpu", memory_len=S_ENC)
    logits, out = tm.prefill(tp, tb, CACHE_LEN, cache=right)
    assert out is right
    close(logits, jm.prefill(jp, jb, CACHE_LEN)[0], "prefill into a given cache")
