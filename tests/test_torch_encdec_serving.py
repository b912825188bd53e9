"""seamless-m4t-large-v2 on the port's serving paths against the
reference, reduced config (2 + 2 layers, d 128), weights from one
``bridge.init_params_numpy`` draw with random norm weights:

- ``generate`` (3 prompts of 12 decoder tokens, 10 frames each, 10 greedy
  tokens): f32 weights give the reference's tokens and its final logits
  within 1e-4; int8, int4, int3, fp8, mixed and mixed3 weights its tokens,
  or parted only where the first int8 rounding in which the packages differ
  along the reference's tokens is a .5 tie (``_torch_families``); the same
  under ``blockwise_attention`` and ``prefill_dequant``;
- the signature's static cache holds exactly the frames' rows of cross K/V,
  and a cross cache of the reference's 4096-row default, the prefill's rows
  written and the rest zero, gives the reference's decode another result
  (its zero keys take softmax weight), which is why it is sized so;
- the captured programs run eagerly on the CPU: ``generate`` equals a
  prefill + ``decode_step`` loop and builds one program a signature;
- the refusals beside the reference's: a paged cache, ``spec_k``, ragged
  ``lengths=``, ``kv_quant``, continuous batching, the model drafter and the
  serving modes with the reference's exception and words; ``serve_ragged``
  (bucketed) where the reference fails with ``KeyError: 'frames'``;
- the serve CLI (``generate`` with frames; ``--ragged`` exits).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_families import first_difference, traced  # noqa: E402
from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import spec as jspec  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec, registry  # noqa: E402
from repro_torch.serving import batching, spec  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S_ENC, PROMPT, NEW, CACHE_LEN = 3, 10, 12, 10, 24


@functools.lru_cache(maxsize=None)
def _tree():
    return bridge.init_params_numpy(registry.load_config(ARCH).reduced(), seed=11,
                                    norm_scale=0.1)


def engines(quantize=False, cache_len: int = CACHE_LEN):
    """(reference engine, port engine on the CPU) on one numpy draw."""
    cfg, jcfg = registry.load_config(ARCH).reduced(), jreg.load_config(ARCH).reduced()
    jeng = JEngine(jreg.build(jcfg), numpy_to_jax(_tree()), cache_len=cache_len,
                   quantize=quantize)
    teng = InferenceEngine(registry.build(cfg), bridge.params_from_numpy(_tree(), "cpu"),
                           cache_len=cache_len, quantize=quantize, device="cpu")
    return jeng, teng


def _inputs(cfg, b=B, s=PROMPT, s_enc=S_ENC, seed=0) -> dict:
    """Numpy decoder tokens, then N(0, 1) frames (b, s_enc, d)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, size=(b, s)),
            "frames": rng.normal(size=(b, s_enc, cfg.d_model)).astype(np.float32)}


def _both(batch: dict):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _held(jeng, teng, batch, got, want):
    """Tokens equal, or parted where the first int8 rounding that differs
    along the reference's tokens is a .5 tie."""
    wt = np.asarray(want.tokens)
    if np.array_equal(got.tokens.numpy(), wt):
        return
    first = first_difference(jeng, teng, batch["tokens"], wt,
                             extra={"frames": batch["frames"]})
    assert traced(first["kind"], first["values"]), first


@pytest.mark.parametrize("quantize", [False, True, "int4", "int3", "fp8", "mixed", "mixed3"])
def test_generate_greedy_matches_reference(quantize):
    jeng, teng = engines(quantize)
    batch = _inputs(teng.cfg)
    jb, tb = _both(batch)
    want = jeng.generate(jb, NEW)
    got = teng.generate(tb, NEW)
    if quantize is False:
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                                   atol=1e-4, rtol=0)
    else:
        _held(jeng, teng, batch, got, want)


@pytest.mark.parametrize("flag", ["blockwise_attention", "prefill_dequant"])
@pytest.mark.parametrize("quantize", [False, True])
def test_generate_under_flags_matches_reference(flag, quantize):
    """The encoder's non-causal and the decoder prompt's causal attention
    through the flash kernel's plain version, or every product a float one:
    the reference's tokens (the tie rule with int8 weights but under
    prefill_dequant, which quantizes no activation)."""
    jeng, teng = engines(quantize)
    batch = _inputs(teng.cfg, seed=1)
    jb, tb = _both(batch)
    with both_flags(**{flag: True}):
        want = jeng.generate(jb, NEW)
        got = teng.generate(tb, NEW)
        if quantize is False or flag == "prefill_dequant":
            np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        else:
            _held(jeng, teng, batch, got, want)


def test_static_cross_cache_holds_the_frames_rows():
    """The signature's static cache is allocated with memory_len = s_enc.
    A cross cache of the reference's default 4096 rows, the prefill's rows
    written and the rest zero, decodes to another result than the
    reference's (which attends to exactly s_enc rows), and equals the
    reference's own decode over that padded cache: the sizing, nothing
    else, makes the difference."""
    jeng, teng = engines()
    batch = _inputs(teng.cfg)
    jb, tb = _both(batch)
    teng.generate(tb, 2)
    cache = teng.graphs.last["generate.prefill"].inputs["cache"]
    assert cache["cross_k"].shape[2] == cache["cross_v"].shape[2] == S_ENC
    assert cache["k"].shape[2] == CACHE_LEN
    cfg, jm, tm = teng.cfg, jeng.model, teng.model
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B,))
    _, jc = jm.prefill(jeng.params, jb, CACHE_LEN)
    want = np.asarray(jm.decode(jeng.params, jnp.asarray(tok, jnp.int32), jc,
                                jnp.int32(PROMPT))[0])
    with torch.inference_mode():
        _, tc = tm.prefill(teng.params, tb, CACHE_LEN)
        big = tm.init_cache(B, CACHE_LEN, torch.float32, "cpu")
        assert big["cross_k"].shape[2] == encdec.DEFAULT_MEMORY_LEN
        for name in big:
            big[name][:, :, :tc[name].shape[2]] = tc[name]
        trap = tm.decode(teng.params, torch.as_tensor(tok), big, PROMPT)[0].numpy()
        right = tm.decode(teng.params, torch.as_tensor(tok), tc, PROMPT)[0].numpy()
    np.testing.assert_allclose(right, want, atol=1e-4, rtol=0)
    assert np.abs(trap - want).max() > 100 * 1e-4
    jbig = {k: jnp.asarray(v.numpy()) for k, v in big.items()}
    np.testing.assert_allclose(trap, np.asarray(jm.decode(
        jeng.params, jnp.asarray(tok, jnp.int32), jbig, jnp.int32(PROMPT))[0]), atol=1e-4,
        rtol=0)


def test_programs_run_eagerly_and_build_once():
    """On the CPU the programs run eagerly: generate equals a prefill +
    decode_step loop; a repeat builds nothing; new frames of the same shape
    reuse the signature, another frame length builds a new one."""
    _, teng = engines(True)
    _, tb = _both(_inputs(teng.cfg, b=2))
    got = teng.generate(tb, 6).tokens
    with torch.inference_mode():
        logits, cache = teng.prefill(tb)
        toks = [logits.argmax(-1)]
        for i in range(5):
            logits, cache = teng.decode_step(toks[-1], cache, PROMPT + i)
            toks.append(logits.argmax(-1))
    np.testing.assert_array_equal(got.numpy(), torch.stack(toks, 1).numpy())
    builds = len(teng.graphs.programs)
    _, tb2 = _both(_inputs(teng.cfg, b=2, seed=3))
    teng.generate(tb2, 6)
    assert len(teng.graphs.programs) == builds
    _, tb3 = _both(_inputs(teng.cfg, b=2, s_enc=S_ENC + 3))
    teng.generate(tb3, 6)
    assert len(teng.graphs.programs) == builds + 2
    assert teng.graphs.last["generate.prefill"].inputs["cache"]["cross_k"].shape[2] == S_ENC + 3


def _raised(fn):
    try:
        fn()
    except Exception as e:        # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


def test_refusals_match_reference():
    """A paged cache, spec_k, ragged lengths=, kv_quant, continuous
    batching, a serving mode the family lacks, serve spec_k and the model
    drafter raise what the reference raises, with its words."""
    jeng, teng = engines()
    batch = _inputs(teng.cfg, b=2, s=8)
    jb, tb = _both(batch)
    lens = np.array([8, 6])
    jreqs = [jbatching.Request(0, [1, 2, 3]), jbatching.Request(1, [4, 5])]
    treqs = [batching.Request(0, [1, 2, 3]), batching.Request(1, [4, 5])]
    calls = {
        "paged": (lambda: jeng.generate(jb, 2, paged=True),
                  lambda: teng.generate(tb, 2, paged=True)),
        "spec_k": (lambda: jeng.generate(jb, 2, spec_k=4),
                   lambda: teng.generate(tb, 2, spec_k=4)),
        "lengths": (lambda: jeng.generate(jb, 2, lengths=lens),
                    lambda: teng.generate(tb, 2, lengths=lens)),
        "kv_quant": (lambda: JEngine(jeng.model, jeng.params, cache_len=8, kv_quant="int8"),
                     lambda: InferenceEngine(teng.model, teng.params, cache_len=8,
                                             kv_quant="int8", device="cpu")),
        "continuous": (lambda: jbatching.SlotScheduler(jeng),
                       lambda: batching.SlotScheduler(teng)),
        "mode paged": (lambda: jbatching.serve_ragged(jeng, jreqs, 2, mode="paged"),
                       lambda: batching.serve_ragged(teng, treqs, 2, mode="paged")),
        "mode continuous": (lambda: jbatching.serve_ragged(jeng, jreqs, 2, mode="continuous"),
                            lambda: batching.serve_ragged(teng, treqs, 2, mode="continuous")),
        "serve spec_k": (lambda: jbatching.serve_ragged(jeng, jreqs, 2, spec_k=4),
                         lambda: batching.serve_ragged(teng, treqs, 2, spec_k=4)),
        "model drafter": (lambda: jspec.resolve_drafter(f"model:{ARCH}", reduced=True),
                          lambda: spec.resolve_drafter(f"model:{ARCH}", reduced=True,
                                                       device="cpu")),
        "overflow": (lambda: jeng.generate(jb, 20), lambda: teng.generate(tb, 20)),
    }
    for name, (jcall, tcall) in calls.items():
        want, got = _raised(jcall), _raised(tcall)
        assert want is not None and want == got, (name, want, got)
    assert "continuous" in _raised(lambda: batching.SlotScheduler(teng))[1]
    assert "length-aware prefill" in _raised(
        lambda: spec.resolve_drafter(f"model:{ARCH}", reduced=True, device="cpu"))[1]
    assert batching.valid_modes(teng.model) == jbatching.valid_modes(jeng.model) == ["bucketed"]
    assert batching.resolve_mode(teng, "auto") == jbatching.resolve_mode(jeng, "auto") == \
        "bucketed"


def test_serve_ragged_refused_where_the_reference_fails():
    """serve_ragged resolves to bucketed, which hands generate the requests'
    tokens only: the reference's encoder fails on the missing frames
    (KeyError); the port refuses with a ValueError that says so."""
    jeng, teng = engines()
    jreqs = [jbatching.Request(0, [1, 2, 3]), jbatching.Request(1, [4, 5])]
    treqs = [batching.Request(0, [1, 2, 3]), batching.Request(1, [4, 5])]
    with pytest.raises(KeyError, match="frames"):
        jbatching.serve_ragged(jeng, jreqs, 2)
    with pytest.raises(ValueError, match=r"bucketed path .* KeyError: 'frames'"):
        batching.serve_ragged(teng, treqs, 2)
    assert batching.serve_ragged(teng, [], 2) == jbatching.serve_ragged(jeng, [], 2) == []


def test_serve_cli_on_cpu(capsys):
    """generate with frames drawn after the prompt (batch, prompt_len,
    d_model); --ragged exits with the bucketed refusal."""
    res = serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "6",
                      "--steps", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch: {ARCH}" in out and "tok/s" in out
    assert tuple(res.tokens.shape) == (2, 4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "6",
                    "--steps", "4", "--device", "cpu", "--ragged"])
    assert "KeyError: 'frames'" in capsys.readouterr().err
