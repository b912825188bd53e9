"""The recurrent families (rwkv6-7b at 2 layers, zamba2-7b at 3: one group
of two Mamba2 layers with the shared block, and a tail layer) on the
port's serving paths against the reference, reduced configs, weights from
one ``bridge.init_params_numpy`` draw with random norm weights:

- ``generate``, greedy with f32 and int8 weights (tokens equal, or with
  int8 parted only where the first int8 rounding that differs along the
  reference's tokens is a .5 tie), the final logits within 1e-4 with f32
  weights; top-p with the reference's own Gumbel draws fed to the port's
  noise buffers: equal tokens; rwkv6 past ``cache_len`` (no overflow:
  ``unbounded_state``);
- ``serve_ragged`` continuous (the ``RecurrentAdapter``) and bucketed, with
  mixed prompt lengths and budgets: tokens and lengths equal, and the
  continuous mode's rounds and decode steps equal the reference's;
- the captured programs run eagerly on the CPU: ``generate`` equals an
  eager prefill + ``decode_step`` loop, one program built per signature,
  none on a repeat serve;
- the refusals (a paged cache, ``spec_k``, ``kv_quant``, ragged
  ``lengths=``, zamba2's cache overflow) with the reference's exception
  types and messages;
- the serve CLI for both archs (``--ragged`` resolves to continuous; a
  paged mode, ``--spec-k`` and ``--kv-quant`` exit with the reference's
  errors), and the adapter choice and serving modes against the
  reference's and ``tests/arch_matrix.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import arch_matrix  # noqa: E402
from _torch_families import first_difference, traced  # noqa: E402
from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import core as jcore  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serving import batching, core, engine as tengine_mod, sampling  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CASES = {"rwkv6-7b": 2, "zamba2-7b": 3}
CACHE_LEN = 48
PROMPT, NEW = 12, 10
# three exact lengths (each an admission group's prefill program, and a
# bucketed generate), budgets 3-8
LENS, BUDGETS = [5, 9, 5, 12, 9, 12], [6, 4, 8, 3, 5, 7]


@functools.lru_cache(maxsize=None)
def _tree(arch: str):
    cfg = dataclasses.replace(registry.load_config(arch).reduced(), num_layers=CASES[arch])
    return bridge.init_params_numpy(cfg, seed=11, norm_scale=0.1)


def engines(arch: str, quantize=False, cache_len: int = CACHE_LEN):
    """(reference engine, port engine on the CPU) on one numpy draw."""
    layers = CASES[arch]
    cfg = dataclasses.replace(registry.load_config(arch).reduced(), num_layers=layers)
    jcfg = dataclasses.replace(jreg.load_config(arch).reduced(), num_layers=layers)
    jeng = JEngine(jreg.build(jcfg), numpy_to_jax(_tree(arch)), cache_len=cache_len,
                   quantize=quantize)
    teng = InferenceEngine(registry.build(cfg), bridge.params_from_numpy(_tree(arch), "cpu"),
                           cache_len=cache_len, quantize=quantize, device="cpu")
    return jeng, teng


def _prompt(cfg, b=3, s=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, size=(b, s))


def _requests(mod, cfg):
    rng = np.random.default_rng(2)
    return [mod.Request(i, rng.integers(1, cfg.vocab_size, size=(n,)).tolist(), max_new=m)
            for i, (n, m) in enumerate(zip(LENS, BUDGETS))]


@pytest.mark.parametrize("arch,quantize", [(a, q) for a in CASES for q in (False, True)])
def test_generate_greedy_matches_reference(arch, quantize):
    jeng, teng = engines(arch, quantize)
    prompt = _prompt(teng.cfg)
    want = jeng.generate({"tokens": jnp.asarray(prompt)}, NEW)
    got = teng.generate({"tokens": torch.as_tensor(prompt)}, NEW)
    wt = np.asarray(want.tokens)
    if not quantize:
        np.testing.assert_array_equal(got.tokens.numpy(), wt)
        np.testing.assert_allclose(got.logits_last.numpy(), np.asarray(want.logits_last),
                                   atol=1e-4, rtol=0)
    elif not np.array_equal(got.tokens.numpy(), wt):
        first = first_difference(jeng, teng, prompt, wt)
        assert traced(first["kind"], first["values"]), first


@pytest.mark.parametrize("arch", list(CASES))
def test_generate_top_p_on_the_references_draws(arch, monkeypatch):
    """top-p (p 0.8, temperature 0.9): the reference's generate with key 5
    draws Gumbel noise from its first split for the prefill's sample and
    one key a decode step from the second; the same draws loaded into the
    port's noise buffers give the same tokens."""
    jeng, teng = engines(arch)
    prompt, kw = _prompt(teng.cfg), {"p": 0.8, "temperature": 0.9}
    key = jax.random.PRNGKey(5)
    want = jeng.generate({"tokens": jnp.asarray(prompt)}, NEW, sampler="top_p",
                         sampler_kw=kw, key=key)
    k0, ksteps = jax.random.split(key)
    shape = (prompt.shape[0], teng.cfg.vocab_padded)
    draws = [np.array(jax.random.gumbel(k, shape, jnp.float32))
             for k in [k0, *jax.random.split(ksteps, NEW)]]

    def feed(inputs, gen):
        inputs[sampling.GUMBEL].copy_(torch.as_tensor(draws.pop(0)))

    monkeypatch.setattr(tengine_mod, "draw_noise", feed)
    got = teng.generate({"tokens": torch.as_tensor(prompt)}, NEW, sampler="top_p",
                        sampler_kw=kw)
    assert not draws
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def _counting(monkeypatch):
    """Count the reference scheduler's decode rounds and steps."""
    seen = {"rounds": 0, "steps": 0}
    orig = jcore.ContiguousAdapter.decode_round

    def counted(self, params, tok, cache, pos, live, remaining, keys):
        seen["rounds"] += 1
        seen["steps"] += keys.shape[0]
        return orig(self, params, tok, cache, pos, live, remaining, keys)

    monkeypatch.setattr(jcore.ContiguousAdapter, "decode_round", counted)
    return seen


@pytest.mark.parametrize("arch,mode", [(a, m) for a in CASES for m in ("continuous",
                                                                       "bucketed")])
def test_serve_ragged_matches_reference(arch, mode, monkeypatch):
    """Six requests of 5-12 tokens (three exact lengths), budgets 3-8, 3
    slots, chunk 4, int8 weights: tokens and lengths equal the reference's;
    continuous mode's rounds and decode steps too."""
    jeng, teng = engines(arch, True)
    seen = _counting(monkeypatch)
    kw = dict(mode=mode, slots=3, chunk=4)
    want = jbatching.serve_ragged(jeng, _requests(jbatching, teng.cfg), 8, **kw)
    got = batching.serve_ragged(teng, _requests(batching, teng.cfg), 8, **kw)
    assert [r.id for r in got] == [r.id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.length == w.length
    if mode == "continuous":
        sched = batching.slot_scheduler(teng, slots=3, chunk=4)
        assert isinstance(sched.adapter, core.RecurrentAdapter)
        assert (sched.last_rounds, sched.last_decode_steps) == (seen["rounds"], seen["steps"])
        assert seen["rounds"] > 0


@pytest.mark.parametrize("arch", list(CASES))
def test_programs_run_eagerly_and_build_once(arch):
    """On the CPU the captured programs run eagerly: generate equals a
    prefill + decode_step loop; a repeat generate or serve builds no new
    program, and the serve's prefills are one per (group size, exact
    length)."""
    _, teng = engines(arch)
    prompt = torch.as_tensor(_prompt(teng.cfg, b=2))
    got = teng.generate({"tokens": prompt}, 6).tokens
    with torch.inference_mode():
        logits, cache = teng.prefill({"tokens": prompt})
        toks = [logits.argmax(-1)]
        for i in range(5):
            logits, cache = teng.decode_step(toks[-1], cache, PROMPT + i)
            toks.append(logits.argmax(-1))
    np.testing.assert_array_equal(got.numpy(), torch.stack(toks, 1).numpy())
    builds = len(teng.graphs.programs)
    teng.generate({"tokens": prompt}, 6)
    assert len(teng.graphs.programs) == builds
    reqs = _requests(batching, teng.cfg)
    batching.serve_ragged(teng, reqs, 8, slots=3, chunk=4)
    n = len(teng.graphs.programs)
    batching.serve_ragged(teng, reqs, 8, slots=3, chunk=4)
    assert len(teng.graphs.programs) == n
    names = [k[0] for k in teng.graphs.programs]
    assert "recurrent.prefill" in names and "contiguous.decode" in names


def _raised(fn):
    try:
        fn()
    except Exception as e:        # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("arch", list(CASES))
def test_refusals_match_reference(arch):
    """A paged cache, spec_k, kv_quant and ragged lengths= raise what the
    reference raises; zamba2 refuses a cache overflow, rwkv6 (O(1) state)
    serves past cache_len and equals the reference."""
    jeng, teng = engines(arch, cache_len=16)
    prompt = _prompt(teng.cfg, b=2, s=8)
    jb, tb = {"tokens": jnp.asarray(prompt)}, {"tokens": torch.as_tensor(prompt)}
    lens = np.array([8, 6])
    jreqs, treqs = _requests(jbatching, teng.cfg)[:2], _requests(batching, teng.cfg)[:2]
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
        "mode paged": (lambda: jbatching.serve_ragged(jeng, jreqs, 2, mode="paged"),
                       lambda: batching.serve_ragged(teng, treqs, 2, mode="paged")),
        "serve spec_k": (lambda: jbatching.serve_ragged(jeng, jreqs, 2, spec_k=4),
                         lambda: batching.serve_ragged(teng, treqs, 2, spec_k=4)),
        "overflow": (lambda: jeng.generate(jb, 12), lambda: teng.generate(tb, 12)),
    }
    for name, (jcall, tcall) in calls.items():
        want = _raised(jcall)
        got = _raised(tcall)
        if name == "overflow" and arch == "rwkv6-7b":
            assert want is None and got is None
            continue
        assert want is not None and want == got, (name, want, got)
    if arch == "rwkv6-7b":
        np.testing.assert_array_equal(teng.generate(tb, 12).tokens.numpy(),
                                      np.asarray(jeng.generate(jb, 12).tokens))


@pytest.mark.parametrize("arch", list(CASES))
def test_adapter_modes_and_capabilities_match_reference(arch):
    """The slot scheduler takes the RecurrentAdapter (exact-length groups,
    no verify, its own ``san_state``); the modes and the auto resolution
    equal the reference's; the flags agree with ``tests/arch_matrix.py``."""
    jeng, teng = engines(arch)
    assert arch in arch_matrix.SLOT_STATE_ARCHS
    assert teng.model.cache_kind == jeng.model.cache_kind == "state"
    assert batching.valid_modes(teng.model) == jbatching.valid_modes(jeng.model) == [
        "continuous", "bucketed"]
    assert batching.resolve_mode(teng, "auto") == jbatching.resolve_mode(jeng, "auto")
    sched = batching.SlotScheduler(teng)
    assert sched.adapter.kind == "recurrent" and not sched.adapter.spec_capable
    assert sched.adapter.group_len(13) == 13
    assert "san_state" in vars(core.RecurrentAdapter)
    assert sched.adapter.san_state() == {"pool": None, "table": None}
    with pytest.raises(ValueError, match="cache_kind='state'"):
        core.RecurrentAdapter(InferenceEngine(
            registry.build(registry.load_config("tinyllama-1.1b").reduced()),
            bridge.params_from_numpy(bridge.init_params_numpy(
                registry.load_config("tinyllama-1.1b").reduced(), seed=0), "cpu"),
            cache_len=8, device="cpu"))


@pytest.mark.parametrize("arch", list(CASES))
def test_serve_cli_runs_and_refuses_on_cpu(arch, capsys):
    """The CLI serves both archs (reduced, full depth) on the CPU: the
    ragged path resolves to continuous; a paged mode, --spec-k (the uniform
    batch's generate) and --kv-quant exit with the reference's errors."""
    base = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "6", "--steps", "3",
            "--device", "cpu"]
    out = serve.main(base + ["--ragged", "--slots", "2"])
    assert "ragged (continuous" in capsys.readouterr().out
    assert len(out) == 2 and all(r.tokens.shape == (3,) for r in out)
    for extra, msg in ((["--ragged", "--mode", "paged"], "does not support mode='paged'"),
                       (["--spec-k", "2"], "no speculative verify path"),
                       (["--kv-quant", "int8"], "kv_quant covers the GQA")):
        with pytest.raises(SystemExit):
            serve.main(base + extra)
        assert msg in capsys.readouterr().err, extra
