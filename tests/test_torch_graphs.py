"""The port's captured programs (``serving/graphs.py``) on the CPU, where
they run eagerly on their static buffers: ``generate`` (uniform, ragged,
paged; float, int8 and fp8 KV caches; under the three serving flags) and
``serve_ragged`` (paged, continuous, bucketed) give greedy tokens IDENTICAL
to the reference's and to a plain ``prefill`` + ``decode_step`` loop on
reduced TinyLlama; ``CaptureCounter`` shows one build per signature, none
for a repeated call or serve, and a new one when the kernel implementation
or a flag changes; returned logits are copies. The paged round's repair
(the EOS exit on the device, one host transfer a round) keeps the rounds,
decode steps, peak blocks and tokens of the round that read one flag a
step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_helpers import both_flags, numpy_to_jax  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import CaptureCounter  # noqa: E402
from repro_torch.core import flags  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.models.transformer import contiguous_to_paged  # noqa: E402
from repro_torch.serving import batching, graphs, paged  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CACHE_LEN = 40
SERVING_FLAGS = dict(blockwise_attention=True, deferred_decode_cache=True,
                     kvt_cache_layout=True)
PROMPTS = [[5, 3], [7, 1, 4], list(range(1, 11)), list(range(2, 14)), [9] * 6,
           list(range(30, 39))]
BUDGETS = [2, 7, 3, 5, 1, 4]


@pytest.fixture(scope="module")
def tree():
    return bridge.init_params_numpy(load_config("tinyllama-1.1b").reduced(), seed=31)


def _engines(tree, quantize=True, kv_quant=None, eos_id=None):
    cfg = load_config("tinyllama-1.1b").reduced()
    jeng = JEngine(jbuild(jload("tinyllama-1.1b").reduced()), numpy_to_jax(tree),
                   cache_len=CACHE_LEN, quantize=quantize, eos_id=eos_id, kv_quant=kv_quant)
    teng = InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=CACHE_LEN, quantize=quantize, eos_id=eos_id,
                           kv_quant=kv_quant, device="cpu")
    return jeng, teng


def _engine(tree, **kw):
    cfg = load_config("tinyllama-1.1b").reduced()
    return InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=CACHE_LEN, quantize=kw.pop("quantize", True),
                           device="cpu", **kw)


def _prompt(b=3, s=12, seed=5):
    return np.random.default_rng(seed).integers(0, 500, size=(b, s))


def _step_loop(eng, toks, n, lengths=None, paged_blocks=None):
    """Greedy tokens from the eager one-step APIs: ``prefill``, then
    ``decode_step`` (or the model's paged step over the prefill's cache laid
    out as an identity-mapped pool) with host-made positions."""
    batch = {"tokens": torch.as_tensor(toks)}
    if lengths is not None:
        batch["lengths"] = torch.as_tensor(lengths)
    cache_len = eng.cache_len
    if paged_blocks:
        cache_len = -(-cache_len // paged_blocks) * paged_blocks
    with torch.inference_mode():
        logits, cache = eng.model.prefill(eng.params, eng._device_batch(batch), cache_len)
        tok = logits.argmax(-1)
        pos = (torch.as_tensor(lengths) if lengths is not None
               else torch.full((toks.shape[0],), toks.shape[1]))
        if paged_blocks:
            cache, table = contiguous_to_paged(cache, paged_blocks)
        out = [tok]
        for _ in range(n - 1):
            if paged_blocks:
                logits, cache = eng.model.decode_paged(eng.params, tok, cache, table, pos)
            elif lengths is None:
                logits, cache = eng.decode_step(tok, cache, int(pos[0]))
            else:
                logits, cache = eng.decode_step(tok, cache, pos)
            tok = logits.argmax(-1)
            out.append(tok)
            pos = pos + 1
    return torch.stack(out, 1)


GEN_CASES = [(path, kvq, fl) for path in ("uniform", "ragged", "paged")
             for kvq in (None, "int8", "fp8") for fl in (False, True)
             if not (path == "paged" and fl)]      # the paged pool takes the base layout


@pytest.mark.parametrize("path,kv_quant,serving_flags", GEN_CASES)
def test_generate_programs_match_reference_and_step_loop(tree, path, kv_quant, serving_flags):
    jeng, teng = _engines(tree, kv_quant=kv_quant)
    toks = _prompt()
    kw = {"lengths": np.array([12, 4, 9])} if path == "ragged" else {}
    if path == "paged":
        kw["paged"] = True
    with both_flags(**(SERVING_FLAGS if serving_flags else {})):
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10,
                                        **kw).tokens)
        with CaptureCounter() as cc:
            got = teng.generate({"tokens": torch.as_tensor(toks)}, 10, **kw)
        loop = _step_loop(teng, toks, 10, kw.get("lengths"), 8 if path == "paged" else None)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    np.testing.assert_array_equal(got.tokens.numpy(), loop.numpy())
    assert dict(cc.counts) == {"generate.prefill": 1, "generate.decode": 1}


def test_generate_with_eos_matches_reference(tree):
    jeng0, _ = _engines(tree)
    toks = _prompt(2, 8, seed=6)
    free = np.asarray(jeng0.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10).tokens)
    eos = int(free[0, 3])
    jeng, teng = _engines(tree, eos_id=eos)
    for kw in ({}, {"paged": True}, {"lengths": np.array([8, 5])}):
        want = np.asarray(jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, 10,
                                        **kw).tokens)
        got = teng.generate({"tokens": torch.as_tensor(toks)}, 10, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(), want)
        assert (got.tokens[0, 3:] == eos).all()


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("mode", ["paged", "continuous", "bucketed"])
def test_serve_programs_match_reference_and_build_once(tree, mode, kv_quant):
    """serve_ragged through the programs equals the reference; a second
    serve of the same trace builds nothing."""
    jeng, teng = _engines(tree, kv_quant=kv_quant)
    kw = dict(mode=mode, slots=3, chunk=2, block_size=8)
    want = jbatching.serve_ragged(jeng, [jbatching.Request(i, p, max_new=b) for i, (p, b)
                                         in enumerate(zip(PROMPTS, BUDGETS))], 6, **kw)
    reqs = [batching.Request(i, p, max_new=b) for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    with CaptureCounter() as first:
        got = batching.serve_ragged(teng, reqs, 6, **kw)
    with CaptureCounter() as second:
        again = batching.serve_ragged(teng, reqs, 6, **kw)
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        np.testing.assert_array_equal(a.tokens, g.tokens)
        assert g.length == w.length == a.length
    assert first.total() >= 2 and second.total() == 0
    decode = {"paged": "paged.decode", "continuous": "contiguous.decode",
              "bucketed": "generate.decode"}[mode]
    assert first.counts[decode] == (1 if mode != "bucketed" else 2)   # buckets 8 and 16


def test_one_build_per_signature_and_none_on_repeat(tree):
    teng = _engine(tree)
    toks = torch.as_tensor(_prompt(2, 8))
    with CaptureCounter() as cc:
        a = teng.generate({"tokens": toks}, 6)
        b = teng.generate({"tokens": toks}, 9)              # no scan-length key
        teng.generate({"tokens": toks}, 6, lengths=np.array([8, 5]))
        teng.generate({"tokens": toks[:, :6]}, 6)
    cc.assert_builds("generate.prefill", 3)
    cc.assert_builds("generate.decode", 3)
    assert len(set(cc.keys["generate.decode"])) == 3
    assert torch.equal(a.tokens, b.tokens[:, :6])


@pytest.mark.parametrize("change", ["impl", "flag"])
def test_new_build_when_impl_or_flag_changes(tree, change):
    teng = _engine(tree)
    toks = torch.as_tensor(_prompt(2, 8))
    base = teng.generate({"tokens": toks}, 5)
    scope = (ops.impl_scope("plain") if change == "impl"
             else flags.overrides(deferred_decode_cache=True))
    with CaptureCounter() as cc, scope:
        got = teng.generate({"tokens": toks}, 5)
        teng.generate({"tokens": toks}, 5)
    assert dict(cc.counts) == {"generate.prefill": 1, "generate.decode": 1}
    with CaptureCounter() as cc:
        teng.generate({"tokens": toks}, 5)                  # back to the first key
    assert cc.total() == 0
    if change == "impl":                                    # the CPU runs the plain versions
        assert torch.equal(got.tokens, base.tokens)


def test_returned_logits_are_not_overwritten(tree):
    teng = _engine(tree)
    a = teng.generate({"tokens": torch.as_tensor(_prompt(2, 8, seed=1))}, 4)
    kept = a.logits_last.clone()
    b = teng.generate({"tokens": torch.as_tensor(_prompt(2, 8, seed=2))}, 4)
    assert torch.equal(a.logits_last, kept) and not torch.equal(a.logits_last, b.logits_last)
    prog = teng.graphs.last["generate.decode"]
    assert a.logits_last.data_ptr() != prog.outputs.data_ptr()
    assert b.logits_last.data_ptr() != prog.outputs.data_ptr()


def test_static_buffers_are_reused_in_place(tree):
    """A repeated signature runs on the same static buffers: the cache the
    prefill writes is the tensor the decode step reads."""
    teng = _engine(tree, kv_quant="int8")
    toks = torch.as_tensor(_prompt(2, 8))
    teng.generate({"tokens": toks}, 3, paged=True)
    pre, dec = teng.graphs.last["generate.prefill"], teng.graphs.last["generate.decode"]
    ptrs = {k: v.data_ptr() for k, v in dec.inputs["cache"].items()}
    teng.generate({"tokens": toks}, 3, paged=True)
    assert teng.graphs.last["generate.decode"] is dec
    assert {k: v.data_ptr() for k, v in dec.inputs["cache"].items()} == ptrs
    assert pre.inputs["pool"] is dec.inputs["cache"]
    assert dec.inputs["tok"] is pre.inputs["tok"] and dec.inputs["pos"] is pre.inputs["pos"]


def test_cpu_programs_are_eager_and_the_eager_scope_changes_nothing(tree):
    teng = _engine(tree)
    toks = torch.as_tensor(_prompt(2, 8))
    with CaptureCounter() as cc:
        a = teng.generate({"tokens": toks}, 4)
        with graphs.eager():
            b = teng.generate({"tokens": toks}, 4)
    cc.assert_builds("generate.decode", 1)
    assert cc.keys["generate.decode"][0][-1] is True       # keyed as eager
    assert teng.graphs.last["generate.decode"].graph is None
    assert torch.equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# the paged round's repair: the same counters and tokens as the round that
# read one EOS flag a step
# ---------------------------------------------------------------------------

def _flag_per_step_round(self, params, tok, pos, live, steps):
    """The paged round before the repair: eager steps over the adapter's
    pool, one host read a step to stop at the step a live slot emits EOS."""
    st, dev = self._state(), self.engine.device
    table = torch.tensor(self.table, device=dev)
    tok, pos, live = (torch.as_tensor(x).to(dev) for x in (tok, pos, live))
    model, sample, eos = self.engine.model, self.core.sample, self.engine.eos_id
    toks = []
    for _ in range(steps):
        logits, _ = model.decode_paged(params, tok, st["cache"], table, pos)
        tok = torch.where(live, sample(logits), tok)
        pos = torch.where(live, pos + 1, pos)
        toks.append(tok)
        if eos is not None and bool((live & (tok == eos)).any()):
            break
    return torch.stack(toks), torch.tensor([len(toks)])


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("num_blocks", [None, 10])
def test_paged_round_repair_keeps_counters_and_tokens(tree, monkeypatch, kv_quant, num_blocks):
    _, teng0 = _engines(tree, kv_quant=kv_quant)
    reqs = [paged.Request(i, p, max_new=b) for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    free = paged.PagedScheduler(teng0, slots=3, chunk=4, block_size=4).serve(reqs, 6)
    eos = int(free[1].tokens[1])                     # request 1 emits it at its 2nd step
    teng = _engine(tree, kv_quant=kv_quant, eos_id=eos)
    kw = dict(slots=3, chunk=4, block_size=4, num_blocks=num_blocks)
    runs = {}
    for name in ("repaired", "per_step"):
        with monkeypatch.context() as mp:
            if name == "per_step":
                mp.setattr(paged.PagedAdapter, "decode_round", _flag_per_step_round)
            sched = paged.PagedScheduler(teng, **kw)
            out = sched.serve(reqs, 6)
        runs[name] = (out, sched.last_rounds, sched.last_decode_steps, sched.last_peak_blocks)
    (a, *ca), (b, *cb) = runs["repaired"], runs["per_step"]
    assert ca == cb
    for x, y in zip(a, b):
        assert x.length == y.length and (x.tokens == y.tokens).all()
    assert a[1].length <= 2 and (a[1].tokens[a[1].length:] == eos).all()
