"""Ragged serving of the port against the reference: ``serve_ragged`` in
``paged``, ``continuous`` and ``bucketed`` modes must give greedy tokens and
``Response.length`` IDENTICAL to the JAX package's on reduced TinyLlama, for
f32 and int8 weights with a float, int8 or fp8 KV cache; the paged
scheduler's residency high-water mark (``last_peak_blocks``) must match too.
Both packages get the same numpy-made weights; the reference runs its XLA
paths on the CPU, the port its plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import numpy_to_jax  # noqa: E402
from repro.models.registry import build as jbuild  # noqa: E402
from repro.models.registry import load_config as jload  # noqa: E402
from repro.serving import batching as jbatching  # noqa: E402
from repro.serving import paged as jpaged  # noqa: E402
from repro.serving.engine import InferenceEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.registry import build, load_config  # noqa: E402
from repro_torch.serving import batching, paged  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

CACHE_LEN = 40
# mixed prompt lengths (2 .. 13) and budgets (1 .. 7): slots refill at
# different steps, buckets 8 and 16, budget-1 requests finish at admission
PROMPTS = [[5, 3], [7, 1, 4], list(range(1, 11)), list(range(2, 14)), [9] * 6,
           list(range(30, 39))]
BUDGETS = [2, 7, 3, 5, 1, 4]


@pytest.fixture(scope="module")
def tree():
    return bridge.init_params_numpy(load_config("tinyllama-1.1b").reduced(), seed=21)


def _engines(tree, quantize, kv_quant, eos_id=None):
    cfg = load_config("tinyllama-1.1b").reduced()
    jeng = JEngine(jbuild(jload("tinyllama-1.1b").reduced()), numpy_to_jax(tree),
                   cache_len=CACHE_LEN, quantize=quantize, eos_id=eos_id, kv_quant=kv_quant)
    teng = InferenceEngine(build(cfg), bridge.params_from_numpy(tree, "cpu"),
                           cache_len=CACHE_LEN, quantize=quantize, eos_id=eos_id,
                           kv_quant=kv_quant, device="cpu")
    return jeng, teng


def _requests(mod):
    return [mod.Request(i, list(p), max_new=b)
            for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]


def _assert_same(got, want):
    assert [r.id for r in got] == [r.id for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.length == w.length


@pytest.mark.parametrize("kv_quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("quantize", [False, True])
def test_serve_ragged_modes_identical_to_reference(tree, quantize, kv_quant):
    jeng, teng = _engines(tree, quantize, kv_quant)
    for mode in ("paged", "continuous", "bucketed"):
        kw = dict(mode=mode, slots=3, chunk=2, block_size=8)
        want = jbatching.serve_ragged(jeng, _requests(jbatching), 6, **kw)
        got = batching.serve_ragged(teng, _requests(batching), 6, **kw)
        _assert_same(got, want)


@pytest.mark.parametrize("kv_quant", [None, "fp8"])
def test_paged_small_pool_backpressure_and_peak_blocks(tree, kv_quant):
    """A pool far below slots x cache_len: admission waits for block
    reclaim; tokens, lengths and the allocator's high-water mark match."""
    jeng, teng = _engines(tree, True, kv_quant)
    kw = dict(slots=3, chunk=2, block_size=4, num_blocks=10)
    jsched = jpaged.PagedScheduler(jeng, **kw)
    tsched = paged.PagedScheduler(teng, **kw)
    _assert_same(tsched.serve(_requests(paged), 6), jsched.serve(_requests(jpaged), 6))
    assert tsched.last_peak_blocks == jsched.last_peak_blocks <= 9
    # the default pool: peak residency equals the reference's and stays
    # under the contiguous footprint
    jsched = jpaged.PagedScheduler(jeng, slots=3, chunk=2, block_size=8)
    tsched = paged.PagedScheduler(teng, slots=3, chunk=2, block_size=8)
    _assert_same(tsched.serve(_requests(paged), 6), jsched.serve(_requests(jpaged), 6))
    assert tsched.last_peak_blocks == jsched.last_peak_blocks
    assert tsched.last_peak_blocks < 3 * tsched.blocks_per_req


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_serve_ragged_with_eos_identical_to_reference(tree, kv_quant):
    """An EOS that a request emits mid-stream: the paged round stops at that
    step (one flag per step), the response is EOS-padded, lengths match."""
    jeng0, _ = _engines(tree, True, kv_quant)
    free = jbatching.serve_ragged(jeng0, _requests(jbatching), 6, mode="continuous",
                                  slots=3, chunk=2)
    eos = int(np.asarray(free[1].tokens)[2])        # request 1's third token
    jeng, teng = _engines(tree, True, kv_quant, eos_id=eos)
    for mode in ("paged", "continuous", "bucketed"):
        kw = dict(mode=mode, slots=3, chunk=2, block_size=8)
        want = jbatching.serve_ragged(jeng, _requests(jbatching), 6, **kw)
        got = batching.serve_ragged(teng, _requests(batching), 6, **kw)
        _assert_same(got, want)
        assert got[1].length <= 3 and (got[1].tokens[got[1].length:] == eos).all()


def test_scheduler_counts_rounds_and_paged_steps(tree):
    """The paged rounds stop at the first finishing slot; the host-computed
    step counts add up to the decode forward passes the counters report."""
    _, teng = _engines(tree, False, None)
    sched = paged.PagedScheduler(teng, slots=3, chunk=4, block_size=8)
    out = sched.serve(_requests(paged), 6)
    assert sched.last_rounds >= 1 and sched.last_decode_steps >= max(BUDGETS) - 1
    assert [r.length for r in out] == BUDGETS
    cont = batching.SlotScheduler(teng, slots=3, chunk=4)
    cont.serve(_requests(batching), 6)
    assert cont.last_decode_steps == 4 * cont.last_rounds


def test_resolve_mode_and_validation(tree):
    _, teng = _engines(tree, False, None)
    assert batching.valid_modes(teng.model) == ["paged", "continuous", "bucketed"]
    assert batching.resolve_mode(teng, "auto") == "paged"
    with pytest.raises(ValueError, match="unknown serving mode"):
        batching.resolve_mode(teng, "bogus")
    assert batching.serve_ragged(teng, [], 4) == []
    # speculative serving is ported: served paged, token-identical to vanilla
    # (tests/test_torch_spec.py); the bucketed mode keeps its refusal
    spec = batching.serve_ragged(teng, _requests(batching), 4, mode="paged", spec_k=2)
    vanilla = batching.serve_ragged(teng, _requests(batching), 4, mode="paged")
    assert [r.tokens.tolist() for r in spec] == [r.tokens.tolist() for r in vanilla]
    with pytest.raises(ValueError, match="speculative decoding needs"):
        batching.serve_ragged(teng, _requests(batching), 4, mode="bucketed", spec_k=2)
    long = [batching.Request(0, list(range(30)), max_new=20)]
    with pytest.raises(ValueError, match="needs 50 cache slots"):
        batching.serve_ragged(teng, long, 20, mode="continuous")
    with pytest.raises(ValueError, match="paged table covers"):
        batching.serve_ragged(teng, long, 20, mode="paged")
    with pytest.raises(ValueError, match="unknown kv_quant"):
        InferenceEngine(teng.model, teng.params, cache_len=8, kv_quant="int4", device="cpu")


def test_serve_cli_ragged_kv_quant_on_cpu(capsys):
    out = serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "3",
                      "--prompt-len", "10", "--steps", "4", "--device", "cpu",
                      "--ragged", "--kv-quant", "int8", "--slots", "2"])
    text = capsys.readouterr().out
    assert "ragged (paged" in text and "kv cache: int8" in text
    assert len(out) == 3 and all(r.tokens.shape == (4,) for r in out)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu", "--ragged",
                    "--mode", "bogus"])
    assert "valid modes" in capsys.readouterr().err
